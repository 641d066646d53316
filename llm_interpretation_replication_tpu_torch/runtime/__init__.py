"""The port's runtime: the scoring engine (``engine``), batching, faults,
the snapshot loader, strict mode, the plan model and the training step
(``train``).  The package exports the plan model's and the training
step's names, as the reference's does; import the other modules by
name."""

from .plan import (
    GenerationPlan,
    ScoringPlan,
    generation_plan,
    kv_cache_bytes,
    plan_cache_key,
    resolve_full_sweep_plan,
    resolve_scoring_plan,
)
from .train import (
    TrainState,
    causal_lm_loss,
    init_train_state,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "GenerationPlan",
    "ScoringPlan",
    "generation_plan",
    "kv_cache_bytes",
    "plan_cache_key",
    "resolve_full_sweep_plan",
    "resolve_scoring_plan",
    "TrainState",
    "causal_lm_loss",
    "init_train_state",
    "make_optimizer",
    "make_train_step",
]
