"""The port's runtime: the scoring engine (``engine``), batching, faults,
the snapshot loader, strict mode and the plan model.  The package exports
the plan model's names, as the reference's does; import the other
modules by name."""

from .plan import (
    GenerationPlan,
    ScoringPlan,
    generation_plan,
    kv_cache_bytes,
    plan_cache_key,
    resolve_full_sweep_plan,
    resolve_scoring_plan,
)

__all__ = [
    "GenerationPlan",
    "ScoringPlan",
    "generation_plan",
    "kv_cache_bytes",
    "plan_cache_key",
    "resolve_full_sweep_plan",
    "resolve_scoring_plan",
]
