"""serve/ — continuous-batching request scheduler over the port's scoring
engine (the JAX package's ``serve/``).

Independent scoring requests share ONE resident model by coalescing onto
the engine's bucketed batch shapes (:mod:`.coalescer`), launching as
micro-batches under a max-wait/max-batch admission policy
(:mod:`.scheduler`; eligible binary requests join vacated decode slots
mid-decode through ``score_prompts_slotted``), and fanning results back
out per request as futures (:mod:`.request`).  Replay (:mod:`.replay`)
proves row-level parity with the offline sweep path; :mod:`.load` is the
open-loop load harness; the stdlib JSONL driver (:mod:`.cli`) is the
``python -m llm_interpretation_replication_tpu_torch serve`` subcommand.
:mod:`.pool` scales the front door to a fleet of engine replicas (and
vendor backends) behind one router, with hot load/unload over the
engine's teardown, cost/latency-aware selection and prefill/decode roles
that hand KV slabs over; :mod:`.supervisor` quarantines, rebuilds and
fails over crashed or wedged replicas and trips circuit breakers on
flaky vendors.
"""

from .config import SchedulerConfig
from .pool import (
    EnginePool,
    LocalReplica,
    ParamShareGroup,
    PoolClient,
    PoolClosed,
    PoolConfig,
    RemoteBackend,
    RemoteReplica,
    UnknownModel,
)
from .queue import RequestQueue, Ticket
from .replay import replay, rows_equal
from .request import (
    DeadlineExceeded,
    PoisonousRequest,
    QueueFull,
    SchedulerClosed,
    ScoreFuture,
    ScoreRequest,
    ServeError,
)
from .scheduler import Scheduler, labeled_metric
from .supervisor import CircuitBreaker, ReplicaSupervisor, SupervisorConfig

__all__ = [
    "CircuitBreaker",
    "DeadlineExceeded",
    "EnginePool",
    "LocalReplica",
    "ParamShareGroup",
    "PoisonousRequest",
    "PoolClient",
    "PoolClosed",
    "PoolConfig",
    "QueueFull",
    "RemoteBackend",
    "RemoteReplica",
    "ReplicaSupervisor",
    "RequestQueue",
    "SchedulerClosed",
    "Scheduler",
    "SchedulerConfig",
    "ScoreFuture",
    "ScoreRequest",
    "ServeError",
    "SupervisorConfig",
    "Ticket",
    "UnknownModel",
    "labeled_metric",
    "replay",
    "rows_equal",
]
