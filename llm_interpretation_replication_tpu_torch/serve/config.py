"""Scheduler admission/backpressure knobs (a copy of the JAX package's
``serve/config.py``).

Free of torch (importable by the CLI argument layer and tests without
touching the device runtime).  The defaults target the latency
knee the batch-prompting literature keeps rediscovering (PAPERS.md,
Auto-Demo Prompting; the TPU-vs-GPU serving comparison): coalesce as
wide as one engine batch, but never hold the head request more than a
few tens of milliseconds waiting for co-batchable traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence


@dataclasses.dataclass
class SchedulerConfig:
    #: rows per micro-batch; 0 = the engine's ``EngineConfig.batch_size``
    #: (the shape the warm compiled programs already exist for).
    max_batch: int = 0
    #: how long the scheduler holds the HEAD request open for compatible
    #: co-batchable traffic before launching a partial micro-batch.
    max_wait_s: float = 0.02
    #: admission-queue bound; a submit past it raises the typed
    #: :class:`~.request.QueueFull` (backpressure, never silent deferral).
    queue_capacity: int = 2048
    #: default per-request deadline applied when a request carries none
    #: (None = requests without ``timeout_s`` never expire).
    default_timeout_s: Optional[float] = None
    #: OOM re-queue ladder for split micro-batches (the engine ladder,
    #: runtime/faults.next_batch_down); () = halving.  The FLOOR is where
    #: the scheduler stops splitting and fails the requests instead.
    oom_ladder: Sequence[int] = ()
    oom_floor: int = 1
    #: transient-retry policy for scheduler-driven engine calls (None =
    #: runtime/faults.default_transient_policy); OOM is excluded — the
    #: split/re-queue path owns it.
    retry_policy: Optional[object] = None
    #: close(drain=True) gives in-flight + queued work this long to
    #: finish before leftover requests fail with SchedulerClosed.
    drain_timeout_s: float = 120.0
    #: /healthz degrades when the OLDEST queued request has waited this
    #: long (serve/cli._metrics_endpoint): queue depth alone reads a
    #: wedged coalescer with a short queue as healthy — the head
    #: request's age cannot lie.  0 disables the check.
    health_max_queue_age_s: float = 30.0
    #: Slot-level continuous batching (runtime/slots.py): eligible
    #: micro-batches (plain binary scored requests on an engine without
    #: completion decoding) launch through
    #: ``ScoringEngine.score_prompts_slotted``, and newly-queued
    #: COMPATIBLE requests are admitted into vacated decode slots
    #: MID-DECODE (the ring's starvation hook polls the queue between
    #: chunks) instead of waiting for the next coalescer boundary.
    #: Default ON since the replay harness pinned slotted-vs-offline
    #: BIT parity (tests/test_slots.py; PARITY.md "Decode-then-repack")
    #: — occupancy is free once parity holds, and the disaggregated
    #: fleet's decode replicas NEED near-full rings to earn their role.
    #: ``--no-slot-admission`` (bench/serve CLI) is the escape hatch
    #: back to coalescer-boundary launches for A/B comparison.
    slot_admission: bool = True
    #: Prometheus labels stamped onto this scheduler's ``serve_*``
    #: counters / sample rings / latency histograms IN ADDITION to the
    #: unlabeled family (which stays the fleet-wide aggregate) — the
    #: EnginePool sets ``{"replica": id, "model": name}`` per replica so
    #: one wedged replica is visible as ITS series, not a fleet average.
    #: The labeled spelling is the telemetry-name convention
    #: ``name|k=v,k2=v2`` (obs/metrics.split_labeled_name); None = no
    #: labeled series.
    metric_labels: Optional[Dict[str, str]] = None
