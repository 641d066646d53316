"""Replay: push an OFFLINE sweep workload through the scheduler and prove
row-level parity with the direct ``score_prompts`` path (the JAX package's
``serve/replay.py``).

This is the serve subsystem's acceptance harness: the same prompts, same
targets, same engine — once through the offline entry point and once as
independent scheduler requests — must yield row-identical results (the
scheduler coalesces requests back onto the engine's own bucketed batch
shapes, and per-row scoring is independent of co-batched rows at a fixed
program shape).  The report also carries the throughput comparison the
coalescing win is measured by (``bench.py --serve-replay``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence

from ..utils.telemetry import (
    counters,
    counters_since,
    sample_percentiles,
    sample_ring_report,
    sample_total,
)
from .config import SchedulerConfig
from .request import ScoreRequest, ServeError
from .scheduler import Scheduler


def _values_equal(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (a == b) or (math.isnan(a) and math.isnan(b))
    return a == b


def rows_equal(a: Dict, b: Dict) -> bool:
    """Row-level parity: same keys, same values (NaN == NaN so error rows
    compare equal to themselves).  ``trace_id`` is measurement-only
    decoration the scheduler attaches when span tracing is armed (obs/) —
    it is ignored so a traced serve run keeps the same parity contract
    as an untraced one."""
    a = {k: v for k, v in a.items() if k != "trace_id"}
    b = {k: v for k, v in b.items() if k != "trace_id"}
    return (set(a) == set(b)
            and all(_values_equal(a[k], b[k]) for k in a))


def _per_request_targets(targets, n: int):
    if targets and not isinstance(targets[0], str):
        if len(targets) != n:
            raise ValueError(
                f"per-prompt targets: got {len(targets)} pairs for "
                f"{n} prompts")
        return [tuple(t) for t in targets]
    return [tuple(targets)] * n


def replay(engine, prompts: Sequence, targets=("Yes", "No"),
           with_confidence: bool = False,
           max_new_tokens: Optional[int] = None,
           config: Optional[SchedulerConfig] = None,
           offline_rows: Optional[List[Dict]] = None,
           offline_s: Optional[float] = None,
           require_parity: bool = True,
           result_timeout_s: float = 1200.0) -> Dict:
    """Score ``prompts`` offline AND through the scheduler; return the
    parity + throughput report.

    ``offline_rows``/``offline_s`` reuse an already-measured offline pass
    (bench mode) instead of re-scoring.  ``require_parity=True`` raises
    :class:`ServeError` on any mismatched row — the replay contract is
    row-IDENTICAL results, with mismatches named, never a silent skew.

    On a mesh of ranks every rank calls this alike (the offline pass is an
    engine call); a follower rank's report is ``{"rows", "follower":
    True, "engine_calls"}``."""
    prompts = list(prompts)
    per_targets = _per_request_targets(targets, len(prompts))
    if offline_rows is None:
        t0 = time.perf_counter()
        offline_rows = engine.score_prompts(
            prompts, targets=targets, with_confidence=with_confidence,
            max_new_tokens=max_new_tokens)
        offline_s = time.perf_counter() - t0
    cfg = config or SchedulerConfig()
    if cfg.queue_capacity < len(prompts):
        cfg = dataclasses.replace(cfg, queue_capacity=len(prompts))
    snap = counters()
    wait_total0 = sample_total("serve_queue_wait_ms")
    lat_total0 = sample_total("serve_latency_ms")
    sched = Scheduler(engine, cfg)
    if sched.follower:
        # a follower rank of a mesh runs the leader's engine calls until
        # the leader closes; the report is the leader's
        sched.start().close()
        return {"rows": len(prompts), "follower": True,
                "engine_calls": sched.engine_calls}
    # the serve clock starts BEFORE submission: per-request host
    # tokenization happens inside submit(), and the offline side pays the
    # same tokenization inside its timed score_prompts call — excluding
    # it here would systematically overstate the serve throughput
    t0 = time.perf_counter()
    try:
        futures = [
            sched.submit(ScoreRequest(prompt=p, targets=pair,
                                      with_confidence=with_confidence,
                                      max_new_tokens=max_new_tokens))
            for p, pair in zip(prompts, per_targets)
        ]
        sched.start()
        serve_rows = [f.result(timeout=result_timeout_s) for f in futures]
        serve_s = time.perf_counter() - t0
    finally:
        # a failed future must not leak the loop thread (or skip the
        # engine-pool sweep) for the life of the process
        sched.close()
    delta = counters_since(snap)

    mismatched = [i for i, (a, b) in enumerate(zip(offline_rows, serve_rows))
                  if not rows_equal(a, b)]
    report = {
        "rows": len(prompts),
        "mismatched_rows": len(mismatched),
        "mismatched_indices": mismatched[:20],
        "offline_s": round(offline_s, 3) if offline_s is not None else None,
        "serve_s": round(serve_s, 3),
        "offline_rows_per_s": (round(len(prompts) / offline_s, 2)
                               if offline_s else None),
        "serve_rows_per_s": (round(len(prompts) / serve_s, 2)
                             if serve_s else None),
        "serve_batches": int(delta.get("serve_batches", 0)),
        "serve_batch_rows": int(delta.get("serve_batch_rows", 0)),
        "serve_oom_splits": int(delta.get("serve_oom_splits", 0)),
        "blocked_transfers": int(delta.get("blocked_transfers", 0)),
        # percentiles scoped to THIS replay's samples (the rings are
        # process-global; an earlier replay's latencies must not leak in)
        "queue_wait_ms": sample_percentiles(
            "serve_queue_wait_ms",
            last=sample_total("serve_queue_wait_ms") - wait_total0),
        "latency_ms": sample_percentiles(
            "serve_latency_ms",
            last=sample_total("serve_latency_ms") - lat_total0),
        # truncation visibility: when a ring's total exceeds retained,
        # the bounded ring dropped history and the percentiles above are
        # tail statistics (utils/telemetry sample-ring semantics)
        "samples": sample_ring_report(
            ["serve_queue_wait_ms", "serve_latency_ms",
             "serve_queue_depth"]),
    }
    if mismatched and require_parity:
        i = mismatched[0]
        raise ServeError(
            f"serve replay parity failed: {len(mismatched)} of "
            f"{len(prompts)} rows differ from the offline path (first at "
            f"row {i}: offline={offline_rows[i]!r} vs "
            f"serve={serve_rows[i]!r})")
    report["serve_rows"] = serve_rows
    return report
