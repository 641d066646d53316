"""Host/device telemetry (a copy of the JAX package's
``utils/telemetry.py`` with its device-memory readers on ``torch.cuda``).

Process-wide fault-event log (with listeners: the flight recorder's
trigger path), named counters, bounded sample rings, exact-count
streaming histograms, and RAM / disk / device-memory summaries.  Each
``slot_*`` counter also has a labeled twin ``name|leg=...,workload=...``
(``runtime.slots.slot_counter``).  All are guarded by locks: a caller may
record from more than one thread.
"""

from __future__ import annotations

import gc
import math
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Fault-event log (runtime/faults.py)
#
# Every recovery the fault-tolerance layer performs — an engine batch
# stepped down after OOM, a transient error retried, a preemption flush —
# degrades or perturbs the operating point the run reports, so it must stay
# auditable: a sweep that silently completed at batch 160 instead of 320 is
# a different measurement.  Events accumulate here (bounded ring) and are
# readable/drainable by benchmarks, tests, and reports.
# ---------------------------------------------------------------------------

_FAULT_EVENTS: List[Dict] = []
_FAULT_EVENTS_CAP = 1000
_FAULT_LISTENERS: List = []   # called with each event as it is recorded —
                              # the obs/ flight recorder's trigger path
# Faults are recorded from the sweep loop, the prefetcher, watchdogs and
# callers at once: the append+trim pair and the listener list need one
# lock.  Listeners are invoked OUTSIDE it — a listener that blocks
# (flight-recorder dump) must never stall every other fault-recording
# thread, and holding a telemetry lock into listener code would order a
# telemetry lock before a flight-recorder lock.
_FAULTS_LOCK = threading.Lock()

#: The CLOSED registry of fault-event kinds.  Every ``record_fault``
#: literal in the codebase must name a member, and fault LISTENERS — the
#: flight recorder's TRIGGER_KINDS, dashboards keyed on kind strings — can
#: enumerate it instead of grepping: a typo'd kind would otherwise fork a
#: new event stream no listener ever matches.  Grouped by the layer that
#: records.
FAULT_KINDS = frozenset({
    # runtime/faults.py + runtime/engine.py (the fault layer)
    "engine_oom_backoff", "sweep_oom_skip", "sweep_oom_backoff",
    "transient_retry", "transient_exhausted", "preempted",
    # runtime/strict.py + scoring (measurement-integrity events)
    "blocked_transfer", "nan_logits", "packed_error_rows",
    # serve/ scheduler + obs/flight.py watchdog
    "serve_oom_split", "watchdog_stall",
    # serve/supervisor.py fleet self-healing
    "pool_replica_crash", "pool_replica_wedged",
    "pool_replica_quarantined", "pool_poison_request", "breaker_open",
})


def add_fault_listener(fn) -> None:
    """Register ``fn(event_dict)`` to run on every :func:`record_fault`
    (idempotent per callable).  Listeners must be fast and must not
    raise; a raising listener is swallowed so the fault path — which is
    already handling an error — can never be broken by its observer."""
    with _FAULTS_LOCK:
        # check-then-append must be one atomic step, or two threads
        # registering the same listener double-deliver every event
        if fn not in _FAULT_LISTENERS:
            _FAULT_LISTENERS.append(fn)


def remove_fault_listener(fn) -> None:
    with _FAULTS_LOCK:
        try:
            _FAULT_LISTENERS.remove(fn)
        except ValueError:
            pass


def record_fault(kind: str, **info) -> Dict:
    """Append one fault-recovery event ({kind, time, **info}); returns it."""
    event = {"kind": str(kind), "time": time.time(), **info}
    with _FAULTS_LOCK:
        _FAULT_EVENTS.append(event)
        if len(_FAULT_EVENTS) > _FAULT_EVENTS_CAP:
            del _FAULT_EVENTS[: len(_FAULT_EVENTS) - _FAULT_EVENTS_CAP]
        listeners = list(_FAULT_LISTENERS)
    for fn in listeners:    # outside the lock: see _FAULTS_LOCK comment
        try:
            fn(event)
        except Exception:  # a listener can never break the fault path
            pass
    return event


def fault_events(kind: Optional[str] = None) -> List[Dict]:
    """Recorded fault events, newest last (optionally filtered by kind)."""
    with _FAULTS_LOCK:
        if kind is None:
            return list(_FAULT_EVENTS)
        return [e for e in _FAULT_EVENTS if e["kind"] == kind]


def clear_fault_events() -> None:
    with _FAULTS_LOCK:
        _FAULT_EVENTS.clear()


# ---------------------------------------------------------------------------
# Performance counters (runtime/engine.py prefix-KV reuse, compile-cache
# warmup, host pipeline)
#
# Monotonic named counters for the hot-path reuse machinery: how many
# suffix legs rode an already-prefilled prefix cache (``prefix_hit``) vs
# paid a fresh prefix prefill (``prefix_miss``), and how long the
# device-feed loop sat idle waiting for background host tokenization
# (``host_overlap_idle_ms`` / ``host_overlap_chunks``).  Benchmarks and the
# smoke read these to prove the reuse paths actually engaged; a sweep that
# silently fell back to unfused scoring is a different measurement.
#
# Strict mode (runtime/strict.py, LLM_INTERP_STRICT=1) adds two more:
# ``recompile_events`` — one per ``nvcc`` build ``ops/_build.py`` runs while
# strict mode is armed (a warm repeat must hold this flat) — and
# ``blocked_transfers`` — one per host sync PyTorch's sync debug mode
# rejected inside a scoring pipeline's launch path (a clean operating point
# is provable as blocked_transfers == 0).
#
# The KV-cache quantization / chunked-prefill layer (runtime/engine
# ._prefill) adds: ``kv_cache_bytes_saved`` — HBM an int8-quantized KV
# cache does NOT pin vs its bf16 layout, accumulated per prefill from
# static shapes (a sweep that silently fell back to bf16 shows 0) — and
# ``prefill_chunks`` — chunked-prefill programs launched (chunk 0's
# ordinary prefill plus each suffix-extension replay).
#
# The serve/ scheduler (continuous-batching request coalescing) adds:
# ``serve_enqueued`` — requests admitted to the queue; ``serve_completed``
# — result rows delivered to futures; ``serve_rejected_full`` — typed
# QueueFull backpressure rejections; ``serve_rejected_deadline`` —
# deadline-expired requests rejected with a typed error (never silently
# dropped); ``serve_batches`` / ``serve_batch_rows`` — micro-batches
# launched and the rows they coalesced (rows/batches = achieved batching
# factor); ``serve_oom_splits`` — micro-batches split down the PR-1
# ladder and re-queued after a device OOM; ``serve_failed`` — requests
# failed with a non-recoverable error.  Queue-depth and latency
# DISTRIBUTIONS go through the bounded sample rings below
# (``serve_queue_depth``, ``serve_queue_wait_ms``, ``serve_latency_ms``)
# so percentiles are reportable without unbounded growth.
#
# Counters answer "how many / how much"; WHERE THE TIME GOES is the obs/
# span tracer's job (phase-tagged spans: host_tokenize, host_prep,
# dispatch, prefill, extend_prefill, decode, pooled_decode, d2h_fetch,
# host_rows, host_write — README "Span / phase names").
# ---------------------------------------------------------------------------

_COUNTERS: Dict[str, float] = {}
_COUNTERS_LOCK = threading.Lock()  # the host prefetcher records from its
                                   # worker thread


def record_counter(name: str, value: float = 1) -> None:
    """Add ``value`` to the named monotonic counter (creates it at 0)."""
    with _COUNTERS_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def counter(name: str) -> float:
    """Current value of one counter (0 when never recorded)."""
    with _COUNTERS_LOCK:
        return _COUNTERS.get(name, 0)


def counters() -> Dict[str, float]:
    """Snapshot of all counters."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS)


def clear_counters() -> None:
    with _COUNTERS_LOCK:
        _COUNTERS.clear()


def counters_since(snapshot: Dict[str, float]) -> Dict[str, float]:
    """Per-counter delta vs an earlier :func:`counters` snapshot.

    The counters are process-global monotones; callers measuring one
    phase (a bench repeat, a strict-mode sweep, a test) snapshot before,
    run, and diff — ``clear_counters`` would destroy concurrent readers'
    baselines.  Counters absent from ``snapshot`` count from 0; counters
    that only exist in ``snapshot`` are omitted (monotones cannot have
    shrunk).

    Robust to a :func:`clear_counters` between snapshot and read: a
    counter whose current value sits BELOW its snapshot was necessarily
    cleared and restarted, and reports its current value — never a
    negative number a report would subtract throughput with.  A clear
    the values cannot reveal (the counter re-accumulated PAST its
    snapshot) still reports the ordinary difference, so after a
    mid-window clear every delta is a LOWER bound on what was actually
    recorded; callers that clear mid-measurement get honest-but-
    conservative numbers, not corrupt ones."""
    now = counters()
    return {name: (value - snapshot.get(name, 0)
                   if value >= snapshot.get(name, 0) else value)
            for name, value in now.items()
            if value != snapshot.get(name, 0)}


# ---------------------------------------------------------------------------
# Bounded sample rings (serve/ queue-depth and latency percentiles)
#
# Counters are monotones; distributions (how long did a request WAIT, how
# deep was the queue WHEN it launched) need samples.  Each named ring keeps
# the most recent ``cap`` values (default _SAMPLES_CAP_DEFAULT,
# configurable per ring via :func:`set_sample_cap`) — enough for stable
# p50/p90/p99 over a serving window, bounded so a week-long server never
# grows host memory.
#
# TRUNCATION SEMANTICS (the silent-window footgun, fixed): a ring holds
# only its most recent ``cap`` samples, so a percentile over a run longer
# than the cap reflects ONLY THE TAIL — p99 of the last 4096 requests,
# not of the whole sweep.  Reports must therefore carry ``sample_total``
# (ever recorded) next to ``sample_count`` (retained); when total >
# retained the window was truncated and the percentile is a tail
# statistic.  :func:`sample_ring_report` packages exactly that, and the
# serve replay / strict reports embed it.  Callers that need whole-run
# percentiles raise the cap up front (``set_sample_cap``).
# ---------------------------------------------------------------------------

_SAMPLES: Dict[str, List[float]] = {}
_SAMPLE_TOTALS: Dict[str, int] = {}   # ever-recorded count per ring, so a
                                      # phase can be measured as "the last
                                      # (total_now - total_then) samples"
_SAMPLES_CAP_DEFAULT = 4096
_SAMPLE_CAPS: Dict[str, int] = {}     # per-ring overrides (set_sample_cap)
_SAMPLES_CAP = _SAMPLES_CAP_DEFAULT   # back-compat alias (default cap)


def set_sample_cap(cap: int, name: Optional[str] = None) -> None:
    """Configure ring capacity — for ``name`` only, or the default for
    every ring without an override (``name=None``).  Raising a cap takes
    effect on the next record; lowering one trims the ring immediately.
    A long benchmark that wants whole-run percentiles sets this before
    recording; the bound exists so a week-long server cannot grow host
    memory, not to hide history from reports."""
    global _SAMPLES_CAP
    cap = max(1, int(cap))
    with _COUNTERS_LOCK:
        if name is None:
            _SAMPLES_CAP = cap
        else:
            _SAMPLE_CAPS[name] = cap
            ring = _SAMPLES.get(name)
            if ring is not None and len(ring) > cap:
                del ring[: len(ring) - cap]


def sample_cap(name: str) -> int:
    """Effective capacity of the named ring."""
    with _COUNTERS_LOCK:
        return _SAMPLE_CAPS.get(name, _SAMPLES_CAP)


def record_sample(name: str, value: float) -> None:
    """Append one observation to the named bounded sample ring (capacity
    semantics: module docstring above / :func:`set_sample_cap`)."""
    with _COUNTERS_LOCK:
        ring = _SAMPLES.setdefault(name, [])
        ring.append(float(value))
        _SAMPLE_TOTALS[name] = _SAMPLE_TOTALS.get(name, 0) + 1
        cap = _SAMPLE_CAPS.get(name, _SAMPLES_CAP)
        if len(ring) > cap:
            del ring[: len(ring) - cap]


def sample_count(name: str) -> int:
    """Samples currently IN the ring (bounded by the cap)."""
    with _COUNTERS_LOCK:
        return len(_SAMPLES.get(name, ()))


def sample_total(name: str) -> int:
    """Monotonic count of samples EVER recorded to the ring — snapshot it
    before a phase and pass the delta as ``sample_percentiles``'s
    ``last`` to scope percentiles to that phase (clearing the ring would
    destroy concurrent readers' windows, like ``clear_counters`` would)."""
    with _COUNTERS_LOCK:
        return _SAMPLE_TOTALS.get(name, 0)


def sample_percentiles(name: str, pcts: tuple = (50.0, 90.0, 99.0),
                       last: Optional[int] = None) -> Dict[str, float]:
    """``{"p50": ..., "p90": ..., "p99": ...}`` (nearest-rank) over the
    named ring — the whole current window, or only the most recent
    ``last`` samples (one measured phase).  ``{}`` when nothing was
    recorded (or ``last == 0``)."""
    with _COUNTERS_LOCK:
        ring = _SAMPLES.get(name, ())
        if last is not None:
            ring = ring[len(ring) - min(len(ring), max(0, last)):]
        values = sorted(ring)
    if not values:
        return {}
    out = {}
    for p in pcts:
        rank = max(0, min(len(values) - 1,
                          int(round(p / 100.0 * (len(values) - 1)))))
        out[f"p{p:g}"] = values[rank]
    return out


def sample_ring_report(names: Optional[List[str]] = None) -> Dict[str, Dict]:
    """Truncation-visibility report: ``{ring: {total, retained, cap}}``.

    ``total`` is every sample EVER recorded; ``retained`` is what the
    bounded ring still holds (what percentiles are computed over).  When
    ``total > retained`` the window was truncated and any percentile is
    a TAIL statistic — reports embed this block so a p99 can never
    silently masquerade as a whole-run number.  ``names=None`` reports
    every ring that has recorded at least one sample."""
    with _COUNTERS_LOCK:
        keys = list(_SAMPLE_TOTALS) if names is None else list(names)
        return {
            name: {
                "total": _SAMPLE_TOTALS.get(name, 0),
                "retained": len(_SAMPLES.get(name, ())),
                "cap": _SAMPLE_CAPS.get(name, _SAMPLES_CAP),
            }
            for name in keys if _SAMPLE_TOTALS.get(name, 0)
        }


def clear_samples() -> None:
    with _COUNTERS_LOCK:
        _SAMPLES.clear()
        _SAMPLE_TOTALS.clear()


# ---------------------------------------------------------------------------
# Log-bucketed streaming histograms (serve/ load harness latency anatomy)
#
# The sample rings above keep the most recent ``cap`` VALUES, so over a
# long window their percentiles are tail statistics — acceptable for a
# dashboard, fatal for tail-latency measurement, where the one-in-a-
# thousand slow request is exactly what the bounded ring is most likely
# to have evicted.  A histogram inverts the trade: VALUES are quantized
# onto geometric bucket boundaries (each bucket ``HIST_GROWTH``× the
# previous, so any reported quantile overstates the true sample by at
# most ~9%), but COUNTS are exact and nothing is ever evicted — a p99.9
# over a million requests costs the same few hundred ints as over a
# hundred.  This is the structure behind Prometheus ``histogram`` series
# (obs/metrics.py exports these as ``_bucket``/``_sum``/``_count``).
#
# Scoping follows the counter discipline: histograms are process-global
# monotones; callers measuring one phase take :func:`hist_snapshot`
# before, run, and compute percentiles from :func:`hist_since`'s
# bucket-count deltas — never ``clear_hists`` mid-run.
# ---------------------------------------------------------------------------

#: smallest distinguishable value; everything at or below lands in
#: bucket 0 with upper bound HIST_MIN_VALUE (1 microsecond at ms scale).
HIST_MIN_VALUE = 1e-3
#: geometric bucket growth: 2**(1/8) ≈ 1.0905 — any quantile read from
#: bucket upper bounds overstates the true sample value by < 9.05%.
HIST_GROWTH = 2.0 ** 0.125
_LOG_GROWTH = math.log(HIST_GROWTH)

_HIST_COUNTS: Dict[str, Dict[int, int]] = {}
_HIST_META: Dict[str, List[float]] = {}   # [count, sum, min, max]


def hist_bucket_index(value: float) -> int:
    """Bucket index for ``value``: 0 holds everything <= HIST_MIN_VALUE,
    bucket i holds (le(i-1), le(i)] with le(i) = HIST_MIN_VALUE *
    HIST_GROWTH**i."""
    if value <= HIST_MIN_VALUE:
        return 0
    # epsilon guards the exact-boundary case against float log jitter
    return max(0, int(math.ceil(
        math.log(value / HIST_MIN_VALUE) / _LOG_GROWTH - 1e-9)))


def hist_bucket_le(index: int) -> float:
    """Upper (inclusive) bound of bucket ``index``."""
    return HIST_MIN_VALUE * HIST_GROWTH ** index


def record_hist(name: str, value: float) -> None:
    """Add one observation to the named streaming histogram.  Exact
    counts, no eviction — the no-truncation sibling of
    :func:`record_sample`."""
    value = float(value)
    idx = hist_bucket_index(value)
    with _COUNTERS_LOCK:
        counts = _HIST_COUNTS.setdefault(name, {})
        counts[idx] = counts.get(idx, 0) + 1
        meta = _HIST_META.get(name)
        if meta is None:
            _HIST_META[name] = [1, value, value, value]
        else:
            meta[0] += 1
            meta[1] += value
            meta[2] = min(meta[2], value)
            meta[3] = max(meta[3], value)


def hist_count(name: str) -> int:
    """Observations ever recorded to the named histogram (0 if none)."""
    with _COUNTERS_LOCK:
        meta = _HIST_META.get(name)
        return int(meta[0]) if meta else 0


def hist_counts(name: str) -> Dict[int, int]:
    """Copy of the named histogram's {bucket index: exact count}."""
    with _COUNTERS_LOCK:
        return dict(_HIST_COUNTS.get(name, ()))


def hist_snapshot(names: Optional[List[str]] = None) -> Dict[str, Dict]:
    """Snapshot for phase scoping: ``{name: {"counts", "count", "sum"}}``.
    Diff with :func:`hist_since` — the ``counters_since`` discipline."""
    with _COUNTERS_LOCK:
        keys = list(_HIST_COUNTS) if names is None else list(names)
        return {
            name: {
                "counts": dict(_HIST_COUNTS.get(name, ())),
                "count": int(_HIST_META[name][0]) if name in _HIST_META else 0,
                "sum": float(_HIST_META[name][1]) if name in _HIST_META else 0.0,
            }
            for name in keys
        }


def hist_since(snapshot: Dict[str, Dict]) -> Dict[str, Dict]:
    """Per-histogram bucket-count delta vs a :func:`hist_snapshot` —
    ``{name: {"counts", "count", "sum"}}`` covering only observations
    recorded after the snapshot.  Histograms absent from the snapshot
    count from zero; a bucket whose count sits below its snapshot (a
    mid-window :func:`clear_hists`) reports its current count, never a
    negative."""
    now = hist_snapshot()
    out: Dict[str, Dict] = {}
    for name, cur in now.items():
        prev = snapshot.get(name, {"counts": {}, "count": 0, "sum": 0.0})
        counts = {}
        for idx, n in cur["counts"].items():
            base = prev["counts"].get(idx, 0)
            delta = n - base if n >= base else n
            if delta:
                counts[idx] = delta
        count = (cur["count"] - prev["count"]
                 if cur["count"] >= prev["count"] else cur["count"])
        total = (cur["sum"] - prev["sum"]
                 if cur["count"] >= prev["count"] else cur["sum"])
        if count:
            out[name] = {"counts": counts, "count": count, "sum": total}
    return out


def hist_percentiles_from(counts: Dict[int, int],
                          pcts: Tuple = (50.0, 90.0, 99.0, 99.9)
                          ) -> Dict[str, float]:
    """Percentiles over a bucket-count dict (current state or a
    :func:`hist_since` delta): nearest-rank over the exact counts, each
    reported as its bucket's UPPER bound — so a reported quantile is
    >= the true sample value and overstates it by < HIST_GROWTH.
    ``{}`` when the counts are empty."""
    total = sum(counts.values())
    if not total:
        return {}
    ordered = sorted(counts.items())
    out: Dict[str, float] = {}
    for p in pcts:
        rank = min(total, max(1, int(math.ceil(p / 100.0 * total))))
        seen = 0
        for idx, n in ordered:
            seen += n
            if seen >= rank:
                out[f"p{p:g}"] = hist_bucket_le(idx)
                break
    return out


def hist_percentiles(name: str,
                     pcts: Tuple = (50.0, 90.0, 99.0, 99.9)
                     ) -> Dict[str, float]:
    """Percentiles over the named histogram's WHOLE (never-truncated)
    history."""
    return hist_percentiles_from(hist_counts(name), pcts)


def hist_report(names: Optional[List[str]] = None) -> Dict[str, Dict]:
    """Exposition-shaped report for every histogram with at least one
    observation: ``{name: {count, sum, min, max, buckets: [(le, n)]}}``
    with per-bucket (non-cumulative) exact counts sorted by bound."""
    with _COUNTERS_LOCK:
        keys = list(_HIST_COUNTS) if names is None else list(names)
        out = {}
        for name in keys:
            meta = _HIST_META.get(name)
            if not meta or not meta[0]:
                continue
            out[name] = {
                "count": int(meta[0]),
                "sum": float(meta[1]),
                "min": float(meta[2]),
                "max": float(meta[3]),
                "buckets": [(hist_bucket_le(i), n) for i, n in
                            sorted(_HIST_COUNTS.get(name, {}).items())],
            }
        return out


def clear_hists() -> None:
    with _COUNTERS_LOCK:
        _HIST_COUNTS.clear()
        _HIST_META.clear()


def get_memory_usage() -> str:
    """Human-readable host RAM / disk / device HBM summary string."""
    parts = []
    try:
        import psutil

        vm = psutil.virtual_memory()
        parts.append(f"RAM: {vm.used / 1e9:.1f}/{vm.total / 1e9:.1f} GB ({vm.percent}%)")
    except Exception:
        pass
    try:
        du = shutil.disk_usage("/")
        parts.append(f"Disk: {du.used / 1e9:.1f}/{du.total / 1e9:.1f} GB")
    except Exception:
        pass
    parts.append(device_memory_summary() or "HBM: n/a")
    return " | ".join(parts)


def device_memory_summary() -> Optional[str]:
    """``"HBM: cuda:0 <allocated>/<total> GB, ..."`` from
    ``torch.cuda.memory_allocated`` and ``torch.cuda.mem_get_info`` of each
    visible CUDA device; None without CUDA."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        stats = []
        for i in range(torch.cuda.device_count()):
            used = torch.cuda.memory_allocated(i)
            limit = torch.cuda.mem_get_info(i)[1]
            lim = f"/{limit / 1e9:.1f}" if limit else ""
            stats.append(f"cuda:{i} {used / 1e9:.2f}{lim} GB")
        return "HBM: " + ", ".join(stats) if stats else None
    except Exception:
        return None


def clear_host_memory() -> None:
    """Release python garbage; device tensors free with their references
    (``torch.cuda.empty_cache`` returns the cached blocks to the driver)."""
    for _ in range(3):
        gc.collect()
