"""Process-wide counters, streaming histograms and the fault-event log (a
copy of the part of ``utils/telemetry.py`` the port's engine and slot ring
record into).

Counters are named monotones (``slot_rows``, ``slot_refills``, ...); each
``slot_*`` counter also has a labeled twin ``name|leg=...,workload=...``
(``runtime.slots.slot_counter``).  A caller measuring one phase snapshots
:func:`counters` before it and reads :func:`counters_since` after.  Fault
events record every recovery the engine made (an OOM back-off step), so a
run that degraded stays auditable.  Histograms (``accepted_k``, the K-decode
path's accepted length a pass) keep exact counts on geometric buckets, with
:func:`hist_snapshot` / :func:`hist_since` as the phase scoping.  All are
guarded by locks: a caller may record from more than one thread.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

_FAULT_EVENTS: List[Dict] = []
_FAULT_EVENTS_CAP = 1000
_FAULTS_LOCK = threading.Lock()

_COUNTERS: Dict[str, float] = {}
_COUNTERS_LOCK = threading.Lock()


def record_fault(kind: str, **info) -> Dict:
    """Append one fault-recovery event ({kind, time, **info}); returns it.
    The log keeps the newest 1000 events."""
    event = {"kind": str(kind), "time": time.time(), **info}
    with _FAULTS_LOCK:
        _FAULT_EVENTS.append(event)
        if len(_FAULT_EVENTS) > _FAULT_EVENTS_CAP:
            del _FAULT_EVENTS[: len(_FAULT_EVENTS) - _FAULT_EVENTS_CAP]
    return event


def fault_events(kind: Optional[str] = None) -> List[Dict]:
    """Recorded fault events, newest last (optionally filtered by kind)."""
    with _FAULTS_LOCK:
        if kind is None:
            return list(_FAULT_EVENTS)
        return [e for e in _FAULT_EVENTS if e["kind"] == kind]


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
    """Per-counter delta against an earlier :func:`counters` snapshot.

    Counters absent from ``snapshot`` count from 0; unchanged ones are
    omitted.  A counter that now reads below its snapshot was cleared in
    between and reports its current value, never a negative delta."""
    now = counters()
    return {name: (value - snapshot.get(name, 0)
                   if value >= snapshot.get(name, 0) else value)
            for name, value in now.items()
            if value != snapshot.get(name, 0)}


# -- streaming histograms -------------------------------------------------------

#: smallest distinguishable value: everything at or below lands in bucket 0
HIST_MIN_VALUE = 1e-3
#: geometric bucket growth, 2**(1/8): a quantile read from bucket upper
#: bounds overstates the sample by under 9.05%
HIST_GROWTH = 2.0 ** 0.125
_LOG_GROWTH = math.log(HIST_GROWTH)

_HIST_COUNTS: Dict[str, Dict[int, int]] = {}
_HIST_META: Dict[str, List[float]] = {}   # [count, sum, min, max]


def hist_bucket_index(value: float) -> int:
    """Bucket of ``value``: 0 holds everything <= HIST_MIN_VALUE, bucket i
    holds (le(i-1), le(i)] with le(i) = HIST_MIN_VALUE * HIST_GROWTH**i."""
    if value <= HIST_MIN_VALUE:
        return 0
    # epsilon guards the exact-boundary case against float log jitter
    return max(0, int(math.ceil(
        math.log(value / HIST_MIN_VALUE) / _LOG_GROWTH - 1e-9)))


def record_hist(name: str, value: float) -> None:
    """Add one observation to the named histogram (exact counts, nothing
    evicted)."""
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


def hist_snapshot(names: Optional[List[str]] = None) -> Dict[str, Dict]:
    """``{name: {"counts", "count", "sum"}}`` for phase scoping; diff it
    with :func:`hist_since`."""
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
    """Per-histogram delta against a :func:`hist_snapshot`, covering only
    the observations recorded after it; a histogram cleared in between
    reports its current state, never a negative count."""
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
