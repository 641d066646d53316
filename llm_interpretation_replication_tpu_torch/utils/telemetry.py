"""Process-wide counters and the fault-event log (a copy of the part of
``utils/telemetry.py`` the port's engine and slot ring record into).

Counters are named monotones (``slot_rows``, ``slot_refills``, ...); each
``slot_*`` counter also has a labeled twin ``name|leg=...,workload=...``
(``runtime.slots.slot_counter``).  A caller measuring one phase snapshots
:func:`counters` before it and reads :func:`counters_since` after.  Fault
events record every recovery the engine made (an OOM back-off step), so a
run that degraded stays auditable.  Both are guarded by locks: a caller may
record from more than one thread.
"""

from __future__ import annotations

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
