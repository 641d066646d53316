"""Thread-safe nested span tracer with phase attribution.

A *span* is one timed interval on one thread — a prefill launch, a d2h
fetch, a tokenize chunk, a serve request's queue wait — recorded on ONE
monotonic clock (``time.monotonic``, the clock the serve layer already
timestamps with) so durations are immune to wall-clock steps and
manually-timed cross-thread spans share the context-managed spans'
epoch.  Spans nest per thread; a span opened while another is
active becomes its child and inherits its ``leg`` and ``trace_id`` tags
unless it sets its own.

**Phase attribution (the reason this exists).**  Spans tagged with a
``phase`` feed the per-phase totals bench's ``phases`` block reports.
Totals are SELF time: when phase spans nest (a ``decode`` span inside a
``d2h_fetch`` consume span), the parent's contribution is its duration
minus the time covered by phase-tagged descendants, so the per-phase
totals partition the instrumented wall-clock instead of double-counting
it.  Structural spans (``phase=None``) are transparent: their
phase-covered time propagates through to the nearest phase-tagged
ancestor.

**Async dispatch caveat.**  CUDA launches are asynchronous: a span around
a ``launch`` closure measures *dispatch* time, and the device time of
everything in flight surfaces in the ``d2h_fetch`` span of whichever
consume waits on it.  That decomposition is still a true partition of
host wall-clock (and is what the default traced mode reports, at ~zero
overhead).  For per-phase *device* attribution, ``enable(sync=True)``
opts in to a synchronize of the current CUDA stream at the close of spans
that passed a ``sync_obj`` holding a CUDA tensor — this serializes the
pipeline overlap (measurement mode, never the default) and runs inside
the strict layer's sanctioned-fetch scope, so ``LLM_INTERP_STRICT=1``
stays ``blocked_transfers == 0``.  CPU tensors need no wait.

**Outputs.**  Closed spans accumulate in a bounded in-memory ring (the
``phases`` totals are O(1) regardless), stream to a JSONL span log when
``enable(jsonl_path=...)`` is given, and export as Chrome-trace JSON
(``export_chrome``) loadable by Perfetto / ``chrome://tracing``.

When the tracer is disabled every entry point is a cheap no-op, so the
permanent instrumentation in the engine/sweeps/serve layers costs
nothing in ordinary runs.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

#: spans kept in memory (newest wins); phase totals are unaffected by
#: eviction — they accumulate at span close, not at export time.
DEFAULT_SPAN_CAP = 200_000

#: The canonical phase table.  Every ``phase=`` tag on a span must come
#: from this set: the ``phases`` block partitions wall-clock across these
#: names, ``obs report`` and bench-diff aggregate by them, and the README
#: "Span / phase names" table documents them row for row.  The set is the
#: JAX package's, name for name.
KNOWN_PHASES = frozenset({
    "host_tokenize", "host_prep", "dispatch", "prefill", "extend_prefill",
    "decode", "pooled_decode", "d2h_fetch", "host_rows", "host_write",
    "serve_queue_wait", "serve_coalesce", "serve_engine", "serve_respond",
})


class _ThreadState(threading.local):
    def __init__(self):
        self.stack: List[Dict[str, Any]] = []


class SpanTracer:
    """One tracer instance == one trace session (module-level singleton
    via :func:`get_tracer` for the instrumented layers)."""

    def __init__(self, span_cap: int = DEFAULT_SPAN_CAP):
        self._lock = threading.Lock()
        self._local = _ThreadState()
        self._on = False
        self._sync = False
        self._memory = False
        self._span_cap = max(1, int(span_cap))
        self._spans: List[Dict[str, Any]] = []
        self._evicted = 0
        self._totals: Dict[Tuple[str, str], float] = {}  # (phase, leg) -> s
        self._counts: Dict[Tuple[str, str], int] = {}
        self._next_id = 0
        self._jsonl_path: Optional[str] = None
        self._jsonl_file = None
        self._t0 = time.monotonic()

    # -- lifecycle -------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._on

    def enable(self, jsonl_path: Optional[str] = None, sync: bool = False,
               memory: bool = False) -> None:
        """Arm the tracer (idempotent).  ``jsonl_path`` streams each
        closed span as one JSON line; ``sync`` opts in to a stream
        synchronize at the close of spans carrying a
        ``sync_obj`` (device-time attribution mode — serializes the
        pipeline overlap); ``memory`` attaches a
        ``torch.cuda.memory_allocated`` snapshot to each closed span."""
        with self._lock:
            self._on = True
            self._sync = bool(sync)
            self._memory = bool(memory)
            if jsonl_path and self._jsonl_file is None:
                parent = os.path.dirname(os.path.abspath(jsonl_path))
                os.makedirs(parent, exist_ok=True)
                self._jsonl_path = jsonl_path
                # "w", not "a": the log is ONE session's spans — two runs
                # defaulting to the same path must not aggregate into a
                # doubled-totals report in `obs report`
                self._jsonl_file = open(jsonl_path, "w", encoding="utf-8")
            if self._t0 is None:
                self._t0 = time.monotonic()

    def disable(self) -> None:
        """Stop recording and close the JSONL log.  Recorded spans and
        phase totals stay readable (export after disable is fine)."""
        with self._lock:
            self._on = False
            if self._jsonl_file is not None:
                self._jsonl_file.close()
                self._jsonl_file = None
                self._jsonl_path = None

    def reset(self) -> None:
        """Drop every recorded span and total (tests / fresh sessions)."""
        with self._lock:
            self._spans = []
            self._evicted = 0
            self._totals = {}
            self._counts = {}
            self._t0 = time.monotonic()

    # -- recording -------------------------------------------------------

    def _alloc_id(self) -> int:
        self._next_id += 1
        return self._next_id

    @contextlib.contextmanager
    def span(self, name: str, phase: Optional[str] = None,
             leg: Optional[str] = None, trace_id: Optional[str] = None,
             sync_obj: Any = None, **attrs) -> Iterator[Optional[Dict]]:
        """Open one nested span on the calling thread.

        ``phase`` routes the span's SELF time into the per-phase totals;
        ``leg``/``trace_id`` inherit from the enclosing span when None;
        ``sync_obj`` (a tensor, or tuples, lists and dicts of them) is
        waited for at close when the
        tracer was enabled with ``sync=True``; a body whose outputs only
        exist after it runs sets ``rec["_sync_obj"]`` on the yielded
        span instead.  Extra keyword args land in the span's ``args``
        (length bucket, batch size, rows, ...).  Yields the live span
        dict (mutate ``rec["args"]`` to attach results) — or None when
        tracing is off."""
        if not self._on:
            yield None
            return
        stack = self._local.stack
        parent = stack[-1] if stack else None
        if parent is not None:
            leg = leg if leg is not None else parent.get("leg")
            trace_id = (trace_id if trace_id is not None
                        else parent.get("trace_id"))
        rec = {
            "name": name, "phase": phase, "leg": leg, "trace_id": trace_id,
            "t0": time.monotonic(), "t1": None,
            "tid": threading.get_ident(),
            "id": None,
            "parent": parent["id"] if parent is not None else None,
            "args": dict(attrs),
            "_covered": 0.0,
        }
        with self._lock:
            rec["id"] = self._alloc_id()
        stack.append(rec)
        try:
            yield rec
        finally:
            target = rec.pop("_sync_obj", sync_obj)
            if self._sync and target is not None:
                self._block_until_ready(target)
            stack.pop()
            self._close(rec, parent)

    def add_span(self, name: str, start: float, end: float,
                 phase: Optional[str] = None, leg: Optional[str] = None,
                 trace_id: Optional[str] = None, **attrs) -> None:
        """Record a manually-timed span (``start``/``end`` MUST be
        ``time.monotonic`` seconds — the tracer's one clock, so the
        exported timeline aligns with context-managed spans) — the
        cross-thread case the context manager cannot cover, e.g. a serve
        request's queue wait measured between its submitting thread's
        enqueue and the scheduler thread's pop."""
        if not self._on:
            return
        rec = {
            "name": name, "phase": phase, "leg": leg, "trace_id": trace_id,
            "t0": float(start), "t1": float(end),
            "tid": threading.get_ident(),
            "id": None, "parent": None,
            "args": dict(attrs), "_covered": 0.0,
        }
        with self._lock:
            rec["id"] = self._alloc_id()
        self._close(rec, None, already_timed=True)

    def _close(self, rec: Dict, parent: Optional[Dict],
               already_timed: bool = False) -> None:
        if not already_timed:
            rec["t1"] = time.monotonic()
        dur = max(0.0, rec["t1"] - rec["t0"])
        covered = min(rec.pop("_covered"), dur)
        if self._memory:
            mem = _device_bytes_in_use()
            if mem is not None:
                rec["args"]["hbm_bytes_in_use"] = mem
        rec["dur"] = dur
        rec["self"] = dur - covered if rec["phase"] else 0.0
        if parent is not None:
            # a phase span shields its whole duration from the ancestors'
            # self time; a structural span passes through what its own
            # phase-tagged descendants covered
            parent["_covered"] += dur if rec["phase"] else covered
        with self._lock:
            if rec["phase"]:
                key = (rec["phase"], rec["leg"] or "")
                self._totals[key] = self._totals.get(key, 0.0) + rec["self"]
                self._counts[key] = self._counts.get(key, 0) + 1
            self._spans.append(rec)
            if len(self._spans) > self._span_cap:
                drop = len(self._spans) - self._span_cap
                del self._spans[:drop]
                self._evicted += drop
            f = self._jsonl_file
            if f is not None:
                f.write(json.dumps(_public_span(rec)) + "\n")
                # flush per span: the log's crash-recovery promise (a
                # killed run still leaves its spans on disk) is worth
                # more than a buffered write at span volumes (hundreds
                # per sweep, not per token)
                f.flush()

    @staticmethod
    def _block_until_ready(sync_obj: Any) -> None:
        """Opt-in device sync at span close: a synchronize of the current
        stream of ``sync_obj``'s CUDA device, inside the strict layer's
        sanctioned-fetch scope so an armed sync guard never counts it.  A
        no-op when ``sync_obj`` holds no CUDA tensor."""
        device = _cuda_device_of(sync_obj)
        if device is None:
            return
        import torch

        from ..runtime import strict

        with strict.sanctioned_fetch():
            torch.cuda.current_stream(device).synchronize()

    # -- reading ---------------------------------------------------------

    def spans(self) -> List[Dict[str, Any]]:
        """Copy of the retained closed spans (public fields only)."""
        with self._lock:
            return [_public_span(r) for r in self._spans]

    def span_count(self) -> Tuple[int, int]:
        """(retained, evicted) closed-span counts."""
        with self._lock:
            return len(self._spans), self._evicted

    def phase_totals(self, by_leg: bool = False) -> Dict:
        """Accumulated per-phase SELF seconds.  ``by_leg=False`` returns
        ``{phase: seconds}``; ``by_leg=True`` returns
        ``{phase: {leg_or_"": seconds}}``."""
        with self._lock:
            items = list(self._totals.items())
        if not by_leg:
            out: Dict[str, float] = {}
            for (phase, _leg), s in items:
                out[phase] = out.get(phase, 0.0) + s
            return out
        nested: Dict[str, Dict[str, float]] = {}
        for (phase, leg), s in items:
            nested.setdefault(phase, {})[leg] = (
                nested.get(phase, {}).get(leg, 0.0) + s)
        return nested

    def phase_snapshot(self) -> Dict[Tuple[str, str], float]:
        """Opaque snapshot for :meth:`phase_totals_since` — the totals
        are session-cumulative, so a bench scopes its ``phases`` block to
        the measured repeats by snapshotting after warmup/calibration
        (the ``counters_since`` pattern)."""
        with self._lock:
            return dict(self._totals)

    def phase_totals_since(self, snapshot: Dict[Tuple[str, str], float],
                           by_leg: bool = False) -> Dict:
        """Per-phase totals accumulated since ``snapshot``."""
        with self._lock:
            delta = {k: v - snapshot.get(k, 0.0)
                     for k, v in self._totals.items()
                     if v - snapshot.get(k, 0.0) > 0.0}
        if not by_leg:
            out: Dict[str, float] = {}
            for (phase, _leg), s in delta.items():
                out[phase] = out.get(phase, 0.0) + s
            return out
        nested: Dict[str, Dict[str, float]] = {}
        for (phase, leg), s in delta.items():
            nested.setdefault(phase, {})[leg] = s
        return nested

    # -- export ----------------------------------------------------------

    def export_chrome(self, path: str) -> str:
        """Write the retained spans as Chrome-trace JSON (the
        ``traceEvents`` array of complete "X" events, microsecond
        timestamps) — loads in Perfetto and ``chrome://tracing``."""
        with self._lock:
            spans = list(self._spans)
            base = self._t0 or 0.0
        pid = os.getpid()
        events = []
        for r in spans:
            args = dict(r["args"])
            if r["leg"]:
                args["leg"] = r["leg"]
            if r["trace_id"]:
                args["trace_id"] = r["trace_id"]
            args["self_us"] = round(r["self"] * 1e6, 1)
            events.append({
                "name": r["name"],
                "cat": r["phase"] or "span",
                "ph": "X",
                "ts": round((r["t0"] - base) * 1e6, 3),
                "dur": round(r["dur"] * 1e6, 3),
                "pid": pid,
                "tid": r["tid"],
                "args": args,
            })
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        return path


def _public_span(rec: Dict) -> Dict:
    return {k: v for k, v in rec.items() if not k.startswith("_")}


def _cuda_device_of(obj: Any):
    """The device of the first CUDA tensor in ``obj`` (a tensor, or
    tuples, lists and dicts of them, NamedTuples included); None when it
    holds none."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.device if obj.is_cuda else None
    items = obj.values() if isinstance(obj, dict) else (
        obj if isinstance(obj, (tuple, list)) else ())
    for item in items:
        device = _cuda_device_of(item)
        if device is not None:
            return device
    return None


def _device_bytes_in_use() -> Optional[int]:
    """Bytes the CUDA caching allocator has handed out
    (``torch.cuda.memory_allocated``); None without an initialized CUDA
    context (CPU runs)."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return None
        return int(torch.cuda.memory_allocated())
    # graftlint: disable=G05 telemetry probe: memory stats are best-effort decoration on a measurement span; a backend without them must never fail the traced run
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Module-level singleton: the instrumented layers (engine, sweeps, serve,
# batching) call these; when disabled every call is a cheap no-op.
# ---------------------------------------------------------------------------

_TRACER = SpanTracer()


def get_tracer() -> SpanTracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def enable(jsonl_path: Optional[str] = None, sync: bool = False,
           memory: bool = False) -> SpanTracer:
    _TRACER.enable(jsonl_path=jsonl_path, sync=sync, memory=memory)
    return _TRACER


def disable() -> None:
    _TRACER.disable()


def span(name: str, **kw):
    return _TRACER.span(name, **kw)


def add_span(name: str, start: float, end: float, **kw) -> None:
    _TRACER.add_span(name, start, end, **kw)


def phase_totals(by_leg: bool = False) -> Dict:
    return _TRACER.phase_totals(by_leg=by_leg)


def phase_snapshot() -> Dict:
    return _TRACER.phase_snapshot()


def phase_totals_since(snapshot: Dict, by_leg: bool = False) -> Dict:
    return _TRACER.phase_totals_since(snapshot, by_leg=by_leg)


def export_chrome(path: str) -> str:
    return _TRACER.export_chrome(path)
