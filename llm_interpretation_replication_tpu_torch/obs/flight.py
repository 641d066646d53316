"""Flight recorder + stall watchdog: the triage artifact a dying or
stuck run leaves behind.

A hung or preempted sweep used to leave nothing but its side-log; an
OOM-ladder walk left a stderr line and a telemetry fault event that died
with the process's memory.  This module keeps a bounded ring of recent
activity and, when something goes wrong, dumps it as ONE self-contained
``flightrec-*.json`` file next to the run's artifacts:

- :class:`FlightRecorder` — a bounded frame ring (heartbeats, notes)
  plus, at dump time, the tail of the telemetry fault-event log, the
  counter deltas since arming, every sample ring's percentiles (with the
  total-vs-retained truncation block), the span tracer's recent span
  summaries when tracing is on, and a host/device memory summary.
  Armed via :func:`enable`; it registers a telemetry fault listener, so
  EVERY existing ``record_fault`` chokepoint becomes a trigger — the
  engine's OOM ladder (``engine_oom_backoff``), the bench repeat policy
  (``sweep_oom_backoff``/``sweep_oom_skip``), the serve split/re-queue
  path (``serve_oom_split``), transient-retry exhaustion
  (``transient_exhausted``, :func:`..runtime.faults.retry_transient`),
  preemption (``preempted``, via :class:`..runtime.faults.
  PreemptionGuard`'s flush-then-record path — the sweep SIGTERM/SIGINT
  shells), and the watchdog below (``watchdog_stall``).  Dumps are
  rate-limited per trigger kind so a ladder walking three steps down
  produces one artifact, not three.
- :class:`StallWatchdog` — a heartbeat monitor for the sweep shells.
  :func:`..obs.metrics.heartbeat` beats it once per chunk; a daemon
  thread flags the sweep when no beat lands within ``k`` × the trailing
  median chunk time (with an absolute floor so fast test sweeps never
  false-positive).  A trip WARNS and dumps a flight record — it never
  kills the run: a slow-but-progressing sweep keeps its operating
  point, and the trip state resets on the next real beat.

Everything here is best-effort by design (comments mark the deliberate
keep-alive catches): a triage artifact writer that could
crash the run it is documenting would be worse than no artifact.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional

from ..utils import telemetry

#: fault-event kinds that trigger a dump when the recorder is armed.
TRIGGER_KINDS = frozenset({
    "engine_oom_backoff", "sweep_oom_backoff", "sweep_oom_skip",
    "serve_oom_split", "transient_exhausted", "preempted",
    "watchdog_stall",
    # fleet self-healing: every replica kill / wedge / poison reject and
    # every breaker trip leaves a post-mortem artifact when armed.
    "pool_replica_crash", "pool_replica_wedged",
    "pool_replica_quarantined", "pool_poison_request", "breaker_open",
})

#: frames retained in the activity ring.
DEFAULT_FRAME_CAP = 512

#: per-trigger-kind dump cooldown: one ladder walk == one artifact.
DEFAULT_COOLDOWN_S = 30.0


class FlightRecorder:
    """Bounded recent-activity ring + the flightrec-*.json dumper."""

    def __init__(self, frame_cap: int = DEFAULT_FRAME_CAP,
                 cooldown_s: float = DEFAULT_COOLDOWN_S):
        # RLock, deliberately: the trigger path can run inside a SIGNAL
        # HANDLER (PreemptionGuard -> record_fault -> listener) on the
        # same main thread that was interrupted mid-note(); a plain Lock
        # would self-deadlock the handler.
        self._lock = threading.RLock()
        self._frames: List[Dict] = []
        self._frame_cap = max(1, int(frame_cap))
        self._cooldown_s = float(cooldown_s)
        self._out_dir: Optional[str] = None
        self._snap0: Dict[str, float] = {}
        self._armed_t: Optional[float] = None
        self._last_dump: Dict[str, float] = {}   # kind -> monotonic time
        self._seq = 0
        self._workers: List[threading.Thread] = []
        self.dumps: List[str] = []               # paths written (newest last)

    # -- lifecycle -------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._out_dir is not None

    def enable(self, out_dir: str) -> "FlightRecorder":
        """Arm the recorder: dumps land in ``out_dir``.  Idempotent;
        re-arming with a new directory just redirects future dumps (the
        counter baseline is kept from the first arming so deltas span
        the whole run)."""
        with self._lock:
            first = self._out_dir is None
            self._out_dir = os.path.abspath(out_dir)
            if first:
                self._snap0 = telemetry.counters()
                self._armed_t = time.time()
        telemetry.add_fault_listener(self._on_fault)
        return self

    def disable(self) -> None:
        telemetry.remove_fault_listener(self._on_fault)
        with self._lock:
            self._out_dir = None
            self._frames = []
            self._last_dump = {}

    # -- activity ring ---------------------------------------------------

    def note(self, kind: str, **info) -> None:
        """Append one frame to the activity ring (no-op when disarmed)."""
        if not self.enabled:
            return
        frame = {"time": round(time.time(), 3), "kind": str(kind), **info}
        with self._lock:
            self._frames.append(frame)
            if len(self._frames) > self._frame_cap:
                del self._frames[: len(self._frames) - self._frame_cap]

    # -- triggers --------------------------------------------------------

    def _on_fault(self, event: Dict) -> None:
        kind = event.get("kind", "")
        if kind not in TRIGGER_KINDS:
            return
        # Reserve the dump slot SYNCHRONOUSLY (cheap, RLock-safe even
        # from a signal handler), then build+write the artifact on a
        # short-lived NON-daemon worker thread.  The fault path — which
        # may be a signal handler interrupting a frame that holds the
        # telemetry lock — must never call telemetry.counters() itself
        # (self-deadlock); the worker thread holds no locks, and being
        # non-daemon the interpreter waits for the write to land even
        # when the trigger is a preemption about to exit the process.
        ticket = self._reserve(kind)
        if ticket is None:
            return
        worker = threading.Thread(
            target=self._write_dump, args=(kind, dict(event)) + ticket,
            name="obs-flight-dump", daemon=False)
        with self._lock:
            self._workers = [t for t in self._workers if t.is_alive()]
            self._workers.append(worker)
        worker.start()

    def wait(self, timeout: float = 5.0) -> None:
        """Join any in-flight async dump workers (tests / orderly
        shutdown; the non-daemon threads also block interpreter exit on
        their own)."""
        with self._lock:
            workers = list(self._workers)
        for t in workers:
            t.join(timeout=timeout)

    def _reserve(self, reason: str):
        """Cooldown check + state snapshot under the recorder lock.
        Returns ``(seq, frames, snap0, armed_t, out_dir)`` or None when
        disarmed / inside the cooldown."""
        with self._lock:
            out_dir = self._out_dir
            if out_dir is None:
                return None
            now = time.monotonic()
            last = self._last_dump.get(reason)
            if last is not None and now - last < self._cooldown_s:
                return None
            self._last_dump[reason] = now
            self._seq += 1
            return (self._seq, list(self._frames), dict(self._snap0),
                    self._armed_t, out_dir)

    def dump(self, reason: str, trigger: Optional[Dict] = None
             ) -> Optional[str]:
        """Write one flightrec-*.json synchronously (rate-limited per
        ``reason``).  Returns the path, or None when disarmed / inside
        the cooldown / unwritable.  Direct callers only — the fault-
        listener trigger path goes through the async worker instead
        (see :meth:`_on_fault`)."""
        ticket = self._reserve(reason)
        if ticket is None:
            return None
        return self._write_dump(reason, trigger, *ticket)

    def _write_dump(self, reason: str, trigger: Optional[Dict],
                    seq: int, frames: List[Dict], snap0: Dict,
                    armed_t: Optional[float], out_dir: str
                    ) -> Optional[str]:
        doc = {
            "reason": reason,
            "time": round(time.time(), 3),
            "pid": os.getpid(),
            "armed_at": armed_t,
            "trigger": trigger,
            "frames": frames,
            "fault_events": telemetry.fault_events()[-100:],
            "counters": telemetry.counters(),
            "counters_since_armed": telemetry.counters_since(snap0),
            "rings": {
                name: {**meta,
                       **telemetry.sample_percentiles(name)}
                for name, meta in telemetry.sample_ring_report().items()
            },
            "memory": telemetry.get_memory_usage(),
        }
        try:
            from .tracer import get_tracer

            tracer = get_tracer()
            if tracer.enabled:
                doc["spans"] = [
                    {k: s.get(k) for k in ("name", "phase", "leg",
                                           "trace_id", "t0", "dur", "self")}
                    for s in tracer.spans()[-200:]
                ]
        # graftlint: disable=G05 triage decoration: span summaries are best-effort context on a crash artifact; a tracer hiccup must not lose the dump
        except Exception:
            pass
        path = os.path.join(out_dir,
                            f"flightrec-{reason}-{os.getpid()}-{seq}.json")
        try:
            os.makedirs(out_dir, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2, default=str)
        # graftlint: disable=G05 triage artifact writer: a full disk while dumping a crash record must never mask the fault being recorded
        except Exception as err:
            print(f"# obs: flight-record dump failed ({err})",
                  file=sys.stderr)
            return None
        with self._lock:
            self.dumps.append(path)
        print(f"# obs: flight record written to {path} (reason: {reason})",
              file=sys.stderr)
        return path


# ---------------------------------------------------------------------------
# Stall watchdog
# ---------------------------------------------------------------------------

class StallWatchdog:
    """Flag (never kill) a sweep making no forward progress.

    Fed by the heartbeat path: one :meth:`beat` per completed chunk.
    :meth:`check` trips when the time since the last beat exceeds
    ``max(floor_s, k * median(trailing chunk intervals))`` — the median
    needs ``min_beats`` intervals first, so startup and compile time
    never false-positive.  A trip records a ``watchdog_stall`` telemetry
    fault event (which dumps a flight record when the recorder is armed)
    and warns on stderr, once per stall: the trip state resets on the
    next beat.  ``clock`` is injectable for tests."""

    def __init__(self, label: str = "", k: float = 4.0, min_beats: int = 3,
                 floor_s: float = 5.0, poll_s: float = 1.0,
                 interval_window: int = 32, clock=time.monotonic):
        self.label = label
        self.k = float(k)
        self.min_beats = int(min_beats)
        self.floor_s = float(floor_s)
        self.poll_s = float(poll_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._intervals: List[float] = []
        self._interval_window = int(interval_window)
        self._last_beat: Optional[float] = None
        self._tripped = False
        self.trips = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, progress: Optional[int] = None) -> None:
        now = self._clock()
        with self._lock:
            if self._last_beat is not None:
                self._intervals.append(now - self._last_beat)
                if len(self._intervals) > self._interval_window:
                    del self._intervals[: len(self._intervals)
                                        - self._interval_window]
            self._last_beat = now
            self._tripped = False

    def threshold_s(self) -> Optional[float]:
        """The current trip threshold, or None while history is short."""
        with self._lock:
            if len(self._intervals) < self.min_beats:
                return None
            return max(self.floor_s,
                       self.k * statistics.median(self._intervals))

    def check(self, now: Optional[float] = None) -> bool:
        """True exactly once per stall (until the next beat resets it)."""
        threshold = self.threshold_s()
        with self._lock:
            if (threshold is None or self._last_beat is None
                    or self._tripped):
                return False
            idle = (now if now is not None else self._clock()) \
                - self._last_beat
            if idle <= threshold:
                return False
            self._tripped = True
            self.trips += 1
            median = statistics.median(self._intervals)
        telemetry.record_fault(
            "watchdog_stall", label=self.label, idle_s=round(idle, 1),
            threshold_s=round(threshold, 1),
            median_chunk_s=round(median, 2))
        print(f"# obs: watchdog — {self.label or 'sweep'} made no progress "
              f"for {idle:.0f}s (threshold {threshold:.0f}s = "
              f"{self.k:g}x median chunk {median:.1f}s); run left alive, "
              f"flight record dumped if armed", file=sys.stderr)
        return True

    # -- background polling + active-watchdog registration ---------------

    def start(self) -> "StallWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.poll_s):
                    self.check()

            self._thread = threading.Thread(
                target=loop, name="obs-watchdog", daemon=True)
            self._thread.start()
        _set_active_watchdog(self)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        _clear_active_watchdog(self)

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Module singletons: one recorder per process; the ACTIVE watchdog is
# whatever sweep shell currently runs (the heartbeat path feeds it).
# ---------------------------------------------------------------------------

_RECORDER = FlightRecorder()
_ACTIVE_WATCHDOG: Optional[StallWatchdog] = None
_ACTIVE_LOCK = threading.Lock()


def get_recorder() -> FlightRecorder:
    return _RECORDER


def enable(out_dir: str) -> FlightRecorder:
    return _RECORDER.enable(out_dir)


def disable() -> None:
    _RECORDER.disable()


def _set_active_watchdog(wd: StallWatchdog) -> None:
    global _ACTIVE_WATCHDOG
    with _ACTIVE_LOCK:
        _ACTIVE_WATCHDOG = wd


def _clear_active_watchdog(wd: StallWatchdog) -> None:
    global _ACTIVE_WATCHDOG
    with _ACTIVE_LOCK:
        if _ACTIVE_WATCHDOG is wd:
            _ACTIVE_WATCHDOG = None


def notify_heartbeat(label: str, done: int, total: int,
                     rate: float) -> None:
    """The heartbeat fan-out (:func:`..obs.metrics.heartbeat` calls
    this): beat the active watchdog and note a frame in the recorder."""
    with _ACTIVE_LOCK:
        wd = _ACTIVE_WATCHDOG
    if wd is not None:
        wd.beat(done)
    _RECORDER.note("heartbeat", label=label, done=done, total=total,
                   rate=rate)
