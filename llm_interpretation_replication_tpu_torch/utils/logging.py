"""Session logging (copies of ``utils/logging.py``'s ``SessionLogger`` and
``Progress``): stdout plus an optional file tee; a persisted JSON progress
heartbeat; and the sweep shells' ``[heartbeat]`` progress line, which
:func:`obs.metrics.heartbeat` prints, records as gauges and feeds to the
stall watchdog."""

from __future__ import annotations

import datetime as _dt
import json
import os
import sys
import threading
import time
from typing import Callable, Optional


class SessionLogger:
    def __init__(self, log_file: Optional[str] = None, stream=None):
        self._stream = stream or sys.stdout
        self._file = None
        self._lock = threading.Lock()
        if log_file:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
            self._file = open(log_file, "a", encoding="utf-8")

    def log(self, *parts, timestamp: bool = False) -> None:
        """Print (and tee) one line; under a world of ranks only rank 0
        logs (``utils.checkpoint.writing_rank``)."""
        from .checkpoint import writing_rank

        if not writing_rank():
            return
        msg = " ".join(str(p) for p in parts)
        if timestamp:
            msg = f"[{_dt.datetime.now().isoformat(timespec='seconds')}] {msg}"
        with self._lock:
            print(msg, file=self._stream, flush=True)
            if self._file:
                self._file.write(msg + "\n")
                self._file.flush()

    __call__ = log

    def close(self) -> None:
        with self._lock:
            if self._file:
                self._file.close()
                self._file = None


class Progress:
    """Persistent progress heartbeat: counts, rate, ETA, arbitrary extras,
    rewritten atomically to ``path`` (when given) on every update."""

    def __init__(self, total: int, path: Optional[str] = None,
                 clock=time.monotonic):
        self.total = total
        self.done = 0
        self.path = path
        self._clock = clock
        self._start = clock()
        self._lock = threading.Lock()

    def update(self, n: int = 1, **extras) -> dict:
        with self._lock:
            self.done += n
            elapsed = max(self._clock() - self._start, 1e-9)
            rate = self.done / elapsed
            snapshot = {
                "done": self.done,
                "total": self.total,
                "elapsed_sec": round(elapsed, 3),
                "rate_per_sec": round(rate, 6),
                "eta_sec": (round((self.total - self.done) / rate, 3)
                            if rate else None),
                **extras,
            }
            if self.path:
                parent = os.path.dirname(os.path.abspath(self.path))
                os.makedirs(parent, exist_ok=True)
                tmp = self.path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(snapshot, f, indent=2)
                os.replace(tmp, self.path)
            return snapshot


def heartbeat(label: str, done: int, total: int, elapsed_s: float,
              log: Callable[[str], None], unit: str = "rows",
              rate: Optional[float] = None, rate_unit: Optional[str] = None,
              eta_s: Optional[float] = None) -> str:
    """Log a sweep's progress line, byte for byte the reference's
    ``[heartbeat]`` line, through the one code path that also sets the
    progress gauges, writes the JSONL metrics sample and beats the stall
    watchdog (:func:`obs.metrics.heartbeat`).  ``rate``, ``rate_unit`` and
    ``eta_s`` override the ``done / elapsed`` derivation where the
    progress unit and the rate unit differ (the instruct sweep counts
    models and reports rows/s)."""
    from ..obs import metrics

    return metrics.heartbeat(label, done, total, elapsed_s, log=log,
                             unit=unit, rate=rate, rate_unit=rate_unit,
                             eta_s=eta_s)
