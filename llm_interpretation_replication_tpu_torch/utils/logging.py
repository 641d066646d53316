"""Session logging (a copy of ``utils/logging.py``'s ``SessionLogger``):
stdout plus an optional file tee; and the sweep shells' ``[heartbeat]``
progress line, which :func:`obs.metrics.heartbeat` prints, records as
gauges and feeds to the stall watchdog."""

from __future__ import annotations

import datetime as _dt
import os
import sys
import threading
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
