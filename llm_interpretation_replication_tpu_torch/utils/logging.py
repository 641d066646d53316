"""Session logging (a copy of ``utils/logging.py``'s ``SessionLogger``):
stdout plus an optional file tee."""

from __future__ import annotations

import datetime as _dt
import os
import sys
import threading
from typing import Optional


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
