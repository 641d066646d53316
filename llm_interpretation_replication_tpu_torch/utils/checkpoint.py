"""Sweep checkpoint primitives (a copy of ``utils/checkpoint.py``'s
``append_jsonl`` and ``CheckpointFile``): the perturbation sweep's side-log
append and the 100-question sweep's atomic JSON checkpoint."""

from __future__ import annotations

import json
import os
from typing import Any, Iterable, Optional

_TMP_SEQ = iter(range(1 << 62))


def _atomic_write_json(path: str, obj: Any) -> None:
    """Write ``obj`` to a temporary file, fsync it and rename it over
    ``path``.  Each call writes its own temporary name: a preemption
    handler saving the same checkpoint may interrupt a save in the same
    thread, and must not truncate the file the interrupted save holds."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{next(_TMP_SEQ)}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def append_jsonl(path: str, rows: Iterable[Any], fsync: bool = True) -> None:
    """Append one JSON object per row to a side-log, crash-consistently.

    The sweep shell's checkpoint flush is an O(new-rows) append to a
    ``.rows.jsonl`` side-log; with ``fsync`` (the default) the data is
    forced to disk before the call returns, so a SIGKILL or power loss right
    after a ``checkpoint_every`` flush cannot lose the rows the flush claimed
    to checkpoint.  Numpy scalars serialize via ``.item()``."""
    with open(path, "a") as f:
        for row in rows:
            f.write(json.dumps(
                row, default=lambda o: o.item()
                if hasattr(o, "item") else str(o)) + "\n")
        if fsync:
            f.flush()
            os.fsync(f.fileno())


class CheckpointFile:
    """Atomic JSON checkpoint with a default payload on first load."""

    def __init__(self, path: str, default: Optional[dict] = None):
        self.path = path
        self.default = default or {}

    def load(self) -> dict:
        if os.path.exists(self.path):
            with open(self.path) as f:
                return json.load(f)
        return json.loads(json.dumps(self.default))

    def save(self, state: dict) -> None:
        _atomic_write_json(self.path, state)
