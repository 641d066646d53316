"""Sweep checkpoint primitive (a copy of ``utils/checkpoint.py``'s
``append_jsonl``): the sweep shells' side-log append."""

from __future__ import annotations

import json
import os
from typing import Any, Iterable


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
