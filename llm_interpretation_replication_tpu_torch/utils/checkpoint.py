"""Sweep checkpoint primitives (a copy of ``utils/checkpoint.py``'s
``append_jsonl``, ``CheckpointFile`` and ``ProcessedSet``): the
perturbation sweep's side-log append, the atomic JSON checkpoint of the
100-question sweep and of the Gemini batch resume file, and a persistent
set of idempotency keys (JSON-encoded tuples, no pickle).

Under a world of ranks (the scoring engine on a mesh: every rank runs the
sweep on the same rows) only rank 0 writes: :func:`writing_rank` gates the
side-log appends and the checkpoint saves here, and the sweeps' workbook
and CSV writes.  Only rank 0 reads the state a sweep resumes from, and
:func:`from_writing_rank` hands it to the others, so every rank resumes
from the same rows also where the output directory is node-local."""

from __future__ import annotations

import json
import os
from typing import Any, Iterable, Optional

_TMP_SEQ = iter(range(1 << 62))


def writing_rank() -> bool:
    """True where this process writes a sweep's files and prints its rows:
    without a process group, or on rank 0 of one."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def from_writing_rank(read):
    """``read()`` on rank 0 of a world, sent to every other rank
    (``torch.distributed.broadcast_object_list``); ``read()`` itself
    without a world.  Every rank of the world must call it."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return read()
    box = [read() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


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
    to checkpoint.  Numpy scalars serialize via ``.item()``.  A rank other
    than 0 of a world writes nothing."""
    if not writing_rank():
        return
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
        """The saved state (the default before the first save); rank 0's
        under a world of ranks (:func:`from_writing_rank`)."""
        return from_writing_rank(self._read)

    def _read(self) -> dict:
        if os.path.exists(self.path):
            with open(self.path) as f:
                return json.load(f)
        return json.loads(json.dumps(self.default))

    def save(self, state: dict) -> None:
        if writing_rank():
            _atomic_write_json(self.path, state)

    def clear(self) -> None:
        if writing_rank() and os.path.exists(self.path):
            os.remove(self.path)


class ProcessedSet:
    """Persistent set of idempotency keys (tuples of str/int)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._keys = set()
        if path and os.path.exists(path):
            with open(path) as f:
                self._keys = {tuple(k) for k in json.load(f)}

    @staticmethod
    def _norm(key) -> tuple:
        # a scalar key (a bare model name) is a 1-tuple; only real
        # sequences are composite keys
        if isinstance(key, (str, bytes, int, float)):
            return (key,)
        return tuple(key)

    def __contains__(self, key) -> bool:
        return self._norm(key) in self._keys

    def __len__(self) -> int:
        return len(self._keys)

    def add(self, key, flush: bool = True) -> None:
        self._keys.add(self._norm(key))
        if flush and self.path:
            self.flush()

    def update(self, keys, flush: bool = True) -> None:
        for k in keys:
            self._keys.add(self._norm(k))
        if flush and self.path:
            self.flush()

    def flush(self) -> None:
        if self.path:
            # sorted by JSON text: stable even when keys mix types at one
            # tuple position (plain sorted() would raise TypeError)
            keys = sorted((list(k) for k in self._keys),
                          key=lambda k: json.dumps(k, default=str))
            _atomic_write_json(self.path, keys)
