"""Device out-of-memory classification and the batch back-off ladder (a
copy of ``runtime/faults.py``'s ``is_oom``/``oom_detail``/
``next_batch_down``).

The engine retries a batch whose launch or consume ran out of device memory
at the next size down the ladder (:func:`next_batch_down`), and records the
step (``utils.telemetry.record_fault``).  :func:`is_oom` also knows PyTorch's
spellings: ``torch.OutOfMemoryError`` and a ``RuntimeError`` whose text says
"CUDA out of memory".
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def is_oom(err: BaseException) -> bool:
    """Device out-of-memory: a ``torch.OutOfMemoryError``, an error whose
    text says "CUDA out of memory", or one of the status spellings
    'RESOURCE_EXHAUSTED' / 'ResourceExhausted' / 'Resource exhausted'."""
    if isinstance(err, torch.OutOfMemoryError):
        return True
    s = str(err).lower()
    if "cuda out of memory" in s:
        return True
    return "resourceexhausted" in s.replace("_", "").replace(" ", "")


def oom_detail(err: BaseException, limit: int = 160) -> str:
    """One-line truncated error text for OOM retry messages and the fault
    log, so a misclassified error leaves a trail."""
    text = " ".join(str(err).split())
    return text[:limit] + ("..." if len(text) > limit else "")


def next_batch_down(batch: int, ladder: Sequence[int] = (),
                    floor: int = 1) -> Optional[int]:
    """Next smaller batch size on the back-off ladder, or None at the floor.

    Walks ``ladder`` first (the largest entry strictly below ``batch``);
    below the ladder, or with none, the batch halves.  Never returns a value
    below ``floor`` (clamped to 1, so a zero floor steps to batch 1, never
    to an unlaunchable batch 0); None when ``batch`` is already at or below
    the floor, which tells the caller to re-raise."""
    floor = max(1, int(floor))
    if batch <= floor:
        return None
    for step in sorted(ladder, reverse=True):
        if step < batch:
            return max(floor, int(step))
    return max(floor, batch // 2)
