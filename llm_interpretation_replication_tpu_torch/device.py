"""Device and dtype resolution for the PyTorch port.

Entry points take an explicit ``device``; the default is ``"cuda"`` and a
missing card raises instead of quietly running on the CPU.  The CPU is used
only when a caller passes it (the tests do).

Host arrays go to the card through :func:`to_device`: staged in pinned
memory and copied with ``non_blocking=True``, so a launch path never waits
for the kernels queued before it (a blocking copy from pageable memory
synchronizes its stream).

Importing this module turns TF32 off for float32 matrix products and
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so a float32 computation on the card is
a float32 computation, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"

DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp32": torch.float32, "float32": torch.float32,
}


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' explicitly to run on the CPU")
    return dev


def to_device(arr, device, dtype=None) -> torch.Tensor:
    """``arr`` (array-like or CPU tensor) as a tensor on ``device``,
    converted to ``dtype`` when given.  To a CUDA device the host copy is
    staged in pinned memory and issued with ``non_blocking=True``: the copy
    is ordered on the current stream and the host goes on at once, where
    ``torch.as_tensor(..., device="cuda")`` from pageable memory waits for
    the stream to drain (a sync that strict mode's guard rejects).  The
    pinned block is not reused before the copy has run (the caching host
    allocator records an event on it)."""
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.asarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    dev = torch.device(device)
    if dev.type != "cuda" or t.device.type != "cpu":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def resolve_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; one of {sorted(DTYPES)}") from None
