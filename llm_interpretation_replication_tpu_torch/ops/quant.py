"""Projection dispatch (port of ``ops/quant.linear``, bf16/fp32 branch).

Weights keep the reference's ``[in, out]`` layout, so a projection is
``x @ w``.  The int8 w8a8 branch (a ``{key}_qscale`` entry beside the
weight) is not ported yet.
"""

from __future__ import annotations

import torch

_QSCALE_SUFFIX = "_qscale"


def linear(p: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    if key + _QSCALE_SUFFIX in p:
        raise NotImplementedError(
            "int8 w8a8 projections are not ported yet (ROADMAP.md queue 1, "
            "'int8 weights and KV cache')")
    return x @ p[key]
