"""W8A8 int8 quantization (port of ``ops/quant.py``) and projection dispatch.

- weights: symmetric per-output-channel int8 (scale = max|w| / 127 over the
  input dim), computed once at load;
- activations: symmetric per-token dynamic int8 over the feature axis,
  computed at every projection;
- the product: int8 x int8 -> exact int32 accumulators, then one rescale
  ``(y * s_x) * s_w`` in float32 and a cast to the activation dtype;
- K/V cache blocks: per-head symmetric int8 over head_dim.

Weights keep the reference's ``[in, out]`` layout, so a projection is
``x @ w``; an int8 weight sits beside ``{key}_qscale``.  The reference leaves
the int32 product to XLA outside any Pallas kernel; here it is one large
matrix product outside any kernel too: ``torch._int_mm`` on the card, an
int32 matmul on the CPU.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Keys eligible for quantization inside a stacked decoder layer tree.
_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_MLP_KEYS = ("wi", "wg", "wo")
QSCALE_SUFFIX = "_qscale"
_INT_MM_MIN_ROWS = 17            # torch._int_mm takes more than 16 rows


def _symmetric_int8(x32: torch.Tensor, axis: int):
    """(codes, keepdim scale) of the reference's symmetric int8 rule."""
    absmax = x32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor, *, contract_axis: int = -2):
    """Symmetric per-output-channel int8 of ``w`` ``[..., K, N]``: returns
    ``(w_int8, scale_f32)`` with ``scale`` shaped like ``w`` minus the
    contraction axis, ``w ~ w_int8 * scale``."""
    q, scale = _symmetric_int8(w.float(), contract_axis)
    return q, scale.squeeze(contract_axis)


def quantize_activations(x: torch.Tensor):
    """Symmetric per-token dynamic int8: scale over the last (feature) axis,
    kept as ``[..., 1]``."""
    return _symmetric_int8(x.float(), -1)


def quantize_kv(x: torch.Tensor):
    """Per-head symmetric int8 of a K or V block whose last axis is head_dim
    (``[..., G, D]``): returns ``(q_int8, scale_f32)`` with ``scale`` shaped
    like ``x`` minus head_dim, ``x ~ q * scale[..., None]``."""
    q, scale = _symmetric_int8(x.float(), -1)
    return q, scale.squeeze(-1)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    """Inverse of :func:`quantize_kv`: the multiply runs in float32 before
    the cast, so a bf16 target rounds the product, not the scale."""
    return (q.float() * scale[..., None]).to(dtype)


def int8_matmul_layout(w_q: torch.Tensor) -> torch.Tensor:
    """The int8 weight ``[..., K, N]`` stored N-major (each output
    channel's K codes contiguous): the same tensor as the reference's, laid
    out as ``torch._int_mm`` takes its second operand.  Done once, at load."""
    return w_q.transpose(-1, -2).contiguous().transpose(-1, -2)


def int8_accumulate(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 accumulators of int8 ``[..., K]`` x int8 ``[K, N]``.

    On the card: ``torch._int_mm`` (K and N multiples of 8; fewer than 17
    rows are zero-padded, since a look-ahead chunk may carry a single row).
    On the CPU: an int32 matmul.  |sum| <= 127^2 K stays far inside int32."""
    lead = x_q.shape[:-1]
    k, n = w_q.shape
    x2 = x_q.reshape(-1, k)
    if x_q.device.type == "cpu":
        y = x2.to(torch.int32) @ w_q.to(torch.int32)
    elif x_q.device.type == "cuda":
        if k % 8 or n % 8:
            raise ValueError(f"int8 product [{k}, {n}]: the card's int8 "
                             f"matmul needs K and N multiples of 8")
        m = x2.shape[0]
        if m < _INT_MM_MIN_ROWS:
            x2 = F.pad(x2, (0, 0, 0, _INT_MM_MIN_ROWS - m))
        y = torch._int_mm(x2.contiguous(), w_q)[:m]
    else:
        raise ValueError(f"no int8 product for device {x_q.device}")
    return y.reshape(*lead, n)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor):
    """``x @ dequant(w_q)`` on the int8 path.  x: ``[..., K]`` float; w_q:
    ``[K, N]`` int8; w_scale: ``[N]`` float32.  Returns ``[..., N]`` in
    ``x.dtype``."""
    x_q, x_scale = quantize_activations(x)
    y = int8_accumulate(x_q, w_q)
    return (y.float() * x_scale * w_scale).to(x.dtype)


def linear(p: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """Dispatch a projection: int8 path when ``{key}_qscale`` is present."""
    qs = p.get(key + QSCALE_SUFFIX)
    if qs is not None:
        return int8_matmul(x, p[key], qs)
    return x @ p[key]


def quantize_weight_np(w, *, contract_axis: int = -2):
    """Host-side (numpy) twin of :func:`quantize_weight`."""
    w = np.asarray(w, np.float32)
    absmax = np.abs(w).max(axis=contract_axis, keepdims=True)
    scale = np.maximum(absmax, 1e-8) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, np.squeeze(scale, axis=contract_axis).astype(np.float32)


def _quantize_layers(params: dict, quantize_fn) -> dict:
    """Replace each eligible projection weight with ``(int8,
    {name}_qscale)`` produced by ``quantize_fn``."""
    out = dict(params)
    layers = dict(out["layers"])
    for group, keys in (("attn", _ATTN_KEYS), ("mlp", _MLP_KEYS)):
        if group not in layers:
            continue
        g = dict(layers[group])
        for k in keys:
            w = g.get(k)
            if w is not None and getattr(w, "ndim", 0) >= 2:
                q, s = quantize_fn(w)
                g[k] = q
                g[k + QSCALE_SUFFIX] = s
        layers[group] = g
    out["layers"] = layers
    return out


def quantize_decoder_params_np(params: dict) -> dict:
    """Host-side twin of :func:`quantize_decoder_params` (numpy in/out)."""
    return _quantize_layers(params, quantize_weight_np)


def quantize_decoder_params(params: dict) -> dict:
    """Quantize a decoder param tree's projection weights: stacked
    ``[L, K, N]`` become int8 with ``[L, N]`` scales under
    ``{name}_qscale``.  Embedding, norms, biases and the (tied) unembedding
    keep their dtype."""
    return _quantize_layers(params, quantize_weight)
