"""Prefill attention: the hand-written Hopper kernel and its plain versions.

Port of ``llm_interpretation_replication_tpu/ops/attention.py`` for the
slice's path:

- :func:`causal_grouped_attention` -- the wrapper of the CUDA kernel in
  ``csrc/causal_grouped_attention.cu`` (which replaces the Pallas kernel
  ``_causal_grouped_kernel``).  On a CUDA tensor it launches the kernel or
  raises; on a CPU tensor it computes :func:`causal_grouped_attention_plain`.
- :func:`causal_grouped_attention_plain` -- the same function in plain
  PyTorch, in float32 whatever the input dtype.
- :func:`_dense_attention` -- the reference's dense head-major path.
- :func:`attention_bsnd` -- the layout-native dispatcher the decoder calls.

``NEG_INF`` stays finite: fully masked rows and length-0 rows rely on it
(their softmax is uniform, not NaN, and is then zeroed explicitly).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e9
KERNEL_SOURCE = "causal_grouped_attention"


def _dense_attention(q, k, v, lengths, causal: bool):
    """Dense attention on head-major ``[B, N, S, D]`` inputs (K/V already
    repeated to N heads); softmax in float32, products in the input dtype."""
    b, n, s, d = q.shape
    scores = torch.einsum("bnsd,bntd->bnst", q, k).float() / math.sqrt(d)
    cols = torch.arange(s, device=q.device)
    mask = (cols[None, :] < lengths[:, None])[:, None, None, :]
    if causal:
        mask = mask & (cols[:, None] >= cols[None, :])[None, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bnst,bntd->bnsd", probs, v)
    # a fully masked row softmaxes to a uniform average of V: zero it
    return torch.where(lengths[:, None, None, None] > 0, out, 0)


def causal_grouped_attention_plain(q, k, v, lengths, causal: bool = True):
    """Plain PyTorch version of the kernel: q ``[B, S, N, D]``, unrepeated
    k/v ``[B, S, G, D]``, lengths ``[B]`` -> ``[B, S, N, D]`` in q's dtype,
    computed in float32.  Row bound = min(length, pos + 1) (causal) or
    length; a row whose bound is 0 is zero."""
    b, s, n, d = q.shape
    g = k.shape[2]
    qg = q.float().reshape(b, s, g, n // g, d)
    scores = torch.einsum("bsghd,btgd->bghst", qg, k.float()) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    bound = lengths.to(torch.int64)[:, None].expand(b, s)
    if causal:
        bound = torch.minimum(bound, pos[None, :] + 1)              # [B, S]
    mask = pos[None, None, None, None, :] < bound[:, None, None, :, None]
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = torch.einsum("bghst,btgd->bsghd", probs, v.float()).reshape(b, s, n, d)
    out = torch.where(bound[:, :, None, None] > 0, out, 0.0)
    return out.to(q.dtype)


_lib: Optional[ctypes.CDLL] = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL_SOURCE)
        fn = lib.causal_grouped_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.causal_grouped_attention_bf16


def _check_kernel_inputs(q, k, v, lengths):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B,S,N,D] and k/v [B,S,G,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, n, d = q.shape
    g = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if g < 1 or n % g:
        raise ValueError(f"query heads {n} not a multiple of K/V heads {g}")
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"head dim {d}: the kernel takes D <= 128, D % 8 == 0")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 [{b}]; got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for t in (k, v, lengths):
        if t.device != q.device:
            raise ValueError(f"inputs on {t.device} and {q.device}")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")


def causal_grouped_attention(q, k, v, lengths, causal: bool = True):
    """Causal (or length-only) grouped attention on the projection layout:
    q ``[B, S, N, D]``, unrepeated k/v ``[B, S, G, D]``, lengths ``[B]``
    int32 -> ``[B, S, N, D]``.

    On a CUDA tensor this launches the Hopper kernel (bf16 in, bf16 out,
    float32 softmax) and counts the launch in ``causal_grouped_attention.
    launches``; there is no fallback.  On a CPU tensor it returns
    :func:`causal_grouped_attention_plain`."""
    if q.device.type == "cpu":
        return causal_grouped_attention_plain(q, k, v, lengths, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_kernel_inputs(q, k, v, lengths)
    b, s, n, d = q.shape
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), b, s, n, k.shape[2], d, int(bool(causal)),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"causal_grouped_attention kernel launch failed: "
                           f"cudaError {rc}")
    causal_grouped_attention.launches += 1
    return out


causal_grouped_attention.launches = 0


def attention_bsnd(q, k, v, lengths, causal: bool = True,
                   force: Optional[str] = None):
    """Layout-native dispatch: q ``[B, S, N, D]``, k/v ``[B, S, G, D]``.

    Default (and ``force="causal"``): :func:`causal_grouped_attention` --
    the kernel on a CUDA tensor, its plain version on a CPU tensor.
    ``force="dense"``: head-major :func:`_dense_attention` on either
    device."""
    if force == "dense":
        reps = q.shape[2] // k.shape[2]
        kh = k.transpose(1, 2).repeat_interleave(reps, dim=1)
        vh = v.transpose(1, 2).repeat_interleave(reps, dim=1)
        out = _dense_attention(q.transpose(1, 2), kh, vh, lengths, causal)
        return out.transpose(1, 2)
    if force not in (None, "causal"):
        raise ValueError(f"unknown attention backend {force!r}")
    return causal_grouped_attention(q, k, v, lengths, causal)
