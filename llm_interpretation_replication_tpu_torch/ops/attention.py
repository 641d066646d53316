"""Prefill attention: the hand-written Hopper kernels and their plain versions.

Port of ``llm_interpretation_replication_tpu/ops/attention.py``.  Each Pallas
TPU kernel there has a CUDA kernel here (``csrc/``) behind a wrapper of the
same name; on a CUDA tensor the wrapper launches its kernel or raises, on a
CPU tensor it computes its plain version:

- :func:`causal_grouped_attention` (``csrc/causal_grouped_attention.cu``,
  replaces ``_causal_grouped_kernel``) -- the projection layout
  ``[B, S, N, D]`` with unrepeated K/V.
- :func:`grouped_attention` (``csrc/head_major_attention.cu``, replaces
  ``_grouped_kernel``) -- head-major ``[B, N, S, D]`` with unrepeated K/V.
- :func:`flash_attention` (``csrc/head_major_attention.cu``, replaces
  ``_flash_kernel``) -- head-major with K/V repeated to N heads.
- ``*_plain`` -- the same functions in plain PyTorch, in float32 whatever the
  input dtype; :func:`_dense_attention` -- the reference's dense path.
- :func:`attention` (head-major) and :func:`attention_bsnd` (projection
  layout) -- the dispatchers.
- :func:`cache_extend_attention` -- the suffix-extension prefill's attention
  over a prefilled prefix cache, a plain PyTorch op as in the reference,
  which has no Pallas kernel for it.

All three kernels run one Hopper tile core, ``csrc/attention_tile.cuh``
(an asynchronous K/V ring, ``wgmma`` for both products), each with its own
row-addressing policy: the projection layout for the causal kernel,
head-major for the grouped and flash kernels.

``NEG_INF`` stays finite: fully masked rows and length-0 rows rely on it
(their softmax is uniform, not NaN, and is then zeroed explicitly).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from . import _build

NEG_INF = -1e9
GROUPED_MAX_SEQ = 2048           # attention() picks the grouped kernel up to here
KERNEL_SOURCES = ("causal_grouped_attention", "head_major_attention")


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


def grouped_attention_plain(q, k, v, lengths, causal: bool = True):
    """Plain PyTorch version of :func:`grouped_attention`: q ``[B, N, S, D]``,
    unrepeated k/v ``[B, G, S, D]`` -> ``[B, N, S, D]`` in q's dtype,
    computed in float32 (the head-major view of
    :func:`causal_grouped_attention_plain`)."""
    out = causal_grouped_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lengths, causal)
    return out.transpose(1, 2)


def flash_attention_plain(q, k, v, lengths, causal: bool = True):
    """Plain PyTorch version of :func:`flash_attention`: q and k/v all
    ``[B, N, S, D]`` (K/V repeated to the N query heads), float32 -- the
    grouped function with one query head per K/V head."""
    return grouped_attention_plain(q, k, v, lengths, causal)


_fns: Dict[str, ctypes._CFuncPtr] = {}


def _kernel(source: str, name: str):
    """Entry point ``name`` of ``csrc/<source>.cu``, built on first use.
    Every entry point takes (q, k, v, lengths, out, B, S, N, G, D, causal,
    stream) and returns a cudaError_t."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(source), name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_kernel_inputs(q, k, v, lengths, head_axis: int = 2):
    """Raise on what the kernels do not take.  ``head_axis`` is 2 for the
    projection layout (q ``[B,S,N,D]``, k/v ``[B,S,G,D]``) and 1 for the
    head-major one (q ``[B,N,S,D]``, k/v ``[B,G,S,D]``)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need 4-d q and k/v of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    n, g, d = q.shape[head_axis], k.shape[head_axis], q.shape[3]
    want = list(q.shape)
    want[head_axis] = g
    if list(k.shape) != want:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if g < 1 or n % g:
        raise ValueError(f"query heads {n} not a multiple of K/V heads {g}")
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"head dim {d}: the kernel takes D <= 128, D % 8 == 0")
    b = q.shape[0]
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


def _launch(source, name, q, k, v, lengths, causal, head_axis):
    """Check, allocate the output and launch one kernel on the current
    stream; raise if the launch is refused."""
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_kernel_inputs(q, k, v, lengths, head_axis)
    b, d = q.shape[0], q.shape[3]
    s = q.shape[3 - head_axis]
    n, g = q.shape[head_axis], k.shape[head_axis]
    out = torch.empty_like(q)
    fn = _kernel(source, name)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), b, s, n, g, d, int(bool(causal)),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out


def causal_grouped_attention(q, k, v, lengths, causal: bool = True):
    """Causal (or length-only) grouped attention on the projection layout:
    q ``[B, S, N, D]``, unrepeated k/v ``[B, S, G, D]``, lengths ``[B]``
    int32 -> ``[B, S, N, D]``.

    On a CUDA tensor this launches the Hopper kernel on
    ``csrc/attention_tile.cuh`` (bf16 in and out, ``wgmma`` products with
    float32 accumulation, float32 softmax, a ~16-bit P in P.V) and counts
    the launch in ``causal_grouped_attention.launches``; there is no
    fallback.  On a CPU tensor it returns
    :func:`causal_grouped_attention_plain`."""
    if q.device.type == "cpu":
        return causal_grouped_attention_plain(q, k, v, lengths, causal)
    out = _launch("causal_grouped_attention", "causal_grouped_attention_bf16",
                  q, k, v, lengths, causal, head_axis=2)
    causal_grouped_attention.launches += 1
    return out


def grouped_attention(q, k, v, lengths, causal: bool = True):
    """Head-major grouped attention: q ``[B, N, S, D]``, unrepeated k/v
    ``[B, G, S, D]`` (N % G == 0), lengths ``[B]`` int32 -> ``[B, N, S, D]``.
    Row bound = min(length, pos + 1) (causal) or length; a row whose bound
    is 0 is zero.

    On a CUDA tensor this launches ``grouped_attention_bf16``, the tile
    core of ``csrc/attention_tile.cuh`` on head-major rows with K/V
    unrepeated (each K/V tile staged once for all the heads of its group;
    bf16 in and out, ``wgmma`` products with float32 accumulation, float32
    softmax, a ~16-bit P in P.V), and counts it in
    ``grouped_attention.launches``; there is no fallback.  On a CPU tensor
    it returns :func:`grouped_attention_plain`."""
    if q.device.type == "cpu":
        return grouped_attention_plain(q, k, v, lengths, causal)
    out = _launch("head_major_attention", "grouped_attention_bf16",
                  q, k, v, lengths, causal, head_axis=1)
    grouped_attention.launches += 1
    return out


def flash_attention(q, k, v, lengths, causal: bool = True):
    """Per-head attention on ``[B, N, S, D]`` with K/V already repeated to N
    heads, lengths ``[B]`` int32 -> ``[B, N, S, D]``; mask ``col < length``
    (and ``col <= row`` when causal), a length-0 row is zero.

    On a CUDA tensor this launches ``flash_attention_bf16``, the tile core
    of ``csrc/attention_tile.cuh`` on head-major rows (bf16 in and out,
    products as exact as the TPU kernel's fp32 ones up to summation order
    and a ~16-bit P), and counts it in ``flash_attention.launches``; there
    is no fallback.  On a CPU tensor it returns
    :func:`flash_attention_plain`."""
    if k.shape != q.shape:
        raise ValueError(f"flash attention takes K/V repeated to q's shape "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths, causal)
    out = _launch("head_major_attention", "flash_attention_bf16",
                  q, k, v, lengths, causal, head_axis=1)
    flash_attention.launches += 1
    return out


causal_grouped_attention.launches = 0
grouped_attention.launches = 0
flash_attention.launches = 0


def attention(q, k, v, lengths, causal: bool = True,
              force: Optional[str] = None):
    """Head-major dispatch: q ``[B, N, S, D]``, k/v ``[B, G, S, D]`` with G
    dividing N (K/V not yet repeated) or G == N.

    ``force``: ``"grouped"`` (:func:`grouped_attention`), ``"pallas"``
    (:func:`flash_attention` on K/V repeated here) or ``"dense"``.  Default:
    on a CUDA tensor ``"grouped"`` up to ``GROUPED_MAX_SEQ`` and ``"pallas"``
    beyond it; elsewhere ``"dense"``, as the reference off the TPU.  An
    unknown ``force`` raises."""
    n, s = q.shape[1], q.shape[2]
    backend = force
    if backend is None:
        if q.device.type == "cuda":
            backend = "grouped" if s <= GROUPED_MAX_SEQ else "pallas"
        else:
            backend = "dense"
    if backend not in ("grouped", "pallas", "dense"):
        raise ValueError(f"unknown attention backend {force!r}")
    if backend == "grouped":
        return grouped_attention(q, k, v, lengths, causal)
    if k.shape[1] != n:                    # grouped K/V on a non-grouped path
        reps = n // k.shape[1]
        k = k.repeat_interleave(reps, dim=1)
        v = v.repeat_interleave(reps, dim=1)
    if backend == "pallas":
        return flash_attention(q, k, v, lengths, causal)
    return _dense_attention(q, k, v, lengths, causal)


def attention_bsnd(q, k, v, lengths, causal: bool = True,
                   force: Optional[str] = None):
    """Layout-native dispatch: q ``[B, S, N, D]``, k/v ``[B, S, G, D]``.

    Default (and ``force="causal"``): :func:`causal_grouped_attention` --
    the kernel on a CUDA tensor, its plain version on a CPU tensor.  Any
    other ``force`` transposes to head-major and goes through
    :func:`attention`."""
    if force in (None, "causal"):
        return causal_grouped_attention(q, k, v, lengths, causal)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return attention(qh, kh, vh, lengths, causal, force=force).transpose(1, 2)


def cache_extend_attention(q, kp, vp, kt, vt, bias,
                           kp_scale=None, vp_scale=None):
    """Attention of a suffix-extension prefill (``decoder.extend_prefill``):
    the suffix's queries attend jointly over the read-only prefix cache block
    and the suffix's own K/V.

    q ``[B, S, N, D]``; kp/vp ``[B, T, G, D]`` the prefix block; kt/vt
    ``[B, S, G, D]`` the suffix's own K/V; bias fp32 additive ``[B, N or 1,
    S, T + S]`` over the concatenated key axis (the caller owns positions
    and validity).  ``kp_scale``/``vp_scale`` ``[B, T, G]``: an int8 prefix
    block is dequantized here, right before the softmax; the suffix's K/V
    are exact.

    One joint softmax in float32 over the concatenated keys (not the
    decode's two-block split), with MQA/GQA K/V repeated to the query heads
    as the dense prompt path repeats them: masked prefix slots contribute
    exact zeros, so this is the dense full-prompt attention over the same
    keys.  Products run in the query dtype, as the reference's."""
    from . import quant

    kp = (quant.dequantize_kv(kp, kp_scale, kt.dtype) if kp_scale is not None
          else kp.to(kt.dtype))
    vp = (quant.dequantize_kv(vp, vp_scale, vt.dtype) if vp_scale is not None
          else vp.to(vt.dtype))
    k = torch.cat([kp, kt], dim=1)
    v = torch.cat([vp, vt], dim=1)
    b, t, g, d = k.shape
    n = q.shape[2]
    if g != n:
        k = k[:, :, :, None, :].expand(b, t, g, n // g, d).reshape(b, t, n, d)
        v = v[:, :, :, None, :].expand(b, t, g, n // g, d).reshape(b, t, n, d)
    scale = torch.tensor(math.sqrt(d), dtype=q.dtype)
    scores = torch.einsum("bsnd,btnd->bnst", q, k) / scale
    probs = torch.softmax(scores.float() + bias, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)
