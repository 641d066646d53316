"""Head-major attention of the PyTorch port against the JAX reference.

The port's ``grouped_attention`` and ``flash_attention`` on a CPU tensor are
their plain versions; the reference runs its Pallas kernels in interpret
mode.  Inputs are float32 from a numpy seed.  Tolerance: atol 2e-5, rtol 1e-4
(the reference's own kernel-vs-dense tolerance, tests/test_ops.py) on ALL
rows: rows past a row's length attend min(length, pos + 1) keys in both
packages, and a length-0 row must be exactly zero.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_slots import one_torch_thread  # noqa: F401

# both ops packages re-export a function named ``attention``
tattn = importlib.import_module(
    "llm_interpretation_replication_tpu_torch.ops.attention")
jattn = importlib.import_module("llm_interpretation_replication_tpu.ops.attention")

ATOL, RTOL = 2e-5, 1e-4
HEADS = [(71, 1), (8, 4), (4, 4)]         # Falcon's MQA, GQA, MHA


def _inputs(seed, b, n, g, s, d, layout="bnsd"):
    rng = np.random.default_rng(seed)
    if layout == "bnsd":
        shapes = ((b, n, s, d), (b, g, s, d))
    else:
        shapes = ((b, s, n, d), (b, s, g, d))
    q = rng.standard_normal(shapes[0]).astype(np.float32)
    k = rng.standard_normal(shapes[1]).astype(np.float32)
    v = rng.standard_normal(shapes[1]).astype(np.float32)
    lengths = np.array([s, 1, 0, s - 13], np.int32)[:b]
    return q, k, v, lengths


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _check(got, ref, lengths):
    """All rows within the tolerance; length-0 rows exactly zero."""
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert (lengths == 0).any()
    for i in np.flatnonzero(lengths == 0):
        np.testing.assert_array_equal(got[i], 0.0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [48, 40])
@pytest.mark.parametrize("n,g", HEADS)
def test_grouped_matches_reference_kernel(n, g, s, causal):
    """Unrepeated K/V; row blocks of 32 straddle head boundaries and pad
    the tail (S=40 has no power-of-two block of 16)."""
    b, d = 4, 16
    q, k, v, lengths = _inputs(20, b, n, g, s, d)
    ref = jattn.grouped_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), lengths, causal=causal,
                                  block_rows=32, interpret=True)
    got = tattn.grouped_attention(*_t(q, k, v, lengths), causal)
    _check(got, ref, lengths)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [48, 40])
@pytest.mark.parametrize("n,g", HEADS)
def test_flash_matches_reference_kernel(n, g, s, causal):
    """K/V repeated to N heads first, as the dispatcher does; the reference
    picks its own power-of-two blocks (16 at S=48, 8 at S=40)."""
    b, d = 4, 16
    q, k, v, lengths = _inputs(21, b, n, g, s, d)
    k, v = (np.repeat(t, n // g, axis=1) for t in (k, v))
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), lengths, causal=causal,
                                interpret=True)
    got = tattn.flash_attention(*_t(q, k, v, lengths), causal)
    _check(got, ref, lengths)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,g", [(71, 1), (8, 2), (4, 4)])
@pytest.mark.parametrize("s,d", [(1, 64), (63, 96), (64, 128), (65, 64),
                                 (127, 96), (129, 128)])
def test_flash_edges_match_reference(s, d, n, g, causal):
    """chip_smoke.py's edge shapes (S around the 64-key tile, D padded to 64
    or 128) with lengths [S, 1, 0, mid-tile]: against the interpret-mode
    kernel where its wrapper takes the S (``pick_block`` needs S % 8 == 0),
    elsewhere against the reference's dense path."""
    q, k, v, _ = _inputs(40 + s, 4, n, g, s, d)
    lengths = np.array([s, 1, 0, s - s // 3], np.int32)
    k, v = (np.repeat(t, n // g, axis=1) for t in (k, v))
    args = [jnp.asarray(a) for a in (q, k, v)]
    if jattn.pick_block(s, jattn.DEFAULT_BLOCK_Q) is not None:
        ref = jattn.flash_attention(*args, lengths, causal=causal,
                                    interpret=True)
    else:
        ref = jattn._dense_attention(*args, jnp.asarray(lengths), causal)
    got = tattn.flash_attention(*_t(q, k, v, lengths), causal)
    _check(got, ref, lengths)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,g", [(71, 1), (8, 2), (4, 4)])
@pytest.mark.parametrize("s,d", [(1, 64), (63, 96), (64, 128), (65, 64),
                                 (127, 96), (129, 128)])
def test_grouped_edges_match_reference(s, d, n, g, causal):
    """chip_smoke.py's edge shapes for the grouped kernel, K/V unrepeated,
    with lengths [S, 1, 0, mid-tile], against the interpret-mode kernel
    (its wrapper pads the rows, so it takes every S)."""
    q, k, v, _ = _inputs(60 + s, 4, n, g, s, d)
    lengths = np.array([s, 1, 0, s - s // 3], np.int32)
    ref = jattn.grouped_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), lengths, causal=causal,
                                  interpret=True)
    got = tattn.grouped_attention(*_t(q, k, v, lengths), causal)
    _check(got, ref, lengths)


@pytest.mark.parametrize("force", [None, "grouped", "pallas", "dense"])
def test_attention_dispatch_matches_reference(force):
    """The head-major dispatcher on every route with grouped K/V (the
    non-grouped routes repeat K/V themselves); ``None`` on a CPU tensor is
    the dense path in both packages."""
    b, n, g, s, d = 4, 8, 2, 40, 16
    q, k, v, lengths = _inputs(22, b, n, g, s, d)
    ref = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          lengths, True, force=force, interpret=True)
    got = tattn.attention(*_t(q, k, v, lengths), True, force=force)
    _check(got, ref, lengths)


@pytest.mark.parametrize("force", ["grouped", "pallas"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_bsnd_forced_routes_match_reference(force, causal):
    """The layout-native dispatcher hands a forced route to the head-major
    one, as the reference does: Falcon's 71 query heads on 1 K/V head,
    D=64, S=48."""
    b, n, g, s, d = 4, 71, 1, 48, 64
    q, k, v, lengths = _inputs(23, b, n, g, s, d, layout="bsnd")
    ref = jattn.attention_bsnd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               lengths, causal, force=force, interpret=True)
    got = tattn.attention_bsnd(*_t(q, k, v, lengths), causal, force=force)
    assert got.shape == (b, s, n, d)
    _check(got, ref, lengths)


def test_unknown_force_raises():
    """The reference silently goes dense on an unknown ``force``; the port
    raises (a departure PERF.md records)."""
    q, k, v, lengths = _t(*_inputs(24, 2, 4, 2, 16, 8))
    with pytest.raises(ValueError, match="unknown attention backend"):
        tattn.attention(q, k, v, lengths, force="flash")
    with pytest.raises(ValueError, match="unknown attention backend"):
        tattn.attention_bsnd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), lengths, force="flash")


def test_flash_takes_only_repeated_kv():
    q, k, v, lengths = _t(*_inputs(25, 2, 4, 2, 16, 8))
    with pytest.raises(ValueError, match="repeated"):
        tattn.flash_attention(q, k, v, lengths)


@pytest.mark.parametrize("case,exc", [
    ("fp32", TypeError),
    ("seq", ValueError),
    ("groups", ValueError),
    ("strided", ValueError),
])
def test_head_major_kernel_input_checks(case, exc):
    """The checks before a head-major launch: bf16 only, K/V of q's batch
    and length, N % G == 0, contiguous inputs."""
    b, n, g, s, d = 2, 4, 2, 16, 16
    dt = torch.float32 if case == "fp32" else torch.bfloat16
    if case == "groups":
        g = 3
    q = torch.zeros(b, n, s, d, dtype=dt)
    k = torch.zeros(b, g, s + (case == "seq"), d, dtype=dt)
    lengths = torch.full((b,), s, dtype=torch.int32)
    if case == "strided":
        q = torch.zeros(b, s, n, d, dtype=dt).transpose(1, 2)
    with pytest.raises(exc):
        tattn._check_kernel_inputs(q, k, k, lengths, head_axis=1)


@pytest.mark.parametrize("fn", ["grouped_attention", "flash_attention"])
def test_wrappers_have_no_path_for_other_devices(fn):
    """Only a CPU tensor takes the plain version; any other non-CUDA device
    raises instead of falling back."""
    q = torch.zeros(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError):
        getattr(tattn, fn)(q, q, q, torch.ones(1, dtype=torch.int32))
