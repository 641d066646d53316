"""Prefill attention of the PyTorch port against the JAX reference.

The port's ``causal_grouped_attention`` on a CPU tensor is its plain
version; the reference runs its Pallas kernel in interpret mode.  Inputs are
float32 from a numpy seed.  Tolerance: atol 2e-5, rtol 1e-4 (the reference's
own kernel-vs-dense tolerance, tests/test_ops.py), on the valid rows (on
all rows for the edge shapes).
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


def _inputs(seed, b, s, n, g, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, n, d)).astype(np.float32)
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, d)).astype(np.float32)
    return q, k, v


def _valid(lengths, s):
    return (np.arange(s)[None, :] < lengths[:, None])[:, :, None, None]


def _port(q, k, v, lengths, causal, force=None):
    out = tattn.attention_bsnd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.from_numpy(lengths), causal, force=force)
    return out.numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_heads,n_kv", [(6, 1), (8, 4), (4, 4)])
def test_causal_grouped_matches_reference_kernel(causal, n_heads, n_kv):
    """Clean, boundary and skipped key blocks (block_k=16 at S=48) and a
    length bound inside a clean region, against the interpret-mode kernel."""
    b, s, d = 2, 48, 16
    q, k, v = _inputs(8, b, s, n_heads, n_kv, d)
    lengths = np.array([s, s - 17], np.int32)
    ref = np.asarray(jattn.causal_grouped_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths,
        causal=causal, block_k=16, interpret=True))
    valid = _valid(lengths, s)
    for force in (None, "causal", "dense"):
        got = _port(q, k, v, lengths, causal, force)
        np.testing.assert_allclose(got * valid, ref * valid, atol=ATOL, rtol=RTOL)


# chip_smoke.py's edge shapes: S around the 64-key tile, each with one of the
# head dims that the kernel pads to 64 or 128
EDGE_SD = [(1, 64), (63, 96), (64, 128), (65, 64), (127, 96), (129, 128)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,g", [(71, 1), (8, 2), (4, 4)])
@pytest.mark.parametrize("s,d", EDGE_SD)
def test_causal_grouped_edges_match_reference(s, d, n, g, causal):
    """Lengths [S, 1, 0, mid-tile], on ALL rows: against the interpret-mode
    kernel where its wrapper takes the S (``pick_block_pos`` needs a
    position block with ``bp * heads_per_group % 8 == 0``), elsewhere
    against the reference's dense path."""
    b = 4
    q, k, v = _inputs(30 + s, b, s, n, g, d)
    lengths = np.array([s, 1, 0, s - s // 3], np.int32)
    if jattn.pick_block_pos(s, n // g) is not None:
        ref = np.asarray(jattn.causal_grouped_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths,
            causal=causal, interpret=True))
    else:
        tr = (0, 2, 1, 3)
        kh, vh = (np.repeat(t.transpose(tr), n // g, axis=1) for t in (k, v))
        ref = np.asarray(jattn._dense_attention(
            jnp.asarray(q.transpose(tr)), jnp.asarray(kh), jnp.asarray(vh),
            jnp.asarray(lengths), causal)).transpose(tr)
    got = tattn.causal_grouped_attention(
        *(torch.from_numpy(a) for a in (q, k, v, lengths)), causal).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got[2], 0.0)


def test_causal_grouped_padded_seq_and_zero_rows():
    """S=40 is not a multiple of the reference's key block; a length-0 row
    comes back exactly zero on every path."""
    b, s, n, d = 2, 40, 4, 16
    q, k, v = _inputs(9, b, s, n, 1, d)
    lengths = np.array([s - 3, 0], np.int32)
    ref = np.asarray(jattn.causal_grouped_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths,
        causal=True, block_k=16, interpret=True))
    valid = _valid(lengths, s)
    for force in (None, "dense"):
        got = _port(q, k, v, lengths, True, force)
        np.testing.assert_array_equal(got[1], 0.0)
        np.testing.assert_allclose(got * valid, ref * valid, atol=ATOL, rtol=RTOL)


def test_attention_bsnd_dispatch_matches_reference():
    """The layout-native dispatcher against the reference's on both of its
    forced backends (causal kernel in interpret mode, dense)."""
    b, s, n, g, d = 2, 64, 8, 2, 16
    q, k, v = _inputs(10, b, s, n, g, d)
    lengths = np.array([s, s - 11], np.int32)
    valid = _valid(lengths, s)
    for force in ("causal", "dense"):
        ref = np.asarray(jattn.attention_bsnd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths,
            causal=True, force=force, interpret=True))
        got = _port(q, k, v, lengths, True, force)
        np.testing.assert_allclose(got * valid, ref * valid, atol=ATOL, rtol=RTOL)


def test_falcon_geometry_mqa():
    """Falcon-7B's head layout (71 query heads on 1 K/V head, D=64) with
    ragged lengths including 1 and 0."""
    b, s, n, d = 4, 48, 71, 64
    q, k, v = _inputs(11, b, s, n, 1, d)
    lengths = np.array([s, 1, 0, 29], np.int32)
    ref = np.asarray(jattn.causal_grouped_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths,
        causal=True, interpret=True))
    got = _port(q, k, v, lengths, True)
    valid = _valid(lengths, s)
    np.testing.assert_allclose(got * valid, ref * valid, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got[2], 0.0)


def test_dense_attention_matches_reference():
    """Head-major dense path, causal and not, with a length-0 row."""
    rng = np.random.default_rng(12)
    b, n, s, d = 3, 4, 24, 8
    q, k, v = (rng.standard_normal((b, n, s, d)).astype(np.float32)
               for _ in range(3))
    lengths = np.array([s, 7, 0], np.int32)
    for causal in (True, False):
        ref = np.asarray(jattn._dense_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths), causal))
        got = tattn._dense_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(lengths), causal).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case,exc", [
    ("fp32", TypeError),
    ("head_dim", ValueError),
    ("groups", ValueError),
    ("lengths_dtype", ValueError),
    ("strided", ValueError),
])
def test_kernel_input_checks(case, exc):
    """The wrapper's checks before a launch: bf16 only, D <= 128 with
    D % 8 == 0, N % G == 0, int32 lengths, contiguous inputs."""
    b, s, n, g, d = 2, 16, 4, 2, 16
    dt = torch.float32 if case == "fp32" else torch.bfloat16
    if case == "head_dim":
        d = 12
    if case == "groups":
        g = 3
    q = torch.zeros(b, s, n, d, dtype=dt)
    k = torch.zeros(b, s, g, d, dtype=dt)
    v = torch.zeros(b, s, g, d, dtype=dt)
    lengths = torch.full((b,), s, dtype=torch.int64 if case == "lengths_dtype"
                         else torch.int32)
    if case == "strided":
        q = torch.zeros(b, n, s, d, dtype=dt).transpose(1, 2)
    with pytest.raises(exc):
        tattn._check_kernel_inputs(q, k, v, lengths)


def test_wrapper_has_no_path_for_other_devices():
    """Only a CPU tensor takes the plain version; any other non-CUDA device
    raises instead of falling back."""
    q = torch.zeros(1, 4, 2, 8, device="meta")
    k = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError):
        tattn.causal_grouped_attention(q, k, k, torch.ones(1, dtype=torch.int32))
