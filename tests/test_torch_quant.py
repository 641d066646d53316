"""W8A8 int8 quantization of the PyTorch port against the JAX reference.

The same float32 numpy inputs go through ``ops/quant.py`` of both packages.
The int8 codes, the float32 scales and the int32 accumulators of the int8
product must be identical (both round half to even and keep the reference's
order of float32 operations); the rescaled output of ``int8_matmul`` matches
at rtol 1e-6 (one float32 rounding of the same three factors).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from helpers import random_decoder_params
from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.ops import quant as jquant
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.ops import quant as tquant
from test_torch_slots import one_torch_thread  # noqa: F401


def _normal(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _assert_same(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert got.dtype == getattr(torch, str(ref.dtype)), (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape,axis", [((64, 48), -2), ((3, 40, 24), -2),
                                        ((32, 16), 0)])
def test_quantize_weight_matches_reference(shape, axis):
    """Per-output-channel codes and scales, stacked or not, along either
    contraction axis; a zero column takes the 1e-8 floor of the scale."""
    w = _normal(0, *shape, scale=0.02)
    w[..., 0] = 0.0 if axis == -2 else w[..., 0]
    q, s = tquant.quantize_weight(torch.from_numpy(w), contract_axis=axis)
    jq, js = jquant.quantize_weight(jnp.asarray(w), contract_axis=axis)
    _assert_same(q, jq)
    _assert_same(s, js)
    nq, ns = tquant.quantize_weight_np(w, contract_axis=axis)
    rq, rs = jquant.quantize_weight_np(w, contract_axis=axis)
    np.testing.assert_array_equal(nq, rq)
    np.testing.assert_array_equal(ns, rs)
    np.testing.assert_array_equal(nq, q.numpy())


@pytest.mark.parametrize("shape", [(5, 64), (2, 7, 256), (1, 1, 40)])
def test_quantize_activations_matches_reference(shape):
    x = _normal(1, *shape, scale=3.0)
    x[0, ...] *= 1e-3              # a small-magnitude token
    q, s = tquant.quantize_activations(torch.from_numpy(x))
    jq, js = jquant.quantize_activations(jnp.asarray(x))
    _assert_same(q, jq)
    _assert_same(s, js)


def test_quantize_kv_and_dequantize_match_reference():
    """Per-(slot, head) scales over head_dim; a zero (padded) slot takes the
    scale floor; dequantization in float32 and into bf16."""
    x = _normal(2, 2, 3, 12, 2, 16)                    # [L, B, T, G, D]
    x[:, :, -3:] = 0.0
    q, s = tquant.quantize_kv(torch.from_numpy(x))
    jq, js = jquant.quantize_kv(jnp.asarray(x))
    _assert_same(q, jq)
    _assert_same(s, js)
    assert s.shape == (2, 3, 12, 2)
    np.testing.assert_array_equal(
        tquant.dequantize_kv(q, s).numpy(),
        np.asarray(jquant.dequantize_kv(jq, js)))
    got = tquant.dequantize_kv(q, s, torch.bfloat16).float().numpy()
    ref = np.asarray(jquant.dequantize_kv(jq, js, jnp.bfloat16)).astype(np.float32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("m,k,n", [(1, 64, 24), (6, 256, 32), (40, 96, 1024)])
def test_int8_matmul_matches_reference(m, k, n):
    """The int32 accumulators are identical to the reference's; the rescaled
    output agrees at rtol 1e-6.  M=1 is the single undecided row of a
    look-ahead chunk."""
    x = _normal(3, 2, m, k)
    w = _normal(4, k, n, scale=0.05)
    jw, jws = jquant.quantize_weight(jnp.asarray(w))
    tw, tws = tquant.quantize_weight(torch.from_numpy(w))
    tx_q, _ = tquant.quantize_activations(torch.from_numpy(x))
    jx_q, _ = jquant.quantize_activations(jnp.asarray(x))
    acc = tquant.int8_accumulate(tx_q, tquant.int8_matmul_layout(tw))
    ref_acc = lax.dot_general(jx_q, jw, (((2,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    _assert_same(acc, ref_acc)
    got = tquant.int8_matmul(torch.from_numpy(x), tw, tws)
    ref = jquant.int8_matmul(jnp.asarray(x), jw, jws)
    assert got.dtype == torch.float32 and got.shape == (2, m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


def test_linear_dispatch_and_layout():
    """``linear`` takes the int8 path exactly when ``{key}_qscale`` is
    present; the N-major layout is the same tensor; a device with no int8
    product raises."""
    x = torch.from_numpy(_normal(5, 4, 32))
    w = torch.from_numpy(_normal(6, 32, 16, scale=0.1))
    q, s = tquant.quantize_weight(w)
    laid = tquant.int8_matmul_layout(q)
    assert torch.equal(laid, q) and laid.stride() == (1, 32)
    torch.testing.assert_close(tquant.linear({"w": w}, "w", x), x @ w)
    assert torch.equal(tquant.linear({"w": laid, "w_qscale": s}, "w", x),
                       tquant.int8_matmul(x, q, s))
    with pytest.raises(ValueError):
        tquant.int8_accumulate(torch.zeros(2, 8, dtype=torch.int8, device="meta"),
                               torch.zeros(8, 8, dtype=torch.int8, device="meta"))


def test_quantize_decoder_params_matches_reference():
    """The tree walkers quantize the same leaves to the same codes and
    scales (torch and numpy twins), and leave the rest alone."""
    jcfg = jconfig.DecoderConfig(**jconfig.FLAGSHIP_SMALL_GEOMETRY)
    params = jax.tree_util.tree_map(np.asarray, random_decoder_params(jcfg, 2))
    ref = jax.tree_util.tree_map(np.asarray, jquant.quantize_decoder_params(
        jax.tree_util.tree_map(jnp.asarray, params)))
    ref_np = jquant.quantize_decoder_params_np(params)
    got_np = tquant.quantize_decoder_params_np(params)
    got = tquant.quantize_decoder_params(
        jax.tree_util.tree_map(torch.tensor, params))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    for tree in (ref_np, got_np, got):
        leaves = jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, tree))
        assert [p for p, _ in leaves] == [p for p, _ in ref_leaves]
        for (path, a), (_, b) in zip(leaves, ref_leaves):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    assert got["layers"]["attn"]["wk_qscale"].shape == (4, 32)
    assert got["embed"]["tokens"].dtype == torch.float32


def test_quantized_weights_load_and_quantize_at_load():
    """``params_from_jax`` keeps int8 codes int8 (N-major) and the scales
    float32 whatever ``dtype`` the rest takes; ``random_params(quant=
    "int8")`` gives the quantization of the same seed's weights."""
    jcfg = jconfig.DecoderConfig(**jconfig.FLAGSHIP_SMALL_GEOMETRY)
    tcfg = tconfig.DecoderConfig(**tconfig.FLAGSHIP_SMALL_GEOMETRY)
    qparams = jquant.quantize_decoder_params_np(
        jax.tree_util.tree_map(np.asarray, random_decoder_params(jcfg, 2)))
    tree = convert.params_from_jax(qparams, tcfg, device="cpu",
                                   dtype="bf16").tree()
    wi = tree["layers"]["mlp"]["wi"]
    assert wi.dtype == torch.int8 and wi.stride()[-2:] == (1, 256)
    np.testing.assert_array_equal(wi.numpy(), qparams["layers"]["mlp"]["wi"])
    assert tree["layers"]["mlp"]["wi_qscale"].dtype == torch.float32
    assert tree["embed"]["tokens"].dtype == torch.bfloat16

    plain = convert.random_params(tcfg, seed=4, device="cpu", dtype="bf16").tree()
    q8 = convert.random_params(tcfg, seed=4, device="cpu", dtype="bf16",
                               quant="int8").tree()
    for group, key in (("attn", "wq"), ("attn", "wk"), ("mlp", "wo")):
        codes, scales = tquant.quantize_weight(plain["layers"][group][key])
        assert torch.equal(q8["layers"][group][key], codes)
        assert torch.equal(q8["layers"][group][key + "_qscale"], scales)
    assert torch.equal(q8["embed"]["tokens"], plain["embed"]["tokens"])
    with pytest.raises(ValueError):
        convert.random_params(tcfg, device="cpu", quant="int4")
