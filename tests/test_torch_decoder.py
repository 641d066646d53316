"""The port's decoder against the JAX reference on the same weights.

``FLAGSHIP_SMALL_GEOMETRY`` (Falcon's architecture at test scale) with
``tests/helpers.random_decoder_params`` carried across by
``params_from_jax``; float32 throughout.  Tolerances: logits and K/V atol
2e-5 (float32 through four layers); greedy tokens identical; the reduced
score fields rtol 2e-5 (the fp32 class of PARITY.md) with an absolute floor
of 2e-6 for logits near zero, where a relative bound means nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import random_decoder_params
from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.models import decoder as jdec
from llm_interpretation_replication_tpu.ops import quant as jquant
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.models import decoder as tdec
from llm_interpretation_replication_tpu_torch.ops import quant as tquant
from test_torch_slots import one_torch_thread  # noqa: F401

ATOL = 2e-5
RTOL_SCORES, ATOL_SCORES = 2e-5, 2e-6


def _models(impl, w8a8=False, kv="bf16"):
    """Both packages' configs and weights; ``w8a8`` quantizes the reference
    tree (``quantize_decoder_params_np``) before both take it."""
    jcfg = jconfig.DecoderConfig(**{**jconfig.FLAGSHIP_SMALL_GEOMETRY,
                                    "attention_impl": impl,
                                    "kv_cache_dtype": kv})
    tcfg = tconfig.DecoderConfig(**{**tconfig.FLAGSHIP_SMALL_GEOMETRY,
                                    "attention_impl": impl,
                                    "kv_cache_dtype": kv})
    params_np = jax.tree_util.tree_map(np.asarray,
                                       random_decoder_params(jcfg, seed=3))
    if w8a8:
        params_np = jquant.quantize_decoder_params_np(params_np)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    weights = convert.params_from_jax(params_np, tcfg, device="cpu",
                                      dtype="fp32")
    return jcfg, tcfg, params, weights


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    b, s = 3, 48
    ids = rng.integers(3, 1024, (b, s)).astype(np.int32)
    lengths = np.array([48, 17, 30])
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_and_prefill_match(impl):
    jcfg, tcfg, params, weights = _models(impl)
    ids, mask = _batch()
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    ref = np.asarray(jdec.forward_last_logits(params, jcfg, jnp.asarray(ids),
                                              jnp.asarray(mask)))
    got = tdec.forward_last_logits(weights, tcfg, tids, tmask).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)

    full_ref = np.asarray(jdec.forward(params, jcfg, jnp.asarray(ids),
                                       jnp.asarray(mask)))
    full = tdec.forward(weights, tcfg, tids, tmask).numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(full[real], full_ref[real], atol=ATOL)

    cache_len = 64
    jlast, jcache = jdec.prefill(params, jcfg, jnp.asarray(ids),
                                 jnp.asarray(mask), cache_len=cache_len)
    tlast, tcache = tdec.prefill(weights, tcfg, tids, tmask, cache_len=cache_len)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=ATOL)
    assert tcache.k.shape == jcache.k.shape == (4, 3, cache_len, 1, 32)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=ATOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), atol=ATOL)
    np.testing.assert_array_equal(tcache.valid.numpy(), np.asarray(jcache.valid))
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
    assert int(tcache.length) == int(jcache.length)


def _decode_pair(impl, eos=None, with_scores="reduced", chunks=(5,), **model):
    """Prefill, then decode ``chunks`` in sequence on both packages."""
    jcfg, tcfg, params, weights = _models(impl, **model)
    ids, mask = _batch(1)
    lengths = mask.sum(-1)
    tgt = np.array([[5, 6], [7, 8], [5, 9]], np.int32)
    jlast, jcache = jdec.prefill(params, jcfg, jnp.asarray(ids),
                                 jnp.asarray(mask), cache_len=48)
    tlast, tcache = tdec.prefill(weights, tcfg, torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask), cache_len=48)
    out = []
    jdone = tdone = None
    offset = 0
    for n in chunks:
        jt, js, jcache, jlast, jdone = jdec.decode_steps(
            params, jcfg, jcache, jlast, jnp.asarray(lengths), np.int32(offset),
            n, eos, jdone, with_scores=with_scores,
            target_ids=jnp.asarray(tgt) if with_scores == "reduced" else None)
        tt, ts, tcache, tlast, tdone = tdec.decode_steps(
            weights, tcfg, tcache, tlast, torch.from_numpy(lengths), offset, n,
            eos, tdone, with_scores=with_scores,
            target_ids=torch.from_numpy(tgt).long()
            if with_scores == "reduced" else None)
        out.append((jt, js, jdone, tt, ts, tdone))
        offset += n
    return out, (jcache, jlast, tcache, tlast)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_decode_steps_reduced_match(impl):
    """Two chunks (the second reads the first's folded tail): identical
    tokens, reduced fields within the fp32 class, same grown cache."""
    chunks, (jcache, jlast, tcache, tlast) = _decode_pair(impl, chunks=(5, 3))
    for jt, js, _, tt, ts, _ in chunks:
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ts.topk_ids.numpy(), np.asarray(js.topk_ids))
        for f in ("topk_vals", "logz", "target_logits"):
            np.testing.assert_allclose(
                getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                rtol=RTOL_SCORES, atol=ATOL_SCORES, err_msg=f)
    assert tcache.k.shape == jcache.k.shape
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=ATOL)
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
    np.testing.assert_array_equal(tcache.valid.numpy(), np.asarray(jcache.valid))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=ATOL)


def test_decode_steps_full_scores_and_eos_freeze():
    """``with_scores=True`` stacks the full fp32 scores; once a row emits
    EOS it keeps emitting it (``done``), on both packages alike."""
    first, _ = _decode_pair("xla", with_scores=True)
    eos = int(np.asarray(first[0][0])[0, 1])      # row 0's second token
    (jt, js, jdone, tt, ts, tdone), = _decode_pair("xla", eos=eos,
                                                   with_scores=True)[0]
    tokens = tt.numpy()
    np.testing.assert_array_equal(tokens, np.asarray(jt))
    assert (tokens[0, 1:] == eos).all()
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL_SCORES,
                               atol=ATOL_SCORES)


def test_weights_module_and_random_params():
    """The weights module round-trips the reference's tree (a tied model has
    no lm_head); random_params is deterministic in its seed and follows the
    config's layout."""
    jcfg, tcfg, params, weights = _models("xla")
    tree = weights.tree()
    assert "lm_head" not in tree and "ln2" in tree["layers"]
    np.testing.assert_array_equal(tree["layers"]["attn"]["wq"].numpy(),
                                  np.asarray(params["layers"]["attn"]["wq"]))
    a = convert.random_params(tcfg, seed=7, device="cpu", dtype="bf16")
    b = convert.random_params(tcfg, seed=7, device="cpu", dtype="bf16")
    c = convert.random_params(tcfg, seed=8, device="cpu", dtype="bf16")
    ta, tb, tc = a.tree(), b.tree(), c.tree()
    assert torch.equal(ta["layers"]["mlp"]["wi"], tb["layers"]["mlp"]["wi"])
    assert not torch.equal(ta["layers"]["mlp"]["wi"], tc["layers"]["mlp"]["wi"])
    assert ta["layers"]["attn"]["wk"].shape == (4, 256, 32)
    assert ta["embed"]["tokens"].dtype == torch.bfloat16
    assert "ln2" not in ta["layers"] and "lm_head" not in ta   # shared LN, tied


def test_bf16_prefill_flash_agrees_with_dense():
    """In bf16 the kernel path's CPU stand-in and the dense path give the
    same last-position logits to bf16 precision (relative L2 <= 1e-2, the
    bound the card's run holds them to)."""
    _, tcfg, _, _ = _models("flash")
    weights = convert.random_params(tcfg, seed=1, device="cpu", dtype="bf16")
    ids, mask = _batch(2)
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    dense_cfg = tconfig.DecoderConfig(**{**tconfig.FLAGSHIP_SMALL_GEOMETRY,
                                         "attention_impl": "xla"})
    a = tdec.forward_last_logits(weights, tcfg, tids, tmask)
    b = tdec.forward_last_logits(weights, dense_cfg, tids, tmask)
    assert a.dtype == torch.float32
    assert float((a - b).norm() / b.norm()) <= 1e-2


# w8a8 (int8 weights, per-token int8 activations).  The int8 codes, scales
# and int32 accumulators of one projection are identical in both packages
# (tests/test_torch_quant.py), but the packages' float32 LayerNorm, GELU and
# softmax differ in the last bit, and an activation whose x / s_x lies within
# that bit of a half-integer rounds to neighbouring codes ("a flip").  A flip
# moves its projection by s_x * s_w * w_q, and the later layers' dynamic
# scales and codes carry that on.  Measured on this 4-layer model: with no
# flip the position-0 logits agree to 7e-7 (seed 5); with flips (seeds 3 and
# 4, seed 3 is the one used here) by up to 0.012, about 1% of the logit range,
# and the reduced scores by up to 0.013.  So these tests hold logits, scores
# and the dequantized cache to atol 5e-2 (~4x the measured gap), greedy
# tokens to identity, and cache scales to rtol 5e-2.
W8A8_ATOL = 5e-2


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_w8a8_prefill_matches_reference(kv):
    """Position-0 logits of the w8a8 model, and the prompt cache: int8 codes
    with per-head float32 scales when ``kv_cache_dtype="int8"``."""
    jcfg, tcfg, params, weights = _models("flash", w8a8=True, kv=kv)
    ids, mask = _batch()
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    ref = np.asarray(jdec.forward_last_logits(params, jcfg, jnp.asarray(ids),
                                              jnp.asarray(mask)))
    got = tdec.forward_last_logits(weights, tcfg, tids, tmask).numpy()
    np.testing.assert_allclose(got, ref, atol=W8A8_ATOL)
    jlast, jcache = jdec.prefill(params, jcfg, jnp.asarray(ids),
                                 jnp.asarray(mask), cache_len=64)
    tlast, tcache = tdec.prefill(weights, tcfg, tids, tmask, cache_len=64)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=W8A8_ATOL)
    if kv == "bf16":
        assert tcache.k_scale is None and jcache.k_scale is None
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                                   atol=W8A8_ATOL)
        return
    assert tcache.k.dtype == torch.int8 and tcache.k_scale.shape == (4, 3, 64, 1)
    for f in ("k", "v"):
        t_codes, j_codes = getattr(tcache, f), getattr(jcache, f)
        t_scale, j_scale = getattr(tcache, f + "_scale"), getattr(jcache, f + "_scale")
        np.testing.assert_allclose(t_scale.numpy(), np.asarray(j_scale), rtol=5e-2)
        np.testing.assert_allclose(
            tquant.dequantize_kv(t_codes, t_scale).numpy(),
            np.asarray(jquant.dequantize_kv(j_codes, j_scale)), atol=W8A8_ATOL)
    # the zero-padded slots past the prompt quantize to code 0
    assert not tcache.k[:, :, 48:].any()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_w8a8_decode_steps_match_reference(kv):
    """Two chunks of scored decode on the w8a8 model: identical greedy
    tokens, reduced scores within the flip tolerance, and an int8 cache
    grown by the quantized tail of each chunk."""
    chunks, (jcache, jlast, tcache, tlast) = _decode_pair(
        "flash", chunks=(5, 3), w8a8=True, kv=kv)
    for jt, js, _, tt, ts, _ in chunks:
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        for f in ("topk_vals", "logz", "target_logits"):
            np.testing.assert_allclose(
                getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                atol=W8A8_ATOL, err_msg=f)
    assert tcache.k.shape == jcache.k.shape == (4, 3, 56, 1, 32)
    assert tcache.k.dtype == (torch.int8 if kv == "int8" else torch.float32)
    if kv == "int8":
        assert tcache.v_scale.shape == (4, 3, 56, 1)
        np.testing.assert_allclose(
            tquant.dequantize_kv(tcache.v, tcache.v_scale).numpy(),
            np.asarray(jquant.dequantize_kv(jcache.v, jcache.v_scale)),
            atol=W8A8_ATOL)
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=W8A8_ATOL)


def test_cache_quantization_must_match_config():
    """Decoding a cache whose storage does not match the config's
    ``kv_cache_dtype`` raises instead of folding a tail of the wrong kind."""
    _, tcfg, _, weights = _models("flash", kv="int8")
    ids, mask = _batch()
    bf16_cfg = tconfig.DecoderConfig(**{**tconfig.FLAGSHIP_SMALL_GEOMETRY,
                                        "attention_impl": "flash"})
    last, cache = tdec.prefill(weights, bf16_cfg, torch.from_numpy(ids).long(),
                               torch.from_numpy(mask), cache_len=48)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tdec.decode_steps(weights, tcfg, cache, last,
                          torch.from_numpy(mask.sum(-1)), 0, 2,
                          with_scores=False)
