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
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.models import decoder as tdec

ATOL = 2e-5
RTOL_SCORES, ATOL_SCORES = 2e-5, 2e-6


def _models(impl):
    jcfg = jconfig.DecoderConfig(**{**jconfig.FLAGSHIP_SMALL_GEOMETRY,
                                    "attention_impl": impl})
    tcfg = tconfig.DecoderConfig(**{**tconfig.FLAGSHIP_SMALL_GEOMETRY,
                                    "attention_impl": impl})
    params = random_decoder_params(jcfg, seed=3)
    weights = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu",
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


def _decode_pair(impl, eos=None, with_scores="reduced", chunks=(5,)):
    """Prefill, then decode ``chunks`` in sequence on both packages."""
    jcfg, tcfg, params, weights = _models(impl)
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
