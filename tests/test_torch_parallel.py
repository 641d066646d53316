"""The port's parallel package (``parallel/``) against the JAX package's, on
the CPU: mesh shapes and slices, the sharding specs, the head-boundary
split, and -- on four gloo ranks, one spawn -- meshes over ranks, ring and
Ulysses attention (seq 4, seq 2 beside data or model), ``pipeline_apply``
with its gradient and ``pipeline_decoder_forward`` at pipe 2 x model 2,
each held to the JAX package's sharded functions on the 8-device CPU
mesh.  Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_interpretation_replication_tpu.models import decoder as jdec
from llm_interpretation_replication_tpu.models.config import \
    DecoderConfig as JaxConfig
from llm_interpretation_replication_tpu.parallel import mesh as jmesh
from llm_interpretation_replication_tpu.parallel import sharding as jsharding
from llm_interpretation_replication_tpu.parallel import (
    pipeline_apply as jax_pipeline_apply, ring_attention_sharded as jax_ring,
    ulysses_attention_sharded as jax_ulysses)
from llm_interpretation_replication_tpu_torch.config import RunConfig
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.parallel import (
    activation_spec, batch_spec, data_sharded, initialize_distributed,
    make_mesh, param_specs, replicated, split_stage_params)
from llm_interpretation_replication_tpu_torch.parallel import mesh as tmesh
from llm_interpretation_replication_tpu_torch.parallel import sharding, \
    tensor_parallel

from test_torch_slots import one_torch_thread  # noqa: F401
from torch_parallel_ranks import np_decoder_params, spawn

MESH_KWARGS = [dict(model=2, seq=2), dict(), dict(pipe=4, model=2),
               dict(model=4), dict(data=2, model=2, seq=2), dict(pipe=8),
               dict(data=3, model=2, seq=2), dict(model=3), dict(data=16),
               dict(data=1, pipe=2, model=2, seq=2)]


def _jax_outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("kw", MESH_KWARGS)
def test_mesh_shape_matches_jax(kw, eight_cpu_devices):
    """The shape ``make_mesh`` builds over 8 ranks, or its ValueError, is
    the JAX package's over 8 devices."""
    def want():
        m = jmesh.make_mesh(**kw)
        return tuple(m.shape[a] for a in tmesh.AXES)
    got = _jax_outcome(lambda: tmesh.mesh_shape(8, **kw))
    assert got == _jax_outcome(want)
    if isinstance(got, str):       # make_mesh raises it before any group
        with pytest.raises(ValueError, match="devices"):
            make_mesh(devices=range(8), **kw)


def test_shape_arithmetic_and_placements_match_jax():
    for n in (1, 6, 8, 12):
        for m, s in ((1, 1), (4, 1), (16, 2), (3, 3)):
            assert tmesh.mesh_shape_for(n, m, s) == \
                jmesh.mesh_shape_for(n, m, s)
        assert tmesh.enumerate_mesh_shapes(n, max_pipe=4) == \
            jmesh.enumerate_mesh_shapes(n, max_pipe=4)
    assert tmesh.AXES == (jmesh.DATA_AXIS, jmesh.PIPE_AXIS, jmesh.MODEL_AXIS,
                          jmesh.SEQ_AXIS)
    assert replicated(None).spec == () == tuple(jsharding.P())
    assert data_sharded(None, 3).spec == ("data", None, None)
    assert batch_spec() == tuple(jsharding.batch_spec())
    for seq in (True, False):
        assert activation_spec(seq) == tuple(jsharding.activation_spec(seq))


CARVE_CASES = [dict(n_slices=4), dict(n_slices=2), dict(counts=(4, 2, 2)),
               dict(n_slices=3), dict(counts=(4, 4), n_slices=3),
               dict(counts=(3, 0)), dict(n_slices=0), dict(counts=(5, 2)),
               dict(n_slices=16), dict(counts=(1,) * 9),
               dict(n_slices=2, subset=(1, 3, 5, 6))]


@pytest.mark.parametrize("kw", CARVE_CASES)
def test_carve_slices_matches_jax(kw, eight_cpu_devices):
    """Slices over ranks are the JAX package's slices over device ids,
    the shared case (fewer ranks than slices) and the errors included."""
    kw = dict(kw)
    subset = kw.pop("subset", tuple(range(8)))
    devices = [eight_cpu_devices[i] for i in subset]
    want = _jax_outcome(lambda: tuple(
        tuple(d.id for d in s) for s in jmesh.carve_slices(devices=devices,
                                                           **kw)))
    assert _jax_outcome(lambda: tmesh.carve_slices(devices=subset, **kw)) \
        == want


def test_no_world_initializes_nothing(monkeypatch):
    """Without an address, a rendezvous or a world, initialize_distributed
    does nothing and says so; a mesh then needs a group."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed(num_processes=1, device="cpu") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        RunConfig(mesh_model=2).make_mesh()
    assert tmesh.carve_slices(2) == ((0,), (0,))


def _spec_leaves(table):
    return jax.tree.map(lambda _: 0, table,
                        is_leaf=lambda x: isinstance(x, jsharding.P))


@pytest.mark.parametrize("kind", ["decoder", "t5"])
def test_param_specs_match_jax(kind):
    """Every leaf of the reference's spec table, plus one it does not
    know (replicated), gets the JAX package's spec as a tuple."""
    table = (jsharding._decoder_param_specs() if kind == "decoder"
             else jsharding._t5_param_specs())
    params = dict(_spec_leaves(table), unknown_extra={"leaf": 0})
    want = jax.tree.map(tuple, jsharding.param_specs(params, kind),
                        is_leaf=lambda x: isinstance(x, jsharding.P))
    got = param_specs(params, kind)
    assert got == want
    assert got["unknown_extra"]["leaf"] == ()


def test_head_boundary_split_of_falcon_7b():
    """Falcon-7B's 71 heads at two model ranks are 36 + 35, its one K/V
    head is held whole (its gradient reduced over the axis), the MLP and
    the vocab split in halves; the leaf cuts follow the heads."""
    cfg = tconfig.DecoderConfig(**tconfig.FALCON_7B_GEOMETRY)
    shares = [tensor_parallel.for_config(cfg, None, r, 2) for r in (0, 1)]
    assert [s.heads for s in shares] == [(0, 36), (36, 35)]
    assert all(s.kv_replicated and s.kv_heads == (0, 1) for s in shares)
    assert [s.vocab for s in shares] == [(0, 32512), (32512, 32512)]
    assert [s.ffn for s in shares] == [(0, 9088), (9088, 9088)]
    assert tensor_parallel.for_config(cfg, None, 0, 1) is None
    L, H = cfg.num_layers, cfg.hidden_size
    split = sharding.leaf_split
    assert split(("layers", "attn", "wq"), (None, None, "model"),
                 (L, H, 71 * 64), cfg, 2) == (2, 71, 64)
    assert split(("layers", "attn", "wk"), (None, None, "model"),
                 (L, H, 64), cfg, 2) is None
    assert split(("layers", "attn", "wo"), (None, "model", None),
                 (L, 71 * 64, H), cfg, 2) == (1, 71, 64)
    assert split(("layers", "mlp", "wo"), (None, "model", None),
                 (L, 4 * H, H), cfg, 2) == (1, 4 * H, 1)
    assert split(("embed", "tokens"), ("model", None),
                 (65024, H), cfg, 2) == (0, 65024, 1)
    assert tensor_parallel.split_sizes(71, 2) == [36, 35]


def test_split_stage_params():
    tree = {"w": torch.zeros(8, 3, 5), "b": torch.zeros(8, 5)}
    staged = split_stage_params(tree, 4)
    assert staged["w"].shape == (4, 2, 3, 5)
    assert staged["b"].shape == (4, 2, 5)
    with pytest.raises(ValueError, match="not divisible"):
        split_stage_params({"w": torch.zeros(6, 2)}, 4)


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

DECODER = dict(vocab_size=96, hidden_size=16, num_layers=4, num_heads=4,
               intermediate_size=32, position_embedding="rotary",
               tie_word_embeddings=True, max_position_embeddings=32)
FALCON = dict(vocab_size=96, hidden_size=20, num_layers=4, num_heads=5,
              num_kv_heads=1, intermediate_size=40, parallel_residual=True,
              shared_layernorm=True, qkv_bias=False, out_bias=False,
              mlp_bias=False, tie_word_embeddings=True,
              max_position_embeddings=32)
ATTENTION = {   # name: (strategy, mesh, causal)
    "ring_seq4_causal": ("ring", dict(seq=4), True),
    "ring_seq4": ("ring", dict(seq=4), False),
    "ulysses_seq4_causal": ("ulysses", dict(seq=4), True),
    "ulysses_seq4": ("ulysses", dict(seq=4), False),
    "ring_data2_seq2": ("ring", dict(data=2, seq=2), True),
    "ulysses_data2_seq2": ("ulysses", dict(data=2, seq=2), False),
    "ring_model2_seq2": ("ring", dict(model=2, seq=2), True),
    "ulysses_model2_seq2": ("ulysses", dict(model=2, seq=2), True),
}


def _qkv_mask(seed, b=4, s=16, n=4, d=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, n, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, s), bool)
    mask[1, 11:] = False
    mask[2] = False                 # a row with no valid key anywhere
    mask[3, 5:] = False
    return q, k, v, mask


def _decoder_inputs():
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 96, (4, 12)).astype(np.int64)
    ragged = np.ones((4, 12), np.int64)
    ragged[1, 9:] = 0
    ragged[3, 5:] = 0
    short = np.ones((4, 12), np.int64)
    short[2, 7:] = 0
    decoders = {
        "dense": (DECODER, np_decoder_params(JaxConfig(**DECODER), 1), ragged),
        "flash": (dict(DECODER, attention_impl="flash"),
                  np_decoder_params(JaxConfig(**DECODER), 1), short),
        "falcon": (FALCON, np_decoder_params(JaxConfig(**FALCON), 4), ragged),
    }
    return ids, decoders


def _jax_mesh(**kw):
    return jmesh.make_mesh(devices=jax.devices()[:4], **kw)


def _jax_references(inputs):
    want = {}
    with jax.default_matmul_precision("highest"):
        for name, (fn, kw, arrays, causal) in inputs["attention"].items():
            run = jax_ring if fn == "ring" else jax_ulysses
            want[name] = np.asarray(run(_jax_mesh(**kw),
                                        *map(jnp.asarray, arrays),
                                        causal=causal))
        q, k, v, mask = map(jnp.asarray, inputs["indivisible"])
        try:
            jax_ulysses(_jax_mesh(seq=4), q, k, v, mask)
        except ValueError as e:
            want["indivisible_heads"] = str(e)
        pipe4 = _jax_mesh(pipe=4)
        scales = jnp.asarray(inputs["affine_scales"])
        want["affine"] = np.asarray(jax_pipeline_apply(
            lambda p, x: x * p[0] + 1.0, scales,
            jnp.asarray(inputs["affine_xs"]), pipe4))
        want["single"] = np.asarray(jax_pipeline_apply(
            lambda p, x: x * p[0], jnp.ones((4, 1)) * 1.5,
            jnp.ones((1, 2, 3)), pipe4))
        xs = jnp.asarray(inputs["grad_xs"])

        def loss(p):
            return jax_pipeline_apply(lambda sp, x: x * sp[0], p, xs,
                                      pipe4).sum()

        scales = jnp.asarray([[1.0], [2.0], [3.0], [4.0]])
        want["loss"], want["grad"] = map(
            np.asarray, jax.value_and_grad(loss)(scales))
        for name, (kw, params, mask) in inputs["decoders"].items():
            want[name] = np.asarray(jdec.forward(
                jax.tree.map(jnp.asarray, params), JaxConfig(**kw),
                jnp.asarray(inputs["ids"], jnp.int32),
                jnp.asarray(mask, jnp.int32)))
    return want


def test_meshes_attention_and_pipeline_on_four_ranks(tmp_path,
                                                     eight_cpu_devices):
    """On four gloo ranks: meshes over ranks (shapes, axis groups, a subset,
    ``RunConfig.make_mesh``, slices), ring and Ulysses attention against
    the JAX package's sharded functions (atol 1e-5; causal and not, a
    padded row, a row with no valid key, seq 4 and seq 2 beside data or
    model; indivisible heads raise its ValueError; the ring refuses a
    gradient), ``pipeline_apply`` at pipe 4 with its gradient (through
    ``backward`` and ``autograd.grad``), and ``pipeline_decoder_forward``
    at pipe 2 x model 2 against ``decoder.forward`` (atol 2e-4, rtol 1e-4;
    the kernel route's plain version on the valid positions) with its
    microbatch error."""
    rng = np.random.default_rng(0)
    ids, decoders = _decoder_inputs()
    inputs = dict(
        attention={name: (fn, kw, _qkv_mask(i), causal) for i, (
            name, (fn, kw, causal)) in enumerate(ATTENTION.items())},
        indivisible=_qkv_mask(9, n=6),
        affine_scales=(rng.standard_normal((4, 1)) + 2.0).astype(np.float32),
        affine_xs=rng.standard_normal((3, 4, 6)).astype(np.float32),
        grad_xs=rng.standard_normal((2, 2, 5)).astype(np.float32),
        ids=ids, decoders=decoders)
    results = spawn("parallel", 4, tmp_path, inputs)
    want = _jax_references(inputs)
    got = results()

    shapes = {name: tuple(_jax_mesh(**kw).shape[a] for a in tmesh.AXES)
              for name, kw in (("model2", dict(model=2)),
                               ("pipe4", dict(pipe=4)),
                               ("model2_seq2", dict(model=2, seq=2)))}
    shapes["subset"] = tuple(jmesh.make_mesh(
        model=2, devices=jax.devices()[:2]).shape[a] for a in tmesh.AXES)
    for name, shape in shapes.items():
        assert got[name]["shape"] == shape, name
        assert got[name]["names"] == tmesh.AXES
        assert got[name]["device_type"] == "cpu"
    assert got["model2"]["model_group"] == [0, 1]
    assert got["model2_seq2"]["model_group"] == [0, 2]
    assert got["subset"]["model_group"] == [0, 1]
    assert got["data3"] == "mesh 3×1×1×1 != 4 devices"
    assert got["run_config"] == (2, 1, 2, 1)
    assert got["again"] is True
    assert got["carve2"] == ((0, 1), (2, 3))
    assert got["carve_counts"] == ((0, 1, 2), (3,))

    for name in ATTENTION:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=0,
                                   err_msg=name)
        assert not got[name][2].any(), name         # no valid key: zeros
    assert got["indivisible"] == want["indivisible_heads"] \
        == "num_heads 6 not divisible by seq axis 4"
    assert "forward-only" in got["ring_grad"]

    np.testing.assert_allclose(got["affine"], want["affine"], rtol=1e-5)
    np.testing.assert_allclose(got["single"], want["single"], rtol=1e-5)
    np.testing.assert_allclose(got["single"], 1.5 ** 4, rtol=1e-5)
    for how in ("backward", "autograd_grad"):
        np.testing.assert_allclose(got[f"loss_{how}"], want["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got[f"grad_{how}"], want["grad"],
                                   rtol=1e-5)
    for name, (_, _, mask) in decoders.items():
        rows = mask.astype(bool) if name == "flash" else slice(None)
        np.testing.assert_allclose(got[name][rows], want[name][rows],
                                   atol=2e-4, rtol=1e-4, err_msg=name)
    assert got["pipeline_indivisible"] == \
        "batch 3 not divisible into 2 microbatches"
