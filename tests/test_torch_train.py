"""The port's training step (``runtime/train.py``) against the JAX package's,
on the CPU: the optimizer against optax, ``causal_lm_loss`` and its
gradients against ``jax.value_and_grad``, unsharded steps against
``make_train_step(mesh=None)``, and sharded steps on gloo ranks (data=2,
model=2 with uneven and replicated heads, data=2 x model=2) against the
JAX step on the 8-device CPU mesh.  Inputs come from numpy seeds."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_interpretation_replication_tpu.models.config import \
    DecoderConfig as JaxConfig
from llm_interpretation_replication_tpu.parallel import make_mesh as jax_mesh
from llm_interpretation_replication_tpu.parallel import \
    shard_params as jax_shard
from llm_interpretation_replication_tpu.runtime import train as jtrain
from llm_interpretation_replication_tpu_torch.models.config import \
    DecoderConfig
from llm_interpretation_replication_tpu_torch.runtime import train

from test_torch_slots import one_torch_thread  # noqa: F401
from torch_parallel_ranks import np_decoder_params, spawn, to_torch

BASE = dict(vocab_size=96, num_layers=2, intermediate_size=32,
            position_embedding="rotary", max_position_embeddings=64)
CONFIGS = {
    # a gated RMSNorm decoder (LLaMA-shaped), grouped K/V
    "gated": dict(BASE, hidden_size=16, num_heads=4, num_kv_heads=2,
                  norm_type="rmsnorm", qkv_bias=False, out_bias=False,
                  mlp_bias=False, mlp_type="gated", activation="silu"),
    # Falcon-shaped: one K/V head, parallel residual over a shared norm,
    # five heads (an uneven split over two model ranks)
    "falcon": dict(BASE, hidden_size=20, num_heads=5, num_kv_heads=1,
                   parallel_residual=True, shared_layernorm=True,
                   qkv_bias=False, out_bias=False, mlp_bias=False,
                   tie_word_embeddings=True),
    # biases everywhere, three K/V heads for six query heads: the K/V
    # heads are replicated over two model ranks and picked per head
    "biased": dict(BASE, hidden_size=24, num_heads=6, num_kv_heads=3,
                   qkv_bias=True, out_bias=True, mlp_bias=True),
}


def configs(name):
    return JaxConfig(**CONFIGS[name]), DecoderConfig(**CONFIGS[name])


def batch(seed, b=4, s=12, pads=(0, 3, 5, 7)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 96, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for row, pad in enumerate(pads[:b]):
        if pad:
            mask[row, s - pad:] = 0
    return ids, mask


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_tree_close(got, want, leaf_scale=False, **tol):
    """Leaf by leaf; ``leaf_scale`` sets each leaf's atol to its rtol
    times the leaf's largest magnitude."""
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        w = np.asarray(w)
        if leaf_scale:
            tol["atol"] = tol["rtol"] * float(np.abs(w).max())
        np.testing.assert_allclose(np.asarray(flat_got[path]), w,
                                   err_msg=str(path), **tol)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("warmup", [1, 3])
def test_optimizer_matches_optax(clip, warmup):
    """The same gradients through the port's chain and optax's give the
    same updates and parameters for 10 steps (rtol 1e-6), with clipping
    active and not, one warmup step and three; the first update is
    exactly zero (lr 0 at count 0)."""
    rng = np.random.default_rng(warmup + 10 * clip)
    params = {"a": {"w": rng.standard_normal((3, 5)).astype(np.float32)},
              "b": rng.standard_normal(7).astype(np.float32)}
    scale = 3.0 if clip else 0.01
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                          .astype(np.float32), params) for _ in range(10)]
    kw = dict(learning_rate=0.1, warmup_steps=warmup, total_steps=8)
    jopt = jtrain.make_optimizer(**kw)
    jparams = jax_tree(params)
    jstate = jopt.init(jparams)
    opt = train.make_optimizer(**kw)
    tparams = to_torch(params)
    tstate = opt.init(tparams)
    pparams = to_torch(params)
    pstate = opt.init(pparams)
    clipped = []
    for i, g in enumerate(grads):
        jup, jstate = jopt.update(jax_tree(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, jup)
        tup, tstate = opt.update(to_torch(g), tstate, tparams)
        tparams = jax.tree.map(lambda p, u: p + u, tparams, tup)
        pstate = opt.apply_(pparams, to_torch(g), pstate)
        if i == 0:
            assert all(float(u.abs().max()) == 0.0
                       for u in jax.tree.leaves(tup))
        # the two global norms may part in their last bit (float32 sums in
        # other orders), which the moments carry: each leaf is held within
        # 1e-6 of its largest value
        assert_tree_close(jax.tree.map(torch.Tensor.numpy, tup), jup,
                          rtol=1e-6, leaf_scale=True)
        assert_tree_close(jax.tree.map(torch.Tensor.numpy, pparams), jparams,
                          rtol=1e-6, leaf_scale=True)
        clipped.append(float(optax.global_norm(jax_tree(g))) >= 1.0)
    assert tstate.count == pstate.count == 10
    assert all(clipped) if clip else not any(clipped)


def _bf16_leaves(tree):
    return {k: _bf16_leaves(v) if isinstance(v, dict)
            else jnp.asarray(v, jnp.bfloat16) for k, v in tree.items()}


def _torch_bf16(tree):
    return {k: _torch_bf16(v) if isinstance(v, dict)
            else torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
            for k, v in tree.items()}


def _bf16_case(name):
    """(params, [grads a step]) of a bf16 case, as float32 numpy."""
    if name == "one_leaf":
        # the smallest input that showed the float32 norm's departure:
        # a norm of 22.825 in float32 against optax's 22.75 in bf16
        return ({"w": np.ones(2, np.float32)},
                [{"w": np.array([20.0, 11.0], np.float32)}] * 2)
    rng = np.random.default_rng(21)
    shapes = {"a": {"w": (96, 130)}, "b": (4000,), "c": (3312,)}

    def draw(scale):
        def leaf(shape):
            return (rng.standard_normal(shape) * scale).astype(np.float32)
        return {"a": {"w": leaf(shapes["a"]["w"])}, "b": leaf(shapes["b"]),
                "c": leaf(shapes["c"])}

    return draw(1.0), [draw(0.5) for _ in range(8)]


@pytest.mark.parametrize("case", ["one_leaf", "three_leaves"])
def test_optimizer_matches_optax_bf16(case):
    """bf16 leaves: the port's clipped AdamW gives optax's moments and
    parameters bit for bit, every step clipping (the global norm squares,
    sums and roots in bf16 as ``optax.global_norm`` does)."""
    params, grads = _bf16_case(case)
    kw = dict(learning_rate=0.1, warmup_steps=1, total_steps=8)
    jopt = jtrain.make_optimizer(**kw)
    jparams = _bf16_leaves(params)
    jstate = jopt.init(jparams)
    opt = train.make_optimizer(**kw)
    tparams = _torch_bf16(params)
    tstate = opt.init(tparams)
    for g in grads:
        jg = _bf16_leaves(g)
        tg = _torch_bf16(g)
        want_norm = optax.global_norm(jg)
        got_norm = train.grad_norm(tg)
        assert got_norm.dtype == torch.bfloat16
        assert float(got_norm) == float(want_norm)
        assert float(want_norm) >= 1.0            # the step clips
        jup, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, jup)
        tstate = opt.apply_(tparams, tg, tstate)
        for path, want in jax.tree_util.tree_leaves_with_path(jparams):
            got = tparams
            for key in path:
                got = got[key.key]
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want, np.float32),
                err_msg=str(path))
    mu = jstate[1][0].mu            # clip, (adamw's ScaleByAdamState, ...)
    for path, want in jax.tree_util.tree_leaves_with_path(mu):
        got = tstate.mu
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_schedule_is_optax_warmup_cosine():
    for warmup, total in ((1, 10), (3, 8), (5, 6)):
        want = optax.warmup_cosine_decay_schedule(0.0, 1e-4, warmup, total)
        got = train.warmup_cosine_decay_schedule(0.0, 1e-4, warmup, total)
        for count in range(12):
            np.testing.assert_allclose(float(got(count)), float(want(count)),
                                       rtol=1e-6, atol=0)
    assert float(train.make_optimizer(1e-4, warmup_steps=1,
                                      total_steps=10).schedule(0)) == 0.0


# ---------------------------------------------------------------------------
# the loss, its gradients, unsharded steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gated", "falcon"])
def test_loss_and_gradients_match_jax(name):
    """``causal_lm_loss`` and its gradients in float32 against
    ``jax.value_and_grad`` of the reference's (loss rtol 1e-6, gradients
    atol 1e-6), with right padding of different lengths."""
    jcfg, tcfg = configs(name)
    params = np_decoder_params(jcfg, seed=1)
    ids, mask = batch(2)
    jloss, jgrads = jax.value_and_grad(jtrain.causal_lm_loss)(
        jax_tree(params), jcfg, jnp.asarray(ids), jnp.asarray(mask))
    opt = train.make_optimizer()
    state = train.init_train_state(to_torch(params), opt)
    loss, grads = train.loss_and_grads(state.params, tcfg,
                                       torch.from_numpy(ids).long(),
                                       torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert_tree_close(jax.tree.map(torch.Tensor.numpy, grads), jgrads,
                      atol=1e-6, rtol=0)
    again = train.causal_lm_loss(state.params, tcfg,
                                 torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask))
    assert float(again.detach()) == float(loss)


@pytest.mark.parametrize("name", ["gated", "falcon"])
def test_unsharded_steps_match_jax(name):
    """Five steps of the port's step against ``make_train_step(mesh=None)``
    (losses rtol 1e-4); the parameters after them agree too."""
    jcfg, tcfg = configs(name)
    params = np_decoder_params(jcfg, seed=3)
    ids, mask = batch(4)
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=20)
    jopt = jtrain.make_optimizer(**kw)
    jstate = jtrain.init_train_state(jax_tree(params), jopt)
    jstep = jtrain.make_train_step(jcfg, jopt, mesh=None, donate=False)
    opt = train.make_optimizer(**kw)
    state = train.init_train_state(to_torch(params), opt)
    step = train.make_train_step(tcfg, opt)
    seen = []
    for _ in range(5):
        jstate, jloss = jstep(jstate, jnp.asarray(ids), jnp.asarray(mask))
        state, loss = step(state, torch.from_numpy(ids).long(),
                           torch.from_numpy(mask),
                           on_grads=lambda g, n: seen.append(float(n)))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert state.step == 5 and len(seen) == 5 and all(n > 0 for n in seen)
    assert_tree_close(jax.tree.map(lambda t: t.detach().numpy(), state.params),
                      jstate.params, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# sharded steps on gloo ranks
# ---------------------------------------------------------------------------

STEPS = 3
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=20)


def _case(name, mesh, seed, pads):
    jcfg, _ = configs(name)
    ids, mask = batch(seed, pads=pads)
    return dict(cfg=CONFIGS[name], params=np_decoder_params(jcfg, seed),
                ids=ids, mask=mask, mesh=mesh, opt=OPT, steps=STEPS)


def _jax_reference(case):
    """The JAX package's sharded step on a mesh of the case's shape over the
    virtual CPU devices: step-1 loss and gradients, the steps' losses, the
    parameters after them."""
    jcfg = JaxConfig(**case["cfg"])
    shape = case["mesh"]
    mesh = jax_mesh(data=shape.get("data", 1), model=shape.get("model", 1),
                    devices=jax.devices()[:shape.get("data", 1)
                                          * shape.get("model", 1)])
    params = jax_shard(jax_tree(case["params"]), mesh)
    ids, mask = jnp.asarray(case["ids"]), jnp.asarray(case["mask"])
    loss, grads = jax.value_and_grad(jtrain.causal_lm_loss)(
        params, jcfg, ids, mask, mesh)
    opt = jtrain.make_optimizer(**case["opt"])
    state = jtrain.init_train_state(params, opt)
    step = jtrain.make_train_step(jcfg, opt, mesh=mesh, donate=False)
    losses = []
    for _ in range(case["steps"]):
        state, step_loss = step(state, ids, mask)
        losses.append(float(step_loss))
    return dict(loss=float(loss), grads=grads, losses=losses,
                params=state.params,
                norm=float(optax.global_norm(grads)))


def _check_case(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-5)
    assert_tree_close(got["grads"], want["grads"], atol=1e-6, rtol=0)
    assert_tree_close(got["params"], want["params"], rtol=1e-4, atol=1e-5)


def test_sharded_steps_on_two_ranks(tmp_path):
    """On two gloo ranks: data=2 with padding uneven across the shards (the
    loss is the global weighted mean, not the mean of the ranks' means),
    and model=2 with five heads (36 + 35 style: 3 + 2) and one replicated
    K/V head, and with three K/V heads replicated for six query heads."""
    cases = {
        "data2": _case("gated", dict(data=2), 5, pads=(0, 0, 6, 9)),
        "model2_falcon": _case("falcon", dict(model=2), 6, (0, 2, 0, 4)),
        "model2_biased": _case("biased", dict(model=2), 7, (1, 0, 3, 0)),
    }
    results = spawn("train", 2, tmp_path, cases)
    want = {name: _jax_reference(case) for name, case in cases.items()}
    got = results()
    for name in cases:
        _check_case(got[name], want[name])
    # the mean of the two data ranks' own means is another number
    jcfg = JaxConfig(**cases["data2"]["cfg"])
    halves = [float(jtrain.causal_lm_loss(
        jax_tree(cases["data2"]["params"]), jcfg,
        jnp.asarray(cases["data2"]["ids"][rows]),
        jnp.asarray(cases["data2"]["mask"][rows])))
        for rows in (slice(0, 2), slice(2, 4))]
    assert abs(got["data2"]["loss"] - np.mean(halves)) > 1e-3


def test_sharded_steps_on_four_ranks(tmp_path):
    """data=2 x model=2 on four gloo ranks, grouped K/V split over the model
    axis and Falcon's replicated one."""
    cases = {
        "data2_model2": _case("gated", dict(data=2, model=2), 8,
                              pads=(0, 5, 2, 0)),
        "data2_model2_falcon": _case("falcon", dict(data=2, model=2), 9,
                                     pads=(3, 0, 0, 7)),
    }
    results = spawn("train", 4, tmp_path, cases)
    want = {name: _jax_reference(case) for name, case in cases.items()}
    got = results()
    for name in cases:
        _check_case(got[name], want[name])


# ---------------------------------------------------------------------------
# the kernel guard
# ---------------------------------------------------------------------------

ATTN = importlib.import_module(
    "llm_interpretation_replication_tpu_torch.ops.attention")


@pytest.mark.parametrize("wrapper,shape_q,shape_kv", [
    ("causal_grouped_attention", (1, 8, 4, 16), (1, 8, 2, 16)),
    ("grouped_attention", (1, 4, 8, 16), (1, 2, 8, 16)),
    ("flash_attention", (1, 4, 8, 16), (1, 4, 8, 16))])
def test_kernel_guard_raises_under_grad(wrapper, shape_q, shape_kv,
                                        monkeypatch):
    """With the device check patched to take the kernel route on the CPU,
    a kernel wrapper refuses an input that requires grad before any launch
    (nothing launches on the CPU); under no_grad it goes on to the launch,
    which refuses a CPU tensor."""
    monkeypatch.setattr(ATTN, "_on_kernel_device", lambda q: True)
    fn = getattr(ATTN, wrapper)
    q = torch.randn(shape_q, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(shape_kv, dtype=torch.bfloat16)
    v = torch.randn(shape_kv, dtype=torch.bfloat16)
    lengths = torch.full((1,), 8, dtype=torch.int32)
    before = fn.launches
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        fn(q, k, v, lengths)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel for"):
        fn(q, k, v, lengths)
    assert fn.launches == before


def test_training_a_kernel_route_raises(monkeypatch):
    """A loss through ``attention_impl='flash'`` under grad reaches the
    causal kernel's guard; the plain route trains."""
    jcfg, tcfg = configs("falcon")
    tcfg = dataclasses.replace(tcfg, attention_impl="flash")
    params = to_torch(np_decoder_params(jcfg, seed=0))
    state = train.init_train_state(params, train.make_optimizer())
    ids, mask = batch(0)
    args = (state.params, tcfg, torch.from_numpy(ids).long(),
            torch.from_numpy(mask))
    assert torch.isfinite(train.causal_lm_loss(*args))   # CPU: plain version
    monkeypatch.setattr(ATTN, "_on_kernel_device", lambda q: True)
    with pytest.raises(NotImplementedError, match="attention_impl='xla'"):
        train.causal_lm_loss(*args)
