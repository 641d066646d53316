"""The port's ``ops/moe.py`` against the JAX package's, function by
function, on the same numpy inputs.

- ``_dispatch_tensors``: exactly, ties and capacity overflow included;
- ``route`` (its top-k order on ties included), ``routing_stats``,
  ``aux_loss_from_stats``, ``load_balancing_loss`` and ``moe_mlp_dense``:
  within float32 tolerance, ``RTOL``/``ATOL``;
- ``moe_mlp_sharded`` on 2 and 4 gloo ranks (``tests/torch_parallel_ranks.py``)
  against the JAX ``moe_mlp_sharded`` on a 2- and a 4-device CPU mesh, and
  against the dense path where no token overflowed an expert's capacity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_interpretation_replication_tpu.ops import moe as jmoe
from llm_interpretation_replication_tpu.parallel import make_mesh as jmesh
from llm_interpretation_replication_tpu_torch.models.convert import \
    moe_params_from_jax
from llm_interpretation_replication_tpu_torch.ops import moe as tmoe

from torch_parallel_ranks import spawn

#: float32 class of the MoE ops (products over H=32, F=48 of values up to
#: ~5: the reference's and the port's reduction orders part by ~1e-6)
RTOL, ATOL = 2e-5, 1e-5
H, F, E = 32, 48, 8


def np_params(seed, hidden=H, ffn=F, experts=E, scale=0.3):
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((hidden, experts))
                       * scale).astype(np.float32),
            "wi": (rng.standard_normal((experts, hidden, ffn))
                   * scale).astype(np.float32),
            "wo": (rng.standard_normal((experts, ffn, hidden))
                   * scale).astype(np.float32)}


def np_tokens(seed, t, hidden=H):
    return np.random.default_rng(seed).standard_normal(
        (t, hidden)).astype(np.float32)


def tparams(p):
    return moe_params_from_jax(p, device="cpu")


def jparams(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("top_k,renormalize", [(1, True), (2, True),
                                               (2, False), (3, True)])
def test_route_matches_reference(top_k, renormalize):
    p, x = np_params(0), np_tokens(1, 24)
    tg, ti, tp = tmoe.route(tparams(p), torch.from_numpy(x), top_k,
                            renormalize)
    jg, ji, jp = jmoe.route(jparams(p), jnp.asarray(x), top_k, renormalize)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    close(tg, jg)
    close(tp, jp)


def test_route_breaks_ties_as_lax_top_k():
    """Equal probabilities: the lower expert index first, as ``lax.top_k``.
    A zero router gives every expert the same probability; a router with
    repeated columns gives pairs of equal ones."""
    x = np_tokens(2, 6)
    zero = {"router": np.zeros((H, E), np.float32)}
    base = np_params(3)["router"][:, :4]
    paired = {"router": np.concatenate([base, base], axis=1)}
    for p in (zero, paired):
        for k in (1, 2, 5):
            ti = tmoe.route(tparams(dict(np_params(0), **p)),
                            torch.from_numpy(x), k)[1]
            ji = jmoe.route(jparams(p), jnp.asarray(x), k)[1]
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ti = tmoe.route(tparams(dict(np_params(0), **zero)),
                    torch.from_numpy(x), 3)[1]
    assert ti.tolist() == [[0, 1, 2]] * 6


def test_stats_and_losses_match_reference():
    p, x = np_params(4), np_tokens(5, 40)
    _, ti, tp = tmoe.route(tparams(p), torch.from_numpy(x), 2)
    _, ji, jp = jmoe.route(jparams(p), jnp.asarray(x), 2)
    tf, tm = tmoe.routing_stats(tp, ti, E)
    jf, jm = jmoe.routing_stats(jp, ji, E)
    close(tf, jf)
    close(tm, jm)
    close(tmoe.aux_loss_from_stats(tf, tm, E),
          jmoe.aux_loss_from_stats(jf, jm, E))
    close(tmoe.load_balancing_loss(tp, ti, E),
          jmoe.load_balancing_loss(jp, ji, E))


@pytest.mark.parametrize("top_k", [1, 2])
def test_dense_matches_reference(top_k):
    p, x = np_params(6), np_tokens(7, 20)
    ty, taux = tmoe.moe_mlp_dense(tparams(p), torch.from_numpy(x), top_k)
    jy, jaux = jmoe.moe_mlp_dense(jparams(p), jnp.asarray(x), top_k)
    assert ty.dtype == torch.float32 and ty.shape == (20, H)
    close(ty, jy)
    close(taux, jaux)


def _routing_with_ties(t, k, experts, seed):
    """gates [T, K] and indices [T, K]: random draws with runs of equal
    gates and many tokens on a few experts (so that capacity overflows)."""
    rng = np.random.default_rng(seed)
    indices = np.stack([rng.choice(experts, k, replace=False,
                                   p=np.r_[[0.4, 0.3],
                                           [0.3 / (experts - 2)]
                                           * (experts - 2)])
                        for _ in range(t)]).astype(np.int32)
    gates = rng.choice([0.25, 0.5, 0.125], (t, k)).astype(np.float32)
    return gates, indices


@pytest.mark.parametrize("t,k,capacity", [(12, 2, 2), (12, 2, 6), (9, 3, 1),
                                          (16, 1, 4), (5, 2, 10)])
def test_dispatch_tensors_exactly(t, k, capacity):
    gates, indices = _routing_with_ties(t, k, E, seed=t * 10 + capacity)
    td, tc = tmoe._dispatch_tensors(torch.from_numpy(gates),
                                    torch.from_numpy(indices), E, capacity)
    jd, jc = jmoe._dispatch_tensors(jnp.asarray(gates), jnp.asarray(indices),
                                    E, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # every kept choice has one slot, never past the capacity
    assert td.sum(dim=(1, 2)).max() <= k
    assert td.sum(dim=0).max() <= 1


def test_init_moe_params_shapes_and_seed():
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe_params(g, H, F, E, dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (H, E), "wi": (E, H, F), "wo": (E, F, H)}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    again = tmoe.init_moe_params(torch.Generator().manual_seed(0), H, F, E,
                                 dtype=torch.bfloat16)
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert 0.015 < float(p["wi"].float().std()) < 0.025


#: name -> (tokens, top_k, capacity_factor); "overflow" drops choices
SHARDED = {"k2": (32, 2, 2.0), "k1": (24, 1, 4.0), "overflow": (32, 2, 0.5)}


def _overflowed(case, world) -> bool:
    """Whether any token's choice found its expert's capacity full on its
    shard (``world`` token blocks)."""
    x, t = case["x"], case["x"].shape[0] // world
    cap = max(1, int(case["capacity_factor"] * case["top_k"] * t / E))
    for r in range(world):
        gates, idx, _ = tmoe.route(tparams(case["params"]),
                                   torch.from_numpy(x[r * t:(r + 1) * t]),
                                   case["top_k"])
        dispatch, _ = tmoe._dispatch_tensors(gates, idx, E, cap)
        if int(dispatch.sum()) < t * case["top_k"]:
            return True
    return False


def _cases(world):
    return {name: dict(params=np_params(10 + i), x=np_tokens(20 + i, t),
                       top_k=k, capacity_factor=cf)
            for i, (name, (t, k, cf)) in enumerate(SHARDED.items())}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_matches_reference_on_ranks(world, tmp_path,
                                            eight_cpu_devices):
    """On ``world`` gloo ranks the port's expert-parallel MoE gives the JAX
    one's on a ``world``-device CPU mesh: the tokens within float32
    tolerance, the aux loss too; where no choice overflowed, both equal
    the dense path."""
    results = spawn("moe_sharded", world, tmp_path,
                    {"cases": _cases(world)})
    mesh = jmesh(data=world, devices=jax.devices()[:world])
    refs = {}
    for name, case in _cases(world).items():
        refs[name] = jmoe.moe_mlp_sharded(
            jparams(case["params"]), jnp.asarray(case["x"]), mesh,
            top_k=case["top_k"], capacity_factor=case["capacity_factor"])
    got = results()
    dropped = {name: _overflowed(case, world)
               for name, case in _cases(world).items()}
    assert dropped["overflow"] and not all(dropped.values())
    for name, case in _cases(world).items():
        y, aux = got[name]
        close(y, refs[name][0])
        close(aux, refs[name][1])
        dense_y, dense_aux = tmoe.moe_mlp_dense(
            tparams(case["params"]), torch.from_numpy(case["x"]),
            case["top_k"])
        close(aux, dense_aux)
        if dropped[name]:
            # dropped choices: the sharded rows part from the dense ones
            assert not np.allclose(y, dense_y.numpy(), rtol=RTOL, atol=ATOL)
        else:
            close(y, dense_y)


def test_sharded_refuses_an_indivisible_split():
    """Experts or tokens the axis does not divide raise, as the
    reference's shard_map does (checked without ranks: one rank divides
    everything, so a mesh of 3 data ranks is faked by its axis size)."""
    import types

    from llm_interpretation_replication_tpu_torch.parallel import mesh

    fake = types.SimpleNamespace(size=lambda i=None: 3)
    assert mesh.axis_size(fake, "data") == 3
    p = tparams(np_params(0))
    with pytest.raises(ValueError, match="experts not divisible"):
        tmoe.moe_mlp_sharded(p, torch.zeros(6, H), fake)
