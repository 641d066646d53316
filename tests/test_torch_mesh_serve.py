"""Serving, slotted scoring, the KV-slab handoff and the joint K-token decode
of the port on a mesh of gloo ranks, against the JAX engine on the same
meshes of the 8 virtual CPU devices and against the meshless port.

One spawn of 2 ranks (``tests/torch_parallel_ranks.py``, ``serve_two``)
runs, while this process computes the JAX rows:

- ``score_prompts_slotted`` with one admission of 3 rows on dp2 (3 rows to
  start, which the data axis does not divide) and tp2;
- ``export_kv_slab`` on a dp2 engine into ``decode_kv_slabs`` on a tp2 one,
  and, for a model with two K/V heads, from tp2 (which splits them) into
  dp2;
- ``decode_k=4`` with oracle proposals (every block accepted, so the
  tail's gathered slots carry the rows) on dp2 (3 rows) and tp2 (4), beside
  ``decode_k=1``; a K-head distilled on dp2, tp2 and no mesh;
- ``decoder.k_verify_block(tp=)`` on each rank's heads against the whole
  call;
- a pool of two replicas on ``carve_slices(2)`` (one rank each);
- ``serve --replay`` and the JSONL driver through ``__main__`` with
  ``--mesh-model 2``.

Two more spawns: a pool of two dp2 replicas on 4 ranks, and a follower
whose leader's process exits (it must end with an error within the
group's timeout).  The pool's shared placement runs here, on one rank.

Classes (ROADMAP.md): tokens, verdicts, completions and ``scan_found``
identical; probabilities rtol 2e-5 in float32 (``assert_rows``); K=4
against K=1 within |d| <= 2e-6 (``test_torch_kdecode.K_ATOL``).
"""

import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.models import decoder as jdec
from llm_interpretation_replication_tpu.parallel import make_mesh as jmesh
from llm_interpretation_replication_tpu.parallel import \
    shard_params as jshard
from llm_interpretation_replication_tpu.runtime import engine as jengine
from llm_interpretation_replication_tpu_torch.models import config as tconfig

import chip_smoke
from test_torch_kdecode import K_ATOL, _k_rows_equal
from test_torch_mesh import (ECFG, FALCON, POOLED, TOK, assert_rows,
                             falcon)
from test_torch_slots import one_torch_thread  # noqa: F401
from torch_parallel_ranks import (admit_once, np_decoder_params, slab_rows,
                                  spawn)

K_ECFG = dict(ECFG, max_new_tokens=20)
#: the Falcon-shaped case with two K/V heads (tp2 splits them)
GQA = dict(FALCON, hidden_size=48, num_heads=4, num_kv_heads=2)
J_ORACLE = chip_smoke.oracle_engine(jengine, jdec)


def jax_engine(case, shape, cls=jengine.ScoringEngine, **ecfg):
    """The JAX engine of a case on a (data, model) mesh of the virtual
    devices."""
    data, model = shape
    mesh = jmesh(data=data, model=model, devices=jax.devices()[:data * model])
    params = jshard(jax.tree_util.tree_map(jnp.asarray, case["params"]),
                    mesh)
    return cls("falcon", jconfig.DecoderConfig(**case["cfg"]), params, TOK,
               mesh=mesh, engine_config=jengine.EngineConfig(**ecfg))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Rank 0's results of the 2-rank spawn (started before the JAX rows
    are computed), the inputs it ran and its directory."""
    from transformers import FalconConfig, FalconForCausalLM
    import torch

    from helpers import build_test_tokenizer
    from llm_interpretation_replication_tpu_torch.config import \
        legal_scenarios

    tmp = tmp_path_factory.mktemp("serve2")
    snap = tmp / "falcon_snap"
    torch.manual_seed(7)
    FalconForCausalLM(FalconConfig(
        vocab_size=300, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, multi_query=True, parallel_attn=True,
        new_decoder_architecture=False, bias=False, alibi=False)
    ).eval().save_pretrained(str(snap), safe_serialization=True)
    build_test_tokenizer(300).save_pretrained(str(snap))
    perturbations = tmp / "perturbations.json"
    perturbations.write_text(json.dumps([
        dict(s, rephrasings=[f"Variant one of: {s['original_main'][:60]}",
                             f"Variant two: {s['original_main'][20:70]}"])
        for s in legal_scenarios()]))
    requests = tmp / "requests.jsonl"
    requests.write_text("".join(
        json.dumps({"prompt": f"Is item {i} a vehicle? Answer:",
                    "targets": ["Yes", "No"]}) + "\n" for i in range(6)))
    base = ["serve", "--device", "cpu", "--dtype", "float32", "--model",
            str(snap), "--batch-size", "4", "--mesh-model", "2"]
    serve = {"replay": base + ["--replay", str(perturbations)],
             "jsonl": base + ["--input", str(requests), "--output",
                              str(tmp / "answers{rank}.jsonl")]}
    case = falcon()
    gqa = dict(case, cfg=GQA, params=np_decoder_params(
        tconfig.DecoderConfig(**GQA), seed=9, scale=0.2))
    inputs = {"falcon": case, "gqa": gqa, "serve": serve}
    return inputs, tmp, functools.lru_cache(maxsize=None)(
        spawn("serve_two", 2, tmp, inputs))


def test_slotted_scoring_on_two_ranks(two, eight_cpu_devices):
    """Slotted scoring with an admission on dp2 (3 rows to start) and tp2
    gives the JAX engine's rows on the same meshes and the meshless
    port's; the admitted rows come after the first three."""
    inputs, _, results = two
    case = inputs["falcon"]
    refs = {name: jax_engine(case, shape, **POOLED).score_prompts_slotted(
        case["prompts"][:3], case["targets"][:3],
        admit_fn=admit_once(case, 3, 6))
        for name, shape in (("dp2", (2, 1)), ("tp2", (1, 2)))}
    got = results()
    for name in ("dp2", "tp2"):
        assert len(got[f"slotted_{name}"]) == 6
        assert_rows(got[f"slotted_{name}"], refs[name])
        assert_rows(got[f"slotted_{name}"], got["slotted/meshless"])


def test_kv_slab_handoff_across_meshes(two, eight_cpu_devices):
    """A slab exported on dp2 and decoded on tp2 (whole on every rank, the
    importer splitting it over its own axes) gives the JAX handoff's rows
    across the same meshes and the meshless port's."""
    inputs, _, results = two
    case = inputs["falcon"]
    ref, ref_n = slab_rows(jax_engine(case, (2, 1), **POOLED),
                           jax_engine(case, (1, 2), **POOLED), case)
    got = results()
    rows, n = got["slabs"]
    assert n == ref_n > 0
    assert_rows(rows, ref)
    assert_rows(rows, got["slabs/meshless"][0])
    # two K/V heads split over tp2: the export gathers them, the dp2
    # import holds them whole
    rows, n = got["slabs_gqa"]
    assert n == got["slabs_gqa/meshless"][1] > 0
    assert_rows(rows, got["slabs_gqa/meshless"][0])


def test_decode_k_on_two_ranks(two, eight_cpu_devices):
    """``decode_k=4`` with every block accepted, on dp2 (3 rows) and tp2:
    the ``decode_k=1`` rows in the K class, the JAX oracle engine's rows on
    the same meshes, and no block rejected.  A distilled K-head is the same
    on both ranks (digests), on each mesh, and its rows are the K=1 rows."""
    inputs, _, results = two
    case = inputs["falcon"]
    got = results()
    for name, shape, rows in (("dp2", (2, 1), 3), ("tp2", (1, 2), 4)):
        ref = jax_engine(case, shape, J_ORACLE, decode_k=4,
                         **K_ECFG).score_prompts(case["prompts"][:rows],
                                                 case["targets"][:rows])
        _k_rows_equal(got[f"k4_{name}"], got[f"k1_{name}"])
        assert_rows(got[f"k4_{name}"], ref)
        assert got[f"k4_{name}/counters"]["k_blocks_proposed"] > 0
        assert got[f"k4_{name}/counters"]["k_blocks_rejected"] == 0
    assert_rows(got["k4_tp2"], got["k4/meshless"][:4])
    heads = got["heads"]
    same_mesh = {"dp2": got["k1_dp2"], "tp2": got["k1_tp2"],
                 "meshless": got["k4/meshless"]}
    for name in ("dp2", "tp2", "meshless"):
        digests, head = heads[name]
        assert digests[0] == digests[1]
        np.testing.assert_allclose(head, heads["meshless"][1], rtol=1e-3,
                                   atol=1e-4)
        _k_rows_equal(got[f"distilled_{name}"], same_mesh[name][:3],
                      atol=K_ATOL)


def test_k_verify_block_tp_matches_the_whole_call(two):
    """``k_verify_block(tp=)`` on each rank's query heads (3 + 2 of 5; the
    one K/V head whole) gives the whole call's chain, acceptance, tail
    K/V and folded cache, and its logits and hidden state in float32, the
    same on both ranks."""
    _, _, results = two
    got = results()
    whole, tp = got["k_verify_tp"]["whole"], got["k_verify_tp"]["tp"]
    for key in ("tokens", "a_len", "accepted"):
        np.testing.assert_array_equal(tp[key], whole[key])
    assert tp["accepted"].tolist() == [True, True, False]
    assert tp["a_len"].tolist() == [3, 3, 2]
    for key in ("logits", "hidden", "tail", "folded"):
        np.testing.assert_allclose(tp[key], whole[key], rtol=2e-5, atol=1e-5)
    by_rank = got["k_verify_tp/by_rank"]
    assert by_rank[0] == by_rank[1] == whole["tokens"].tolist()


def test_pool_on_rank_slices_of_two(two):
    """A pool of two replicas on ``carve_slices(2)`` of 2 ranks: each rank
    hosts one, both answer, their health reads ``sliced`` on one rank each,
    and the rows are the meshless engine's offline rows."""
    inputs, _, results = two
    case = inputs["falcon"]
    import torch_parallel_ranks as ranks

    offline = ranks._engine(case, **POOLED).score_prompts(
        case["prompts"][:8], case["targets"][:8])
    pool = results()["pool"]
    assert pool["hosted"] == [["r0"], ["r1"]]
    assert_rows(pool["rows"], offline)
    docs = {d["replica"]: d for d in pool["health"]["replicas"]}
    assert [docs[r]["ranks"] for r in ("r0", "r1")] == [[0], [1]]
    assert all(d["placement"] == "sliced" and d["devices"] == 1
               and d["completed"] > 0 for d in docs.values())


def test_serve_on_two_ranks_through_main(two, tmp_path):
    """``serve --mesh-model 2`` under two ranks: the leader prints the
    replay's parity report (no row off the offline path) and writes the
    JSONL answers, which equal a single process's; the follower prints and
    writes nothing, and both exit 0."""
    from llm_interpretation_replication_tpu_torch.__main__ import \
        main as tmain
    from llm_interpretation_replication_tpu_torch.serve import rows_equal

    inputs, tmp, results = two
    printed = results()["serve"]
    for name in ("replay", "jsonl"):
        assert printed[0][name][0] == 0 and printed[1][name][0] == 0
        assert printed[1][name][1] == ""
    report = json.loads(printed[0]["replay"][1])
    assert report["rows"] == 10 and report["mismatched_rows"] == 0
    assert not (tmp / "answers1.jsonl").exists()
    argv = [a for a in inputs["serve"]["jsonl"]
            if a not in ("--mesh-model", "2")]
    argv[argv.index(str(tmp / "answers{rank}.jsonl"))] = str(
        tmp_path / "one.jsonl")
    with pytest.raises(SystemExit) as stop:
        tmain(argv)
    assert stop.value.code == 0
    mesh_lines = (tmp / "answers0.jsonl").read_text().splitlines()
    one_lines = (tmp_path / "one.jsonl").read_text().splitlines()
    assert len(mesh_lines) == len(one_lines) == 6
    for a, b in zip(mesh_lines, one_lines):
        a, b = json.loads(a), json.loads(b)
        assert a["id"] == b["id"] and a["success"] and b["success"]
        assert a["scan_found"] == b["scan_found"]
        np.testing.assert_allclose(a["relative_prob"], b["relative_prob"],
                                   rtol=2e-5)


def test_pool_on_rank_slices_of_four(tmp_path):
    """Two replicas on ``carve_slices(2)`` of 4 ranks, each a dp2 slice led
    by its first rank: ranks 0-1 host r0, ranks 2-3 host r1, both answer,
    and the rows are the meshless engine's."""
    import torch_parallel_ranks as ranks

    case = falcon()
    results = spawn("pool_four", 4, tmp_path, {"falcon": case})
    offline = ranks._engine(case, **POOLED).score_prompts(
        case["prompts"][:8], case["targets"][:8])
    pool = results()
    assert pool["hosted"] == [["r0"], ["r0"], ["r1"], ["r1"]]
    assert_rows(pool["rows"], offline)
    docs = {d["replica"]: d for d in pool["health"]["replicas"]}
    assert [docs[r]["ranks"] for r in ("r0", "r1")] == [[0, 1], [2, 3]]
    assert all(d["placement"] == "sliced" and d["completed"] > 0
               for d in docs.values())


def test_follower_whose_leader_exits_ends_in_an_error(tmp_path):
    """A dp2 scheduler's leader process exits while its follower waits for
    a decision: the follower ends with an error within the group's
    timeout instead of hanging."""
    timeout = 10
    spawn("leader_exits", 2, tmp_path, {"falcon": falcon()},
          timeout=timeout)()
    outcome, seconds = pickle.load(open(tmp_path / "follower.pkl", "rb"))
    assert outcome != "returned"
    assert seconds < timeout + 20


def test_pool_shared_placement_on_one_rank():
    """``devices=`` on one rank (no process group: one card's world) is the
    shared placement: both replicas take the one rank, say so in their
    health, and answer the offline rows."""
    import torch_parallel_ranks as ranks

    from llm_interpretation_replication_tpu_torch.parallel import mesh
    from llm_interpretation_replication_tpu_torch.serve import (
        EnginePool, ScoreRequest)

    case = falcon()
    slices = mesh.carve_slices(2)
    assert slices == ((0,), (0,))
    eng = ranks._engine(case, **POOLED)
    offline = eng.score_prompts(case["prompts"][:4], case["targets"][:4])
    with EnginePool() as pool:
        for sl in slices:
            pool.load("m", ranks._engine(case, **POOLED), devices=sl)
        rows = [pool.submit(ScoreRequest(prompt=p, targets=tuple(t))
                            ).result(timeout=120)
                for p, t in zip(case["prompts"][:4], case["targets"][:4])]
        docs = pool.health()["replicas"]
    assert_rows(rows, offline)
    assert [(d["placement"], d["devices"], d["ranks"]) for d in docs] == [
        ("shared", 1, [0])] * 2
