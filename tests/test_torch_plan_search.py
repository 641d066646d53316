"""The port's plan search (``runtime/plan_search.py``,
``parallel/mesh.py``) against the JAX package's, and its own coefficients.

With the reference's coefficients set into the port's ``plan`` and
``plan_search`` modules (``test_torch_plan.set_reference_plan``), the
ranked candidates give ``plan_search_record``s equal record for record and
``format_candidate_table`` equal text for the full-study, binary and packed
workloads, both quants and 1, 4 and 8 devices; ``replica_plan`` (every
role), ``chosen_plan``, the rate model, the mesh arithmetic and the dryrun's
prediction comparison equal too.  With the port's own coefficients every
``# anchor:`` value is pinned to what ``scripts/calibrate_plan_torch.py``
measured on the card.  The reference's memory estimate is taken with the
port's one recorded departure (:func:`whole_cache_per_rank`): the KV-cache
terms count whole on every data rank.
"""

import pytest

from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.parallel import mesh as jmesh
from llm_interpretation_replication_tpu.runtime import plan_search as jsearch
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.parallel import mesh
from llm_interpretation_replication_tpu_torch.runtime import plan, plan_search
from test_torch_plan import set_reference_plan
from test_torch_slots import one_torch_thread  # noqa: F401

#: plan_search.py's coefficients the reference also has
SEARCH_COEFFICIENTS = (
    "ROWS_CEILING", "BATCH_HALF_SAT", "FULL_STUDY_WORK", "TP_COMM_PENALTY",
    "INT8_KV_PENALTY", "CHUNK_PENALTY", "CALIBRATION_PARAMS",
    "K_ACCEPT_PRIOR", "K_DECODE_SHARE", "PREFILL_PHASE_SHARE",
    "DECODE_REFILL_GAIN", "PACKED_QUESTION_TOKENS", "PACKED_SHARED_TOKENS",
    "PACKED_DEMO_TOKENS", "PACKED_NO_DECODE_GAIN",
    "PACKED_SWEEP_HEADROOM_BYTES", "BINARY_SWEEP_HEADROOM_BYTES")
HBM = 16 << 30
#: the need terms that hold the KV cache
CACHE_TERMS = ("completions", "conf_pool")


def whole_cache_per_rank(need):
    """The reference's ``sharded_need_bytes`` with the port's departure:
    the KV-cache terms divided as at one data rank, every other term as
    the reference divides it."""
    def sharded(terms, cfg, data, model, pipe):
        cache = dict.fromkeys(("weights", "attn", "act"), 0)
        cache.update({k: terms.get(k, 0) for k in CACHE_TERMS})
        return (need(terms, cfg, data, model, pipe)
                - need(cache, cfg, data, model, pipe)
                + need(cache, cfg, 1, model, pipe))
    sharded.__wrapped__ = need
    return sharded


@pytest.fixture
def reference(monkeypatch):
    set_reference_plan(monkeypatch)
    monkeypatch.setattr(jsearch, "sharded_need_bytes",
                        whole_cache_per_rank(jsearch.sharded_need_bytes))
    for name in SEARCH_COEFFICIENTS:
        monkeypatch.setattr(plan_search, name, getattr(jsearch, name))
    # the reference's full-study row rides the binary curve
    monkeypatch.setattr(plan_search, "FULL_STUDY_HALF_SAT",
                        jsearch.BATCH_HALF_SAT)


def falcon():
    return (tconfig.DecoderConfig(**tconfig.FALCON_7B_GEOMETRY),
            jconfig.DecoderConfig(**jconfig.FALCON_7B_GEOMETRY))


@pytest.mark.parametrize("workload", ["full", "binary", "packed"])
@pytest.mark.parametrize("quant", ["int8", "none"])
@pytest.mark.parametrize("devices", [1, 4, 8])
def test_search_equals_reference(reference, workload, quant, devices):
    t, j = falcon()
    depth = 2 if workload == "full" else 4
    got = plan_search.search_plans(t, quant, devices, workload=workload,
                                   pipeline_depth=depth, hbm_bytes=HBM)
    ref = jsearch.search_plans(j, quant, devices, workload=workload,
                               pipeline_depth=depth, hbm_bytes=HBM)
    assert [c.as_record() for c in got] == [c.as_record() for c in ref]
    assert (plan_search.plan_search_record(got, top=8)
            == jsearch.plan_search_record(ref, top=8))
    assert (plan_search.format_candidate_table(got, top=8)
            == jsearch.format_candidate_table(ref, top=8))
    chosen, ref_chosen = (plan_search.chosen_plan(got),
                          jsearch.chosen_plan(ref))
    assert ((chosen and chosen.as_record())
            == (ref_chosen and ref_chosen.as_record()))


@pytest.mark.parametrize("workload", ["binary", "full"])
@pytest.mark.parametrize("role", [None, "prefill", "decode"])
def test_replica_plan_equals_reference(reference, workload, role):
    t, j = falcon()
    for devices in (1, 2, 4):
        got = plan_search.replica_plan(t, "int8", devices, workload=workload,
                                       role=role, hbm_bytes=HBM,
                                       slot_repack=True)
        ref = jsearch.replica_plan(j, "int8", devices, workload=workload,
                                   role=role, hbm_bytes=HBM,
                                   slot_repack=True)
        assert got.as_record() == ref.as_record()
    small = plan_search.replica_plan(t, "none", 1, hbm_bytes=8 << 30)
    assert small is None is jsearch.replica_plan(j, "none", 1,
                                                 hbm_bytes=8 << 30)


def test_rate_model_equals_reference(reference):
    t, j = falcon()
    for k in range(1, 9):
        assert plan_search.k_decode_speedup(k) == jsearch.k_decode_speedup(k)
    for role in (None, "prefill", "decode"):
        for chunk, pool, k in ((0, 0, 1), (64, 192, 4), (128, 0, 2)):
            kw = dict(prefill_chunk=chunk, seq=256, pool_target=pool,
                      decode_k=k)
            assert (plan_search.role_rate_factor(role, **kw)
                    == jsearch.role_rate_factor(role, **kw))
    with pytest.raises(ValueError):
        plan_search.role_rate_factor("both")
    for workload in ("full", "binary", "packed"):
        for data, model, b, kv, chunk, q, k in (
                (1, 1, 32, "bf16", 0, 1, 1), (4, 2, 256, "int8", 64, 4, 4),
                (8, 1, 512, "bf16", 128, 8, 2)):
            assert (plan_search.predicted_rows_per_s(
                t, data, model, b, kv, chunk, workload, 256, q, k)
                == jsearch.predicted_rows_per_s(
                    j, data, model, b, kv, chunk, workload, 256, q, k))
    for q in (1, 2, 4, 8):
        assert plan_search.packed_seq_tokens(q) == jsearch.packed_seq_tokens(q)
    terms = plan_search.binary_need_terms(t, 7 << 30, 96, 256, 4, "flash")
    assert terms == jsearch.binary_need_terms(j, 7 << 30, 96, 256, 4,
                                              "flash")
    for data, model, pipe in ((1, 1, 1), (4, 2, 1), (2, 71, 1), (1, 4, 2)):
        assert (plan_search.sharded_need_bytes(terms, t, data, model, pipe)
                == jsearch.sharded_need_bytes(terms, j, data, model, pipe))
        if data == 1:
            assert (plan_search.sharded_need_bytes(terms, t, 1, model, pipe)
                    == jsearch.sharded_need_bytes.__wrapped__(
                        terms, j, 1, model, pipe))


def test_a_searched_dp_plan_holds_the_whole_cache_on_each_rank():
    """Each data rank holds the whole KV cache between device calls, so a
    searched plan on more than one data rank budgets every cache term
    whole, not the reference's share of it: the plan search never picks a
    batch whose cache does not fit on one rank."""
    t = falcon()[0]
    seq, depth = 256, 2
    ranked = plan_search.search_plans(t, "int8", 8, seq=seq,
                                      pipeline_depth=depth,
                                      hbm_bytes=80 << 30)
    dp = [c for c in ranked if c.fits and c.data > 1]
    assert dp
    wb = plan_search.weight_bytes(t, "int8")
    for c in dp:
        terms = plan.full_study_need_terms(
            t, wb, "xla", c.batch, seq, 50, 10, depth, reduced_scores=True,
            kv_dtype=c.kv_dtype, prefill_chunk=c.prefill_chunk,
            pooled_confidence=True, pool_target=c.pool_target or None,
            decode_k=c.decode_k, quant="int8")
        kv_div = c.model if t.num_kv_heads % c.model == 0 else 1
        whole = sum(terms[k] for k in CACHE_TERMS) // kv_div
        assert whole >= plan.kv_cache_bytes(t, c.batch, seq, c.kv_dtype)
        assert c.need_bytes >= wb // c.model + whole


def test_mesh_arithmetic_equals_reference():
    for n in (1, 2, 4, 6, 8, 12, 16):
        for max_model in (None, 2, 4):
            for max_pipe in (1, 2, 4):
                assert (mesh.enumerate_mesh_shapes(n, max_model, max_pipe)
                        == jmesh.enumerate_mesh_shapes(n, max_model,
                                                       max_pipe))
        for want_model in (1, 2, 3, 8):
            for want_seq in (1, 2, 4):
                assert (mesh.mesh_shape_for(n, want_model, want_seq)
                        == jmesh.mesh_shape_for(n, want_model, want_seq))
    with pytest.raises(ValueError):
        mesh.enumerate_mesh_shapes(0)


def test_dryrun_prediction_equals_reference(reference, eight_cpu_devices,
                                            capsys):
    """The dryrun's chosen plan and the hand-picked dp4 x tp2 point for 8
    devices, as arithmetic; its exec leg builds the chosen mesh on 8
    spawned gloo ranks and scores with single-device parity, as the
    reference's does on its 8 virtual devices."""
    import io

    got = plan_search.run_dryrun(8, exec_leg=False, out=io.StringIO(),
                                 hbm_bytes=HBM)
    ref = jsearch.run_dryrun(8, exec_leg=False, out=io.StringIO())
    assert got == ref
    out = io.StringIO()
    ran = plan_search.run_dryrun(8, exec_leg=True, out=out, hbm_bytes=HBM)
    assert ran["exec"] == {"mesh": {**ran["chosen"]["mesh"], "seq": 1},
                           "prompts": 4, "parity": True}
    assert "sharded fast-path parity" in out.getvalue()
    wide = plan_search.PlanCandidate(
        data=4, pipe=1, model=2, batch=32, kv_dtype="bf16", prefill_chunk=0,
        pool_target=0, fits=True, reason="", need_bytes=0,
        predicted_rows_per_s=0.0)
    plan_search.require_ranks(wide, world=8)
    with pytest.raises(ValueError, match="needs 8 ranks"):
        plan_search.require_ranks(wide, world=1)
    with pytest.raises(ValueError):
        plan_search.run_dryrun(4, exec_leg=False, hbm_bytes=HBM)


def test_plan_search_cli(capsys):
    """``plan search`` prints the table (exit 0 when a plan fits, 1 when
    none does) or its JSON record at an explicit memory."""
    import json

    assert plan_search.main(["search", "--hbm-gib", "80", "--format",
                             "json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["chosen"]["fits"] and rec["n_fit"] >= 1
    assert plan_search.main(["search", "--hbm-gib", "80", "--workload",
                             "binary", "--attention-impl", "flash"]) == 0
    assert "chosen" in capsys.readouterr().out
    assert plan_search.main(["search", "--hbm-gib", "4"]) == 1
    assert "NO candidate fits" in capsys.readouterr().out


#: every anchored coefficient, as scripts/calibrate_plan_torch.py measured
#: it on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6)
ANCHORED = {
    plan: dict(
        RESERVE_BYTES=11 << 26, THRASH_HEADROOM_BYTES=297 << 26,
        SCORE_BYTES_PER_ELEMENT=11.09, EXTEND_SCORE_BYTES_PER_ELEMENT=18.22,
        FLASH_BYTES_PER_ELEMENT=17.06, ACT_HIDDEN_BYTES=6.0,
        ACT_MLP_BYTES=4.0, ACT_MLP_BYTES_INT8=14.01,
        DISTILL_SOLVE_BYTES=11.49, INT8_EMBEDDING_BYTES=2.0,
        LOAD_BYTES_PER_WEIGHT_BYTE=1.44,
        LOAD_BYTES_PER_WEIGHT_BYTE_INT8=1.94),
    plan_search: dict(
        ROWS_CEILING=74.77, BATCH_HALF_SAT=56.82, FULL_STUDY_HALF_SAT=361.4,
        FULL_STUDY_WORK=0.949, INT8_KV_PENALTY=0.0, CHUNK_PENALTY=0.0,
        CALIBRATION_PARAMS=6_921_420_800, K_DECODE_SHARE=0.763,
        PREFILL_PHASE_SHARE=0.705, PACKED_QUESTION_TOKENS=118.46,
        PACKED_SHARED_TOKENS=0.0, PACKED_DEMO_TOKENS=0.75,
        PACKED_NO_DECODE_GAIN=2.973,
        PACKED_SWEEP_HEADROOM_BYTES=306 << 26,
        BINARY_SWEEP_HEADROOM_BYTES=290 << 26),
}


@pytest.mark.parametrize("module", [plan, plan_search],
                         ids=["plan", "plan_search"])
def test_anchored_coefficients_are_the_cards(module):
    """Each ``# anchor:`` coefficient holds the card's measured value, and
    every anchored line of the module is in the table."""
    import inspect
    import re

    for name, value in ANCHORED[module].items():
        assert getattr(module, name) == value, name
    anchored = set(re.findall(r"^([A-Z][A-Z0-9_]*) = .*# anchor:",
                              inspect.getsource(module), re.M))
    assert anchored == set(ANCHORED[module])
    assert plan_search.CALIBRATION_PARAMS == plan.param_count(
        tconfig.DecoderConfig(**tconfig.FALCON_7B_GEOMETRY))


def test_the_card_chooses_its_plan_for_falcon_7b_full_int8():
    """At the card's memory the search picks one device, the top of the
    batch ladder and the predicted rate the table states (PERF.md)."""
    cfg = tconfig.DecoderConfig(**tconfig.FALCON_7B_GEOMETRY)
    best = plan_search.chosen_plan(plan_search.search_plans(
        cfg, "int8", 1, workload="full", attention_impl="flash",
        slot_repack=True, hbm_bytes=85017493504))
    assert (best.data, best.model, best.batch) == (1, 1, 512)
    assert best.need_bytes <= 85017493504 - plan.RESERVE_BYTES \
        - plan.THRASH_HEADROOM_BYTES
