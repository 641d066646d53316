"""The port's serve scheduler against the JAX package's.

Two kinds of tests:

- Host policy (queue deadlines, backpressure, priority, coalescing, the
  JSONL driver, replay's loud failure) run on both packages' schedulers
  over ``test_sweeps.FakeEngine`` (deterministic rows from a hash of the
  prompt), parametrized by package, and the two answer the same.
- Over the real test model (``test_torch_slots``: ``FLAGSHIP_SMALL_GEOMETRY``
  in float32, the reference's ``random_decoder_params`` carried across by
  ``params_from_jax``, ``WordTokenizer`` targets): the port's scheduler
  against the JAX scheduler on the same requests (tokens, verdicts and
  ``scan_found`` identical, probabilities rtol 2e-5, ``serve_*`` counters
  equal) and against the port's own offline path (``rows_equal``, exact).

With slot admission on, a launch decodes its rows through the slot ring,
and a ring whose composition differs from the offline pooled ring's (rows
admitted mid-decode, another bucket's prompt region) reads its multi-chunk
score fields in the ring's fp32 class, as in the reference
(``tests/test_slots.py::test_slotted_matches_offline_scoring``): the exact
comparison is the single launch whose ring is fed as the offline one is.
"""

import dataclasses
import io
import json
import re

import numpy as np
import pytest

from test_sweeps import FakeEngine
from test_torch_engine import PROB_FIELDS, RTOL
from test_torch_slots import (  # noqa: F401
    PROMPTS, TOK, engines, models, one_torch_thread, targets)

import llm_interpretation_replication_tpu.runtime.faults as jfaults
import llm_interpretation_replication_tpu.serve as jserve
import llm_interpretation_replication_tpu.serve.cli as jcli
import llm_interpretation_replication_tpu.serve.coalescer as jcoal
import llm_interpretation_replication_tpu.utils.telemetry as jtel
import llm_interpretation_replication_tpu.utils.testing as jtesting
import llm_interpretation_replication_tpu_torch.runtime.faults as tfaults
import llm_interpretation_replication_tpu_torch.serve as tserve
import llm_interpretation_replication_tpu_torch.serve.cli as tcli
import llm_interpretation_replication_tpu_torch.serve.coalescer as tcoal
import llm_interpretation_replication_tpu_torch.utils.telemetry as ttel
import llm_interpretation_replication_tpu_torch.utils.testing as ttesting
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.runtime import strict

FAST = dict(max_wait_s=0.01)

PKGS = {
    "jax": dict(serve=jserve, cli=jcli, coal=jcoal, tel=jtel,
                faults=jfaults, testing=jtesting),
    "torch": dict(serve=tserve, cli=tcli, coal=tcoal, tel=ttel,
                  faults=tfaults, testing=ttesting),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


class RecordingEngine(FakeEngine):
    """FakeEngine that logs every micro-batch launch's composition."""

    def __init__(self):
        super().__init__("rec/model")
        self.call_log = []

    def score_prompts(self, prompts, targets=("Yes", "No"),
                      with_confidence=False, max_new_tokens=None):
        self.call_log.append({"prompts": list(prompts),
                              "with_confidence": with_confidence,
                              "max_new_tokens": max_new_tokens})
        return super().score_prompts(prompts, targets, with_confidence,
                                     max_new_tokens)


# -- request surface and admission policy (both packages) --------------------

def test_request_validation(pkg):
    ScoreRequest = pkg["serve"].ScoreRequest
    with pytest.raises(ValueError, match="exactly one"):
        ScoreRequest().validate()
    with pytest.raises(ValueError, match="exactly one"):
        ScoreRequest(prompt="p", prefix="a", suffix="b").validate()
    with pytest.raises(ValueError, match="together"):
        ScoreRequest(prefix="a").validate()
    with pytest.raises(ValueError, match="pair"):
        ScoreRequest(prompt="p", targets=("Yes",)).validate()
    with pytest.raises(ValueError, match="decode_k"):
        ScoreRequest(prompt="p", decode_k=0).validate()
    ScoreRequest(prompt="p").validate()
    ScoreRequest(prefix="a", suffix="b").validate()


def test_future_first_resolution_wins(pkg):
    s = pkg["serve"]
    f = s.ScoreFuture()
    with pytest.raises(TimeoutError):
        f.result(timeout=0.01)
    assert f._set_exception(s.DeadlineExceeded("late"))
    assert not f._set_result({"success": True})      # at most once
    with pytest.raises(s.DeadlineExceeded):
        f.result()
    assert isinstance(f.exception(), s.DeadlineExceeded)


def test_full_queue_typed_backpressure(pkg):
    s, tel = pkg["serve"], pkg["tel"]
    sched = s.Scheduler(RecordingEngine(),
                        s.SchedulerConfig(queue_capacity=3, **FAST))
    futs = [sched.submit(s.ScoreRequest(prompt=f"q{i}")) for i in range(3)]
    snap = tel.counters()
    with pytest.raises(s.QueueFull):
        sched.submit(s.ScoreRequest(prompt="overflow"))
    assert tel.counters_since(snap)["serve_rejected_full"] == 1
    sched.close()       # never started: queued work gets a typed error
    for f in futs:
        assert isinstance(f.exception(timeout=5), s.SchedulerClosed)


def test_priority_then_fifo_pop_order(pkg):
    s = pkg["serve"]
    sched = s.Scheduler(RecordingEngine(),
                        s.SchedulerConfig(queue_capacity=6, **FAST))
    for i, p in enumerate([0, 5, 1, 5, 0, 3]):
        sched.submit(s.ScoreRequest(prompt=f"q{i}", priority=p))
    group, expired = sched.queue.pop_group(max_batch=6, max_wait_s=0)
    assert expired == []
    assert [t.request.priority for t in group] == [5, 5, 3, 1, 0, 0]
    assert [t.seq for t in group] == [2, 4, 6, 3, 1, 5]
    sched.close()


def test_deadline_expired_rejected_typed_not_dropped(pkg):
    s, tel = pkg["serve"], pkg["tel"]
    eng = RecordingEngine()
    snap = tel.counters()
    with s.Scheduler(eng, s.SchedulerConfig(**FAST)) as sched:
        late = sched.submit(s.ScoreRequest(prompt="too-late", timeout_s=0.0))
        ok = sched.submit(s.ScoreRequest(prompt="on-time"))
        assert ok.result(timeout=30)["success"]
        err = late.exception(timeout=30)
    assert isinstance(err, s.DeadlineExceeded)
    assert tel.counters_since(snap)["serve_rejected_deadline"] == 1
    assert "too-late" not in [p for c in eng.call_log for p in c["prompts"]]


def test_submit_after_close_raises_and_close_is_idempotent(pkg):
    s = pkg["serve"]
    sched = s.Scheduler(RecordingEngine(), s.SchedulerConfig(**FAST))
    sched.start()
    sched.close()
    sched.close()
    with pytest.raises(s.SchedulerClosed):
        sched.submit(s.ScoreRequest(prompt="late"))


def test_never_mixes_incompatible_plan_or_leg_keys(pkg):
    s = pkg["serve"]
    eng = RecordingEngine()
    sched = s.Scheduler(eng, s.SchedulerConfig(max_batch=16, **FAST))
    futs = [sched.submit(s.ScoreRequest(
        prompt=f"q{i}", with_confidence=(i % 3 == 2),
        max_new_tokens=10 if i % 3 == 1 else None)) for i in range(9)]
    with sched:
        rows = [f.result(timeout=30) for f in futs]
    assert all(r["success"] for r in rows)
    assert sorted(len(c["prompts"]) for c in eng.call_log) == [3, 3, 3]
    assert {(c["with_confidence"], c["max_new_tokens"])
            for c in eng.call_log} == {(False, None), (False, 10),
                                       (True, None)}


def test_parity_failure_is_loud(pkg):
    s = pkg["serve"]
    eng = RecordingEngine()
    prompts = [f"q{i}" for i in range(4)]
    offline = eng.score_prompts(prompts)
    offline[2] = dict(offline[2], yes_prob=0.123456)
    with pytest.raises(s.ServeError, match="row 2"):
        s.replay(eng, prompts, offline_rows=offline, offline_s=1.0)


def _jsonl_lines():
    return "\n".join([
        json.dumps({"prompt": "Is a tweet a publication?"}),
        json.dumps({"prompt": "Is soup a beverage?",
                    "targets": ["Yes", "No"], "priority": 3}),
        "{not json",
        json.dumps({"bogus_field": 1}),
        json.dumps({"prompt": "third", "timeout_s": 0.0}),
    ]) + "\n"


def test_jsonl_driver_answers_every_line_in_order(pkg):
    s = pkg["serve"]
    out = io.StringIO()
    summary = pkg["cli"].run_jsonl_driver(
        RecordingEngine(), io.StringIO(_jsonl_lines()), out,
        s.SchedulerConfig(**FAST))
    assert summary == {"requests": 5, "errors": 3}
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]
    assert rows[0]["success"] and rows[1]["success"]
    assert rows[2]["error_type"] == "JSONDecodeError"
    assert rows[3]["error_type"] == "ValueError"
    assert rows[4]["error_type"] == "DeadlineExceeded"


def test_jsonl_driver_output_equals_reference():
    outs = {}
    for name, p in PKGS.items():
        out = io.StringIO()
        p["cli"].run_jsonl_driver(RecordingEngine(),
                                  io.StringIO(_jsonl_lines()), out,
                                  p["serve"].SchedulerConfig(**FAST))
        outs[name] = out.getvalue()
    # a DeadlineExceeded message carries the wall-clock seconds since the
    # deadline, which no two runs share: each must read as a float >= 0,
    # and the texts must agree with the number left out
    elapsed = re.compile(r"passed (\S+)s before")
    for text in outs.values():
        assert all(float(x) >= 0 for x in elapsed.findall(text))
    assert (elapsed.sub("passed <x>s before", outs["torch"])
            == elapsed.sub("passed <x>s before", outs["jax"]))
    assert (len(elapsed.findall(outs["torch"]))
            == len(elapsed.findall(outs["jax"])))


def test_jsonl_driver_answers_backpressure(pkg):
    s = pkg["serve"]
    lines = "\n".join(json.dumps({"prompt": f"q{i}"}) for i in range(6))
    out = io.StringIO()
    summary = pkg["cli"].run_jsonl_driver(
        RecordingEngine(), io.StringIO(lines), out,
        s.SchedulerConfig(queue_capacity=2, max_wait_s=5.0))
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    assert summary["requests"] == 6 and len(rows) == 6
    assert {r.get("error_type") for r in rows} <= {None, "QueueFull"}
    assert summary["errors"] == sum(1 for r in rows if "error" in r) >= 1


def test_replay_cli_builds_sweep_workload(pkg, tmp_path):
    scenarios = [
        {"original_main": f"Is thing {s} a stuff?",
         "response_format": "Answer only 'Yes' or 'No'.",
         "target_tokens": ["Yes", "No"] if s == 0 else ["No", "Yes"],
         "rephrasings": [f"Is thing {s} variant {i} a stuff?"
                         for i in range(3)]}
        for s in range(2)]
    path = tmp_path / "perturbations.json"
    path.write_text(json.dumps(scenarios))
    eng = RecordingEngine()
    report = pkg["cli"].run_replay(eng, str(path), max_rephrasings=2,
                                   config=pkg["serve"].SchedulerConfig(**FAST))
    assert report["rows"] == 4 and report["mismatched_rows"] == 0
    assert "serve_rows" not in report
    served = [p for c in eng.call_log[1:] for p in c["prompts"]]
    assert sorted(served) == sorted(eng.call_log[0]["prompts"])
    assert served[0].endswith("Answer only 'Yes' or 'No'.")


# -- the fault helpers the serve path runs on -------------------------------

@pytest.mark.parametrize("args", [
    (10, 8, (), 1), (4, 384, (320, 256), 256), (4, 1, (), 1), (4, 8, (), 8),
    (33, 32, (), 1), (32, 32, (16,), 1), (7, 64, (48, 32), 4), (5, 3, (), 0),
])
def test_split_for_requeue_matches_reference(args):
    rows, current, ladder, floor = args
    assert tfaults.split_for_requeue(rows, current, ladder=ladder,
                                     floor=floor) == \
        jfaults.split_for_requeue(rows, current, ladder=ladder, floor=floor)


def test_fleet_backoff_matches_reference():
    import random

    for attempt in range(6):
        tp = tfaults.fleet_backoff_policy(0.5, 30.0, 3)
        jp = jfaults.fleet_backoff_policy(0.5, 30.0, 3)
        tp.rng, jp.rng = random.Random(attempt), random.Random(attempt)
        assert tp.full_jitter and jp.full_jitter
        assert (tfaults.fleet_backoff_delay(attempt, tp)
                == jfaults.fleet_backoff_delay(attempt, jp))
    assert 0.0 <= tfaults.fleet_backoff_delay(0) <= 1.0


# -- over the real test model ------------------------------------------------

def _requests(s, prompts, pairs, **kw):
    return [s.ScoreRequest(prompt=p, targets=tuple(t), **kw)
            for p, t in zip(prompts, pairs)]


def _serve(s, tel, engine, requests, **cfg):
    """Submit everything before the loop starts (deterministic groups),
    serve, and return (rows, serve_* counter deltas)."""
    snap = tel.counters()
    sched = s.Scheduler(engine, s.SchedulerConfig(max_wait_s=0.01, **cfg))
    futs = [sched.submit(r) for r in requests]
    with sched:
        rows = [f.result(timeout=300) for f in futs]
    delta = tel.counters_since(snap)
    return rows, {k: v for k, v in delta.items() if k.startswith("serve_")}


def assert_rows_match(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["success"] and r["success"]
        assert g["scan_found"] == r["scan_found"]
        assert g["completion"] == r["completion"]
        for f in PROB_FIELDS:
            np.testing.assert_allclose(g[f], r[f], rtol=RTOL, atol=1e-9,
                                       err_msg=f)


def test_compat_key_equals_reference():
    jeng, teng = engines(batch_size=4, decode_k=2)
    reqs = [
        dict(prompt=PROMPTS[0]), dict(prompt=PROMPTS[1], max_new_tokens=10),
        dict(prompt=PROMPTS[2], with_confidence=True),
        dict(prompt=PROMPTS[3], decode_k=3), dict(prompt=" ".join(
            [PROMPTS[4]] * 30)),
        dict(prefix=PROMPTS[5], suffix=" w1 w2"),
        dict(prefix=PROMPTS[6], suffix=" w3", with_confidence=True,
             max_new_tokens=10),
    ]
    keys = []
    for kw in reqs:
        jr, tr = jserve.ScoreRequest(**kw), tserve.ScoreRequest(**kw)
        je, te = jcoal.encode_request(jeng, jr), tcoal.encode_request(teng, tr)
        assert te == je
        keys.append(tcoal.compat_key(teng, tr, te))
        assert keys[-1] == jcoal.compat_key(jeng, jr, je)
    assert len(set(keys)) == len(keys)          # every knob splits the key
    assert keys[4][1] == "overflow"


@pytest.mark.parametrize("slot", [False, True])
def test_scheduler_matches_reference_scheduler(slot):
    """Same requests through both schedulers: the same micro-batches, so
    rows at the classes and equal ``serve_*`` counters (with slot
    admission on, ``serve_slot_admitted`` says rows joined mid-decode)."""
    jeng, teng = engines(batch_size=4)
    pairs = targets()
    jrows, jc = _serve(jserve, jtel, jeng,
                       _requests(jserve, PROMPTS, pairs),
                       slot_admission=slot)
    trows, tc = _serve(tserve, ttel, teng,
                       _requests(tserve, PROMPTS, pairs),
                       slot_admission=slot)
    assert_rows_match(trows, jrows)
    assert tc == jc
    assert (tc.get("serve_slot_admitted", 0) > 0) == slot


def test_scheduler_rows_exact_against_offline():
    """Slot admission off: each micro-batch (one bucket, four requests in
    arrival order) scores through ``score_prompts``, and its rows equal
    the offline call on the same four prompts exactly."""
    _, teng = engines(batch_size=4)
    pairs = dict(zip(PROMPTS, targets()))
    prompts = _one_bucket()
    sub = [pairs[p] for p in prompts]
    offline = []
    for i in range(0, len(prompts), 4):
        offline += teng.score_prompts(prompts[i:i + 4], sub[i:i + 4])
    report = tserve.replay(
        teng, prompts, targets=sub, offline_rows=offline, offline_s=1.0,
        config=tserve.SchedulerConfig(slot_admission=False, **FAST))
    assert report["mismatched_rows"] == 0
    assert report["serve_batches"] == -(-len(prompts) // 4) >= 2
    assert all(tserve.rows_equal(a, b)
               for a, b in zip(report["serve_rows"], offline))


def _one_bucket():
    """The prompts of the first bucket (32 tokens), in order."""
    idx = [i for i, p in enumerate(PROMPTS) if len(TOK(p)["input_ids"]) <= 32]
    assert len(idx) >= 6
    return [PROMPTS[i] for i in idx]


def test_slotted_launch_exact_against_offline():
    """Slot admission on, one bucket, every request in the first launch:
    its ring is fed as the offline pooled ring is, and the rows are
    exact."""
    _, teng = engines(batch_size=4)
    pairs = dict(zip(PROMPTS, targets()))
    prompts = _one_bucket()
    sub = [pairs[p] for p in prompts]
    offline = teng.score_prompts(prompts, sub)
    rows, c = _serve(tserve, ttel, teng, _requests(tserve, prompts, sub),
                     max_batch=len(prompts))
    assert c["serve_batches"] == 1
    assert all(tserve.rows_equal(a, b) for a, b in zip(rows, offline))


def test_slotted_admission_against_offline_class():
    """Slot admission with rows joining mid-decode: verdicts and
    position-0 fields exact against offline, the score fields in the
    ring's fp32 class."""
    _, teng = engines(batch_size=4)
    pairs = targets()
    offline = teng.score_prompts(PROMPTS, pairs)
    rows, c = _serve(tserve, ttel, teng, _requests(tserve, PROMPTS, pairs))
    assert c["serve_slot_admitted"] > 0
    assert_rows_match(rows, offline)
    for a, b in zip(rows, offline):
        for f in ("first_token_yes_prob", "first_token_no_prob",
                  "first_token_relative_prob"):
            assert a[f] == b[f]


def test_prefix_pairs_ride_score_prefixed():
    """Prefix/suffix requests launch through ``score_prefixed`` (one
    prefix-pool entry a micro-batch): rows at the classes against the JAX
    scheduler, and exact against the offline call on the same batch."""
    jeng, teng = engines(batch_size=4)
    pairs = dict(zip(PROMPTS, targets()))
    prompts = _one_bucket()
    reqs = {name: [p["serve"].ScoreRequest(prefix=q, suffix=" w7 w9",
                                           targets=tuple(pairs[q]))
                   for q in prompts] for name, p in PKGS.items()}
    jrows, jc = _serve(jserve, jtel, jeng, reqs["jax"],
                       max_batch=len(prompts))
    trows, tc = _serve(tserve, ttel, teng, reqs["torch"],
                       max_batch=len(prompts))
    assert_rows_match(trows, jrows)
    assert tc == jc and tc["serve_batches"] == 1
    assert teng.last_prefix_pool.closed and teng.last_prefix_pool.consistent
    offline = teng.score_prefixed([(q, (" w7 w9",)) for q in prompts],
                                  targets=[pairs[q] for q in prompts])[0]
    assert all(tserve.rows_equal(a, b) for a, b in zip(trows, offline))


def test_oom_split_requeues_as_reference():
    """An injected device OOM splits the micro-batch down the ladder in
    both packages (same fault events, same chunk sizes, same counters);
    the rows equal offline rows scored at the batch the split ended at."""
    jeng, teng = engines(batch_size=4, decode_completions=True,
                         max_new_tokens=12)
    prompts = _one_bucket()[:6]
    out = {}
    for name, p, eng in (("jax", PKGS["jax"], jeng),
                         ("torch", PKGS["torch"], teng)):
        faulty = p["testing"].FaultyEngine(
            eng, [p["testing"].Fault("oom", at_call=1)])
        p["tel"].clear_fault_events()
        rows, c = _serve(p["serve"], p["tel"], faulty,
                         _requests(p["serve"], prompts, [("Yes", "No")] * 6),
                         retry_policy=None)
        events = [{k: e[k] for k in ("rows", "batch", "new_batch")}
                  for e in p["tel"].fault_events("serve_oom_split")]
        out[name] = (rows, c, events, faulty.calls)
    assert out["torch"][2] == out["jax"][2] == [
        {"rows": 4, "batch": 4, "new_batch": 2}]
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][1]["serve_oom_splits"] == 1
    assert out["torch"][3] == out["jax"][3] == 3
    assert_rows_match(out["torch"][0], out["jax"][0])
    rows = out["torch"][0]
    with teng.config_overrides(batch_size=2):
        split = teng.score_prompts(prompts[:4])
    whole = teng.score_prompts(prompts[4:])
    assert all(tserve.rows_equal(a, b)
               for a, b in zip(rows, split + whole))


def test_oom_at_floor_fails_with_the_original_error():
    _, teng = engines(batch_size=4, decode_completions=True,
                      max_new_tokens=12)
    faulty = ttesting.FaultyEngine(teng, [ttesting.Fault("oom", at_call=1)])
    snap = ttel.counters()
    cfg = tserve.SchedulerConfig(max_wait_s=0.01, oom_floor=4)
    with faulty.serve_scheduler(cfg) as sched:
        futs = [sched.submit(tserve.ScoreRequest(prompt=p))
                for p in _one_bucket()[:4]]
        errs = [f.exception(timeout=300) for f in futs]
    assert all(tfaults.is_oom(e) for e in errs)
    assert ttel.counters_since(snap)["serve_failed"] == 4


def test_strict_replay_stays_clean():
    _, teng = engines(batch_size=4)
    pairs = dict(zip(PROMPTS, targets()))
    prompts = _one_bucket()
    strict.activate(sentry=False)
    try:
        report = tserve.replay(
            teng, prompts, targets=[pairs[p] for p in prompts],
            config=tserve.SchedulerConfig(max_batch=len(prompts), **FAST))
    finally:
        strict.deactivate()
    assert report["mismatched_rows"] == 0
    assert report["blocked_transfers"] == 0


# -- the engine pieces the scheduler composes with ---------------------------

def test_config_overrides_restore_the_engine_config():
    _, teng = engines(batch_size=4)
    before = teng.ecfg
    with teng.config_overrides(oom_backoff=False, batch_size=2) as ecfg:
        assert teng.ecfg is ecfg
        assert (ecfg.oom_backoff, ecfg.batch_size) == (False, 2)
        assert teng._oom_rebatch([]) is None
    assert teng.ecfg is before
    with pytest.raises(RuntimeError):
        with teng.config_overrides(decode_k=2):
            raise RuntimeError("boom")
    assert teng.ecfg is before
    assert teng.plan_decision is None


def test_live_buffer_count_sees_weights_freed():
    from llm_interpretation_replication_tpu_torch.models import config as tc
    from llm_interpretation_replication_tpu_torch.models import convert

    base = tengine.live_buffer_count("cpu")
    cfg = tc.DecoderConfig(**tc.FLAGSHIP_SMALL_GEOMETRY)
    w = convert.random_params(cfg, seed=1, device="cpu", dtype="fp32")
    n = len(list(w.buffers()))
    assert tengine.live_buffer_count("cpu") >= base + n
    eng = tengine.ScoringEngine("falcon", cfg, w, TOK, device="cpu")
    eng.close()
    assert tengine.live_buffer_count("cpu") <= base
    assert dataclasses.is_dataclass(eng.ecfg)


# -- a row reads the same in any batch composition ---------------------------

def test_decode_rows_do_not_depend_on_the_cache_padding():
    """The same rows decoded from a cache padded to 32 slots and to 64 (as
    a row of bucket 32 is in a micro-batch of its own bucket and in an
    offline batch padded to 64) give bit-identical tokens and scores over
    two chunks (the second reads the first's folded tail at another slot
    index).  On the CPU this holds with float32 sums too; on the card,
    whose kernels for two slot counts round differently, it takes the
    float64 sums, and the smoke's serve phase holds it there."""
    import torch

    from llm_interpretation_replication_tpu_torch.models import decoder

    _, tcfg, _, weights = models()
    rows = [TOK(p)["input_ids"] for p in _one_bucket()[:4]]
    ids = torch.zeros((4, 32), dtype=torch.long)
    mask = torch.zeros((4, 32), dtype=torch.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.as_tensor(r)
        mask[i, :len(r)] = 1
    lens = mask.sum(-1)
    out = []
    for cache_len in (32, 64):
        last, cache = decoder.prefill(weights, tcfg, ids, mask,
                                      cache_len=cache_len)
        t1, s1, cache, prev, _ = decoder.decode_steps(
            weights, tcfg, cache, last, lens, 0, 5, None, None,
            with_scores=True)
        t2, s2, *_ = decoder.decode_steps(weights, tcfg, cache, prev,
                                          lens + 5, 0, 5, None, None,
                                          with_scores=True)
        out.append((last, t1, s1, t2, s2))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_ring_rows_do_not_depend_on_the_ring_composition():
    """Slotted scoring of a bucket's prompts alone and inside the whole
    workload (a ring of other rows, refilled at other chunks) gives the
    same rows bit for bit (on the card it takes rings decoding at their
    capacity's row count; the smoke's serve phase holds it there)."""
    _, teng = engines(batch_size=4)
    pairs = dict(zip(PROMPTS, targets()))
    one = _one_bucket()
    alone = teng.score_prompts_slotted(one, [pairs[p] for p in one])
    mixed = dict(zip(PROMPTS, teng.score_prompts_slotted(
        PROMPTS, [pairs[p] for p in PROMPTS])))
    assert all(tserve.rows_equal(a, mixed[p]) for a, p in zip(alone, one))
