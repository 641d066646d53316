"""The port's open-loop load harness (``serve/load.py``) against the JAX
package's.

``poisson_schedule`` gives the identical floats for the same seed,
``corpus_workload`` the identical prompts and targets, and the per-phase
report and ``format_rate_table`` the identical output on fixed histogram
inputs.  ``run_load`` and ``rate_sweep`` drive both packages' schedulers
over ``test_sweeps.FakeEngine`` and the port's over the test model of
``test_torch_slots``; no assertion reads a wall-clock window (only counts
fixed by the seeded schedule, parity, and the report's structure).
"""

import argparse
import json

import pytest

from test_sweeps import FakeEngine
from test_torch_slots import (  # noqa: F401
    PROMPTS, TOK, engines, one_torch_thread)

import llm_interpretation_replication_tpu.serve as jserve
import llm_interpretation_replication_tpu.serve.cli as jcli
import llm_interpretation_replication_tpu.serve.load as jload
import llm_interpretation_replication_tpu.utils.telemetry as jtel
import llm_interpretation_replication_tpu_torch.serve as tserve
import llm_interpretation_replication_tpu_torch.serve.cli as tcli
import llm_interpretation_replication_tpu_torch.serve.load as tload
import llm_interpretation_replication_tpu_torch.utils.telemetry as ttel
from llm_interpretation_replication_tpu_torch.runtime import strict

FAST = dict(max_wait_s=0.005)
PKGS = {
    "jax": dict(serve=jserve, cli=jcli, load=jload, tel=jtel),
    "torch": dict(serve=tserve, cli=tcli, load=tload, tel=ttel),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.mark.parametrize("rate,duration,seed", [
    (80.0, 2.0, 7), (5.0, 10.0, 0), (0.5, 30.0, 3), (200.0, 1.5, 11)])
def test_poisson_schedule_identical(rate, duration, seed):
    got = tload.poisson_schedule(rate, duration, seed)
    assert got == jload.poisson_schedule(rate, duration, seed)
    assert got == sorted(got) and all(0.0 < t < duration for t in got)


def test_poisson_schedule_rejects_nonpositive_rate(pkg):
    with pytest.raises(ValueError, match="rate"):
        pkg["load"].poisson_schedule(0.0, 1.0)


def _corpus(tmp_path):
    scenarios = [
        {"original_main": f"Is thing {s} a stuff?",
         "response_format": "Answer only 'Yes' or 'No'.",
         "target_tokens": ["Yes", "No"] if s == 0 else ["No", "Yes"],
         "rephrasings": [f"Is thing {s} variant {i} a stuff?"
                         for i in range(3)]}
        for s in range(2)]
    path = tmp_path / "perturbations.json"
    path.write_text(json.dumps(scenarios))
    return str(path)


@pytest.mark.parametrize("cap", [None, 1, 2])
def test_corpus_workload_identical(tmp_path, cap):
    path = _corpus(tmp_path)
    got = tload.corpus_workload(path, max_rephrasings=cap)
    assert got == jload.corpus_workload(path, max_rephrasings=cap)
    assert got[0][0] == ("Is thing 0 variant 0 a stuff? "
                         "Answer only 'Yes' or 'No'.")


VALUES = [0.05, 0.3, 1.0, 1.7, 2.5, 9.0, 9.5, 33.0, 120.0, 4000.0]


def test_phase_report_identical_on_fixed_histograms():
    reports = {}
    for name, p in PKGS.items():
        load = p["load"]
        snap = p["tel"].hist_snapshot(list(load.HIST_PHASES.values()))
        for k, hist in enumerate(load.HIST_PHASES.values()):
            for v in VALUES:
                p["tel"].record_hist(hist, v * (k + 1))
        reports[name] = load._phase_report(p["tel"].hist_since(snap))
    assert reports["torch"] == reports["jax"]
    assert set(reports["torch"]) == {"queue_wait", "coalesce",
                                     "serve_engine", "respond"}


def _block(knee=20.0, beyond=False, saturated=False, closed=True):
    rates = []
    for o, a, q in zip((10.0, 20.0, 30.0), (10.0, 19.5, 24.0),
                       (6.0, 8.0, 40.0)):
        rates.append({
            "mode": "open", "offered_rate": o, "achieved_rows_per_s": a,
            "shed": 1 if o == 30.0 else 0,
            "latency_ms": {"p50": q / 2, "p90": q * 0.8, "p99": q,
                           "p99.9": q * 1.2},
            "phases_ms": {k: {"p50": 1.0 + i, "p90": 2.0, "p99": 3.0,
                              "p99.9": 4.0, "mean": 1.5}
                          for i, k in enumerate(("queue_wait", "coalesce",
                                                 "serve_engine",
                                                 "respond"))}})
    block = {"mode": "open-loop poisson", "seed": 0, "duration_s": 1.0,
             "rates": rates, "saturation_rows_per_s": 24.0,
             "knee_offered_rate": knee, "knee_beyond_sweep": beyond,
             "knee_floor_saturated": saturated}
    if closed:
        block["closed_loop"] = {"achieved_rows_per_s": 25.5,
                                "concurrency": 4}
    return block


@pytest.mark.parametrize("kw", [
    {}, {"beyond": True, "knee": 30.0}, {"saturated": True, "knee": None},
    {"closed": False}])
def test_format_rate_table_identical(kw):
    block = _block(**kw)
    text = tload.format_rate_table(block)
    assert text == jload.format_rate_table(block)
    assert "saturation 24.0 rows/s" in text


def test_latency_phases_sum_to_e2e(pkg):
    s, tel, load = pkg["serve"], pkg["tel"], pkg["load"]
    h0 = tel.hist_count(load.HIST_E2E)
    with s.Scheduler(FakeEngine("anatomy/model"),
                     s.SchedulerConfig(**FAST)) as sched:
        futs = [sched.submit(s.ScoreRequest(prompt=f"q{i}"))
                for i in range(5)]
        rows = [f.result(timeout=30) for f in futs]
    for f in futs:
        t = f.timing
        assert set(t) == {"e2e_ms", "queue_wait_ms", "coalesce_ms",
                          "serve_engine_ms", "respond_ms"}
        assert all(v >= 0.0 for v in t.values())
        parts = (t["queue_wait_ms"] + t["coalesce_ms"]
                 + t["serve_engine_ms"] + t["respond_ms"])
        assert abs(parts - t["e2e_ms"]) < 1e-6
    assert all("e2e_ms" not in r for r in rows)
    assert tel.hist_count(load.HIST_E2E) == h0 + 5


def test_open_loop_runs_the_seeded_traffic(tmp_path):
    """Both harnesses offer the same arrivals (schedule and prompt picks)
    and answer every request with parity."""
    lines = {}
    for name, p in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        report = p["load"].run_load(
            FakeEngine("det/model"), [f"q{i}" for i in range(7)],
            rate=60.0, duration_s=0.5, seed=11,
            config=p["serve"].SchedulerConfig(**FAST), jsonl=str(path))
        assert report["completed"] == report["requests"] > 10
        assert report["errors"] == report["shed"] == 0
        assert report["parity"]["mismatched_rows"] == 0
        assert report["hist_requests"] == report["completed"]
        assert set(report["phases_ms"]) == {"queue_wait", "coalesce",
                                            "serve_engine", "respond"}
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        lines[name] = [(r["i"], r["scheduled_s"], r["prompt_idx"],
                        r["mode"], r["offered_rate"]) for r in recs]
    assert lines["torch"] == lines["jax"]


def test_closed_loop_comparator(pkg):
    report = pkg["load"].run_load(
        FakeEngine("closed/model"), [f"q{i}" for i in range(5)],
        mode="closed", concurrency=3, duration_s=0.3, seed=0, parity=False,
        config=pkg["serve"].SchedulerConfig(**FAST))
    assert report["mode"] == "closed" and report["offered_rate"] is None
    assert report["concurrency"] == 3 and report["completed"] > 0
    with pytest.raises(ValueError, match="mode"):
        pkg["load"].run_load(FakeEngine("x/y"), ["a"], mode="burst")


def test_rate_sweep_block_structure(pkg):
    block = pkg["load"].rate_sweep(
        FakeEngine("sweep/model"), [f"q{i}" for i in range(5)],
        rates=(32.0, 8.0, 16.0), duration_s=0.3, seed=1,
        config=pkg["serve"].SchedulerConfig(**FAST), closed_comparator=True)
    assert [p["offered_rate"] for p in block["rates"]] == [8.0, 16.0, 32.0]
    for p in block["rates"]:
        assert {"p50", "p90", "p99", "p99.9"} <= set(p["latency_ms"])
        assert p["parity"]["mismatched_rows"] == 0
    assert block["parity_ok"] is True
    assert block["closed_loop"]["mode"] == "closed"
    assert "saturation" in pkg["load"].format_rate_table(block)
    with pytest.raises(ValueError, match=">= 3"):
        pkg["load"].rate_sweep(FakeEngine("x/y"), ["a"], rates=(1.0, 2.0))


def _load_args(tmp_path, rate, **kw):
    return argparse.Namespace(**{
        "load_rate": rate, "load_duration": 0.3, "load_seed": 0,
        "load_jsonl": None, "replay": _corpus(tmp_path),
        "max_rephrasings": None, "input": "-", **kw})


@pytest.mark.parametrize("rate,rc,where", [
    ("40", 0, "out"), ("20,40,80", 0, "out"), ("20,40", 2, "needs >= 3"),
    (",", 2, "no rates")])
def test_load_cli_rates(pkg, tmp_path, capsys, rate, rc, where):
    got = pkg["cli"].run_load_cli(FakeEngine("cli/model"),
                                  _load_args(tmp_path, rate),
                                  pkg["serve"].SchedulerConfig(**FAST))
    assert got == rc
    out = capsys.readouterr()
    if where == "out":
        doc = json.loads(out.out)
        ok = (doc["parity"]["mismatched_rows"] == 0 if "parity" in doc
              else doc["parity_ok"])
        assert ok
    else:
        assert where in out.err


def test_load_over_the_test_model_is_exact_and_strict_clean():
    """The port's harness over the port's engine: rows served under
    offered load equal the offline rows exactly, and strict mode records
    no blocked transfer.  Completions on (the reference engine's default)
    keep every row's decode in its own batch at the fixed batch shape, so
    a row's value does not depend on which requests shared its launch."""
    _, teng = engines(batch_size=4, decode_completions=True,
                      max_new_tokens=12)
    prompts = [p for p in PROMPTS if len(TOK(p)["input_ids"]) <= 32][:6]
    offline = teng.score_prompts(prompts)
    strict.activate(sentry=False)
    try:
        report = tload.run_load(
            teng, prompts, rate=20.0, duration_s=0.5, seed=3,
            config=tserve.SchedulerConfig(**FAST), offline_rows=offline)
    finally:
        strict.deactivate()
    assert report["completed"] == report["requests"] > 3
    assert report["parity"]["mismatched_rows"] == 0
    assert report["blocked_transfers"] == 0
