"""The port's observability layer (``obs/``, ``utils/profiling.py``) against
the JAX package's.

The tracer's semantics (self time, inheritance, threads, the JSONL log's
torn tail, the Chrome export, the disabled no-op) on the port's copy; the
spans the port's engine records against the JAX engine's on the same
calls (tiny Falcon geometry of ``tests/test_torch_sweep.py``, same numpy
weights): equal ``(name, phase, leg)`` sets, equal counts of
``encode_prompts``, ``prefill``, ``launch`` and ``consume`` at
``pipeline_depth`` 1 and 2; traced rows bitwise equal to untraced ones;
``obs report`` and ``obs bench-diff`` output equal to the JAX package's;
and a CPU ``profile_window`` capture that ``top_device_ops`` reads.  Both
tracers are process-wide singletons: every test starts from reset,
disabled tracers and leaves them so.
"""

import collections
import io
import json
import os
import threading
import time

import pytest

from llm_interpretation_replication_tpu import obs as jobs
from llm_interpretation_replication_tpu.obs import benchdiff as jbenchdiff
from llm_interpretation_replication_tpu.obs import report as jreport
from llm_interpretation_replication_tpu.sweeps import perturbation as jsweep
from llm_interpretation_replication_tpu_torch import obs
from llm_interpretation_replication_tpu_torch.obs import benchdiff, report
from llm_interpretation_replication_tpu_torch.obs.profiler import (
    device_memory_snapshot, profile_window)
from llm_interpretation_replication_tpu_torch.runtime.engine import LegSpec
from llm_interpretation_replication_tpu_torch.scoring import packed
from llm_interpretation_replication_tpu_torch.sweeps import perturbation as tsweep
from llm_interpretation_replication_tpu_torch.utils import profiling
from test_torch_slots import one_torch_thread  # noqa: F401
from test_torch_sweep import MODEL, SWEEP_KW, engines, quiet, scenarios

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_tracers():
    for mod in (obs, jobs):
        mod.disable()
        mod.get_tracer().reset()
    yield
    for mod in (obs, jobs):
        mod.disable()
        mod.get_tracer().reset()


# -- the tracer -------------------------------------------------------------

def test_nested_phase_self_time_never_double_counts():
    """A phase span inside another subtracts from the parent's self time;
    a structural (phase=None) span is transparent."""
    obs.enable()
    with obs.span("consume", phase="d2h_fetch"):
        time.sleep(0.02)
        with obs.span("leg", leg="binary"):
            with obs.span("dec", phase="decode"):
                time.sleep(0.03)
    totals = obs.phase_totals(by_leg=True)
    assert 0.025 <= totals["decode"]["binary"] <= 0.09
    assert 0.015 <= totals["d2h_fetch"][""] <= 0.05
    flat = obs.phase_totals()
    assert set(flat) == {"decode", "d2h_fetch"}
    outer = [s for s in obs.get_tracer().spans() if s["name"] == "consume"][0]
    assert abs(sum(flat.values()) - outer["dur"]) < 0.01


def test_leg_and_trace_id_inherit_from_enclosing_span():
    obs.enable()
    with obs.span("outer", leg="confidence", trace_id="sv-7"):
        with obs.span("inner", phase="decode"):
            pass
    inner = [s for s in obs.get_tracer().spans() if s["name"] == "inner"][0]
    assert inner["leg"] == "confidence" and inner["trace_id"] == "sv-7"
    assert obs.phase_totals(by_leg=True)["decode"].keys() == {"confidence"}


def test_thread_safety_and_per_thread_nesting():
    obs.enable()
    n_threads, n_each = 8, 50
    barrier = threading.Barrier(n_threads)

    def hammer():
        barrier.wait()
        for _ in range(n_each):
            with obs.span("outer", phase="host_prep"):
                with obs.span("inner", phase="decode"):
                    pass

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = obs.get_tracer().spans()
    assert len(spans) == n_threads * n_each * 2
    ids = [s["id"] for s in spans]
    assert len(set(ids)) == len(ids)
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] == "inner":
            parent = by_id[s["parent"]]
            assert parent["name"] == "outer" and parent["tid"] == s["tid"]


def test_jsonl_log_truncates_per_session_and_survives_torn_tail(tmp_path,
                                                                 capsys):
    log = tmp_path / "s.jsonl"
    obs.enable(jsonl_path=str(log))
    with obs.span("first", phase="prefill"):
        pass
    obs.disable()
    obs.get_tracer().reset()
    obs.enable(jsonl_path=str(log))
    with obs.span("second", phase="prefill"):
        with obs.span("inner", phase="decode"):
            pass
    obs.disable()
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [s["name"] for s in lines] == ["inner", "second"]   # close order
    for s in lines:
        assert {"name", "phase", "t0", "t1", "dur", "self", "tid",
                "id"} <= set(s)
    with open(log, "a") as f:
        f.write('{"name": "torn", "pha')
    assert [s["name"] for s in report.load_spans(str(log))] == [
        "inner", "second"]
    assert "malformed" in capsys.readouterr().err


def test_chrome_export_parses_and_aggregates_to_the_live_totals(tmp_path):
    log = str(tmp_path / "s.jsonl")
    obs.enable(jsonl_path=log)
    with obs.span("work", phase="d2h_fetch", leg="binary", bucket=64):
        time.sleep(0.005)
        with obs.span("dec", phase="decode"):
            time.sleep(0.005)
    obs.disable()
    path = obs.export_chrome(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    ev = [e for e in doc["traceEvents"] if e["name"] == "work"][0]
    assert ev["ph"] == "X" and ev["cat"] == "d2h_fetch"
    assert ev["dur"] >= 4000 and ev["args"]["leg"] == "binary"
    assert ev["args"]["bucket"] == 64
    live = obs.phase_totals(by_leg=True)
    for p in (log, path):
        agg = report.aggregate_spans(report.load_spans(p))
        assert set(agg) == set(live)
        for phase in live:
            for leg in live[phase]:
                assert agg[phase][leg] == pytest.approx(live[phase][leg],
                                                        abs=2e-4)


def test_disabled_tracer_is_a_cheap_no_op():
    assert not obs.enabled()
    t0 = time.perf_counter()
    for _ in range(20_000):
        with obs.span("hot", phase="decode", bucket=64) as rec:
            assert rec is None
    assert time.perf_counter() - t0 < 2.0
    assert obs.phase_totals() == {} and obs.get_tracer().spans() == []


def test_exports_match_reference():
    assert obs.__all__ == jobs.__all__
    for name in obs.__all__:
        assert callable(getattr(obs, name))


# -- the engine's spans against the JAX engine's -----------------------------

def _traced(mod, fn):
    mod.get_tracer().reset()
    mod.enable()
    try:
        fn()
    finally:
        mod.disable()
    return mod.get_tracer().spans()


def _calls(eng, sweep_mod, tmp):
    scen = scenarios()
    prompts = [f"{r} {s['response_format']}" for s in scen
               for r in s["rephrasings"]][:8]
    targets = [list(s["target_tokens"]) for s in scen
               for _ in s["rephrasings"]][:8]
    pairs = [(r, (" " + s["response_format"], " " + s["confidence_format"]))
             for s in scen for r in s["rephrasings"]][:8]
    legs = [LegSpec("binary"),
            LegSpec("confidence", with_confidence=True, max_new_tokens=6)]
    return {
        "score_prompts": lambda: eng.score_prompts(prompts, targets),
        "score_prefixed": lambda: eng.score_prefixed(pairs, targets,
                                                     legs=legs),
        "score_packed": lambda: eng.score_packed(
            packed.build_packs(prompts, 4, [t[0] for t in targets]),
            targets),
        "sweep": lambda: sweep_mod.run_model_perturbation_sweep(
            eng, MODEL, scen, str(tmp / f"{id(eng)}.xlsx"), log=quiet(),
            **SWEEP_KW),
    }


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_spans_match_reference(tmp_path, depth):
    """Each call's spans in the port against the JAX engine's: the same
    ``(name, phase, leg)`` set, and the same number of ``encode_prompts``,
    ``prefill``, ``launch`` and ``consume`` spans (on these calls every
    other name's count agrees as well: ``next_batch``, the legs'
    ``extend_prefill`` and ``consume_leg``, ``completion_decode``,
    ``pool_flush``, ``packed_prefill``, the sweep's ``prefetch``,
    ``checkpoint_flush`` and ``build_rows``)."""
    jeng, teng = engines(pipeline_depth=depth, buckets=(32, 48, 64, 192))
    tcalls, jcalls = _calls(teng, tsweep, tmp_path), _calls(jeng, jsweep,
                                                            tmp_path)
    for name in tcalls:
        tspans = _traced(obs, tcalls[name])
        jspans = _traced(jobs, jcalls[name])
        tset = {(s["name"], s["phase"], s["leg"]) for s in tspans}
        jset = {(s["name"], s["phase"], s["leg"]) for s in jspans}
        assert tset == jset, (name, tset ^ jset)
        tcount = collections.Counter(s["name"] for s in tspans)
        jcount = collections.Counter(s["name"] for s in jspans)
        for key in ("encode_prompts", "prefill", "launch", "consume"):
            assert tcount[key] == jcount[key], (name, key, tcount, jcount)
        # and every other name's count too, here
        assert tcount == jcount, (name, tcount, jcount)
        assert {s["phase"] for s in tspans} <= obs.tracer.KNOWN_PHASES


def test_tracing_changes_no_row(tmp_path):
    """Rows untraced, traced, and traced with ``sync=True`` are equal."""
    _, teng = engines(buckets=(32, 48, 64, 192))
    calls = _calls(teng, tsweep, tmp_path)
    del calls["sweep"]
    for name, fn in calls.items():
        plain = fn()
        obs.enable()
        traced = fn()
        obs.disable()
        obs.enable(sync=True, memory=True)
        synced = fn()
        obs.disable()
        assert plain == traced == synced, name
    assert obs.get_tracer().spans()


# -- obs report and bench-diff ----------------------------------------------

def test_obs_report_matches_reference(tmp_path, capsys):
    """The port's ``obs report`` over a trace the port wrote prints what
    the JAX package's prints over the same file, in both formats and both
    export formats."""
    _, teng = engines()
    log = str(tmp_path / "spans.jsonl")
    obs.enable(jsonl_path=log)
    _calls(teng, tsweep, tmp_path)["score_prefixed"]()
    obs.disable()
    chrome = obs.export_chrome(str(tmp_path / "trace.json"))
    capsys.readouterr()
    for path in (log, chrome):
        for extra in ([], ["--format", "json", "--wall-s", "2", "--rows",
                           "8"]):
            argv = ["report", "--trace", path, *extra]
            assert report.main(argv) == 0
            got = capsys.readouterr().out
            assert jreport.main(argv) == 0
            want = capsys.readouterr().out
            assert got == want and "extend_prefill" in got
    assert report.main(["report", "--trace",
                        str(tmp_path / "missing.jsonl")]) == 2


def test_cli_routes_obs_before_argparse(tmp_path, capsys):
    from llm_interpretation_replication_tpu_torch.__main__ import main

    log = str(tmp_path / "s.jsonl")
    obs.enable(jsonl_path=log)
    with obs.span("dec", phase="decode", leg="binary"):
        pass
    obs.disable()
    with pytest.raises(SystemExit) as exc:
        main(["obs", "report", "--trace", log])
    assert exc.value.code == 0
    assert "decode" in capsys.readouterr().out


@pytest.mark.parametrize("names", [
    ("r01", "r02"), ("r04", "r05"), ("r05", "r04"),
    ("r01", "r02", "r03", "r04", "r05")])
def test_benchdiff_matches_reference(names, capsys):
    """``diff_records`` + ``format_diff_table`` over the repo's bench
    records, byte for byte the JAX package's; the CLI's exit code too."""
    paths = [os.path.join(ROOT, f"BENCH_{n}.json") for n in names]
    recs = [benchdiff.load_bench_record(p) for p in paths]
    jrecs = [jbenchdiff.load_bench_record(p) for p in paths]
    assert recs == jrecs
    diff = benchdiff.diff_records(recs, threshold_pct=5.0)
    assert diff == jbenchdiff.diff_records(jrecs, threshold_pct=5.0)
    assert (benchdiff.format_diff_table(diff)
            == jbenchdiff.format_diff_table(diff))
    rc = report.main(["bench-diff", *paths])
    got = capsys.readouterr().out
    assert rc == jreport.main(["bench-diff", *paths])
    assert got == capsys.readouterr().out


# -- the profiler ------------------------------------------------------------

def test_profile_window_capture_reads_back_largest_first(tmp_path, capsys):
    import torch

    obs.enable()
    with profile_window(str(tmp_path / "prof")) as started:
        a = torch.ones(192, 192)
        for _ in range(4):
            b = a @ a
            torch.softmax(b, dim=-1)
    obs.disable()
    assert started is True
    assert "profiler capture written" in capsys.readouterr().err
    top = profiling.top_device_ops(str(tmp_path / "prof"), top_n=5)
    assert 0 < len(top) <= 5
    assert [ms for _, ms in top] == sorted((ms for _, ms in top),
                                           reverse=True)
    events = profiling.device_op_events(str(tmp_path / "prof"))
    assert events["aten::softmax"][0] == 4
    assert any(name.startswith("aten::") for name, _ in top)
    # no card: no memory snapshot and no device_memory span
    assert device_memory_snapshot("cpu") == []
    with profile_window(None) as started:
        assert started is False


def test_profile_window_degrades_when_the_profiler_cannot_start(
        tmp_path, monkeypatch, capsys):
    import torch

    def refuse(*a, **k):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with profile_window(str(tmp_path / "p")) as started:
        pass
    assert started is False
    assert "window runs unprofiled" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        profiling.top_device_ops(str(tmp_path / "p"))


def test_annotate_names_a_region_and_meter_counts():
    import torch

    with torch.profiler.profile() as prof:
        with profiling.annotate("my-region"):
            torch.ones(4) + 1
    assert any(e.name == "my-region" for e in prof.events())
    clock = iter([0.0, 2.0])
    meter = profiling.ThroughputMeter(n_chips=1, clock=lambda: next(clock))
    meter.add(10, tokens=40)
    snap = meter.snapshot()
    assert snap["prompts_per_sec"] == 5.0 and snap["tokens_per_sec"] == 20.0


def test_logging_heartbeat_delegates_to_metrics():
    from llm_interpretation_replication_tpu_torch.obs import metrics
    from llm_interpretation_replication_tpu_torch.utils.logging import heartbeat

    lines = []
    out = heartbeat("m-x", 3, 12, 1.5, io.StringIO().write)
    out2 = heartbeat("m-x", 3, 12, 1.5, lines.append)
    assert out == out2 == lines[0] == ("[heartbeat] m-x: 3/12 rows | 2.00 "
                                       "rows/s | ETA 4s")
    assert 'llm_interp_sweep_progress_rows{label="m-x"} 3' in \
        metrics.prometheus_text()
