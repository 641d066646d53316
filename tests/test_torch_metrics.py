"""The port's run-health layer (``obs/metrics.py``, ``obs/flight.py``)
against the JAX package's.

The same counters, rings, histograms and gauges go into both packages'
telemetry and registries: the Prometheus text and the JSONL samples must
be equal (the samples but for their timestamps), and so must the
``[heartbeat]`` line.  ``MetricsServer`` serves ``/metrics`` and
``/healthz`` on a loopback port 0.  The flight recorder writes a
``flightrec-*.json`` on a trigger fault (an injected OOM on the engine's
ladder, a preempted sweep), rate-limited per kind; the stall watchdog
trips after k x the trailing median chunk time, once, and resets on the
next beat.  Both packages' telemetry is process-wide: each test starts
from cleared counters, rings and histograms and disarmed recorders.
"""

import json
import os
import signal
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from llm_interpretation_replication_tpu.obs import flight as jflight
from llm_interpretation_replication_tpu.obs import metrics as jmetrics
from llm_interpretation_replication_tpu.utils import telemetry as jtel
from llm_interpretation_replication_tpu_torch.obs import flight, metrics
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.runtime import faults
from llm_interpretation_replication_tpu_torch.sweeps import perturbation as tsweep
from llm_interpretation_replication_tpu_torch.utils import telemetry as ttel
from test_torch_slots import one_torch_thread  # noqa: F401
from test_torch_sweep import MODEL, SWEEP_KW, engines, quiet, scenarios


def _clear(tel):
    tel.clear_counters()
    tel.clear_samples()
    tel.clear_hists()


@pytest.fixture(autouse=True)
def _fresh_state():
    for fl, me, tel in ((flight, metrics, ttel), (jflight, jmetrics, jtel)):
        fl.get_recorder().wait()
        fl.disable()
        _clear(tel)
        me.get_registry().reset()
    yield
    for fl, me, tel in ((flight, metrics, ttel), (jflight, jmetrics, jtel)):
        fl.get_recorder().wait()
        fl.disable()
        me.get_registry().reset()
        _clear(tel)


def _feed(tel, registry, seed):
    """One seeded sequence of counters (a labeled twin among them),
    samples, histogram observations and gauges."""
    rng = np.random.default_rng(seed)
    for i in range(5):
        tel.record_counter("slot_rows", int(rng.integers(1, 9)))
        tel.record_counter("slot_rows|leg=binary,workload=engine", 2)
        tel.record_counter("odd.name/x-1", 1)
    for v in rng.lognormal(1.0, 0.8, 300):
        tel.record_sample("queue_wait_ms", float(v))
        tel.record_hist("accepted_k", float(v))
    tel.record_hist("latency|replica=r0,model=m", 3.5)
    registry.set_gauge("sweep_rows_per_s", 12.5, {"label": "tiny"})
    registry.set_gauge("sweep_rows_per_s", 3.0, {"label": 'a"b\\c\nd'})
    registry.set_gauge("plain_gauge", float(rng.integers(0, 100)))


@pytest.mark.parametrize("seed", [0, 1])
def test_prometheus_text_matches_reference(seed):
    _feed(ttel, metrics.get_registry(), seed)
    _feed(jtel, jmetrics.get_registry(), seed)
    text = metrics.prometheus_text()
    assert text == jmetrics.prometheus_text()
    assert "# TYPE llm_interp_slot_rows counter" in text
    assert 'llm_interp_slot_rows{leg="binary",workload="engine"} 10' in text
    assert "# TYPE llm_interp_queue_wait_ms summary" in text
    assert "# TYPE llm_interp_accepted_k histogram" in text
    assert 'llm_interp_sweep_rows_per_s{label="a\\"b\\\\c\\nd"} 3' in text
    assert "llm_interp_odd_name_x_1 5" in text
    assert "never_recorded" not in text


def test_jsonl_samples_match_reference(tmp_path):
    docs = {}
    for name, tel, me in (("t", ttel, metrics), ("j", jtel, jmetrics)):
        reg = me.MetricsRegistry()
        path = str(tmp_path / f"{name}.jsonl")
        reg.enable_jsonl(path)
        _feed(tel, reg, 3)
        reg.sample()
        tel.record_counter("slot_rows", 4)
        reg.sample()
        reg.disable_jsonl()
        with open(path) as f:
            docs[name] = [json.loads(line) for line in f]
        assert reg.series_type("slot_rows") == "counter"
        assert [v for _, v in reg.series("slot_rows")] == [
            docs[name][0]["counters"]["slot_rows"],
            docs[name][1]["counters"]["slot_rows"]]
    assert len(docs["t"]) == 2
    for a, b in zip(docs["t"], docs["j"]):
        assert set(a) == set(b) == {"t", "uptime_s", "counters",
                                    "counters_delta", "rings", "hists",
                                    "gauges"}
        for key in set(a) - {"t", "uptime_s"}:
            assert a[key] == b[key], key


@pytest.mark.parametrize("args,kw", [
    (("falcon-7b", 40, 100, 2.0), {}),
    (("m[packed4]", 0, 120, 0.0), {}),
    (("instruct_sweep", 2, 10, 30.0),
     dict(unit="models", rate=66.7, rate_unit="rows", eta_s=120.0)),
])
def test_heartbeat_line_and_gauges_match_reference(args, kw):
    lines, jlines = [], []
    out = metrics.heartbeat(*args, log=lines.append, **kw)
    jout = jmetrics.heartbeat(*args, log=jlines.append, **kw)
    assert out == jout and lines == jlines == [out]
    assert metrics.prometheus_text() == jmetrics.prometheus_text()
    assert f'llm_interp_sweep_progress_total{{label="{args[0]}"}}' in \
        metrics.prometheus_text()


def test_heartbeat_beats_the_active_watchdog():
    wd = flight.StallWatchdog(label="hb")
    flight._set_active_watchdog(wd)
    try:
        for i in range(3):
            metrics.heartbeat("m", i + 1, 10, 1.0 + i)
        assert wd._last_beat is not None and len(wd._intervals) == 2
    finally:
        flight._clear_active_watchdog(wd)


def test_metrics_server_serves_on_loopback_port_zero():
    ttel.record_counter("tsrv_ctr", 1)
    reg = metrics.MetricsRegistry()
    with metrics.MetricsServer(reg, 0, healthz_fn=lambda: {"depth": 3}) \
            as srv:
        assert srv.host == "127.0.0.1" and srv.port > 0
        url = f"http://127.0.0.1:{srv.port}"
        resp = urllib.request.urlopen(url + "/metrics")
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        assert "llm_interp_tsrv_ctr 1" in resp.read().decode()
        doc = json.loads(urllib.request.urlopen(url + "/healthz").read())
        assert doc["status"] == "ok" and doc["depth"] == 3
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url + "/nope")
        assert exc.value.code == 404

    def broken():
        raise RuntimeError("introspection failed")

    with metrics.MetricsServer(reg, 0, healthz_fn=broken) as srv:
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/healthz").read())
    assert doc["status"] == "degraded" and "introspection" in doc["error"]


def test_sweep_routes_progress_through_the_registry(tmp_path):
    _, teng = engines()
    logged = []
    metrics.enable_jsonl(str(tmp_path / "m.jsonl"))
    tsweep.run_model_perturbation_sweep(
        teng, MODEL, scenarios(), str(tmp_path / "out.xlsx"),
        log=logged.append, **SWEEP_KW)
    metrics.get_registry().disable_jsonl()
    beats = [line for line in logged if line.startswith("[heartbeat]")]
    assert len(beats) == 3 and beats[-1].startswith(
        f"[heartbeat] {MODEL}: 15/15 rows")
    text = metrics.prometheus_text()
    assert f'llm_interp_sweep_progress_rows{{label="{MODEL}"}} 15' in text
    with open(tmp_path / "m.jsonl") as f:
        samples = [json.loads(line) for line in f]
    assert [s["gauges"][f'sweep_progress_rows{{label="{MODEL}"}}']
            for s in samples] == [6, 12, 15]


# -- the stall watchdog -------------------------------------------------------

def _fed(mod, intervals, **kw):
    clk = {"t": 0.0}
    wd = mod.StallWatchdog(label="wd-test", clock=lambda: clk["t"], **kw)
    wd.beat(0)
    for i, dt in enumerate(intervals):
        clk["t"] += dt
        wd.beat(i + 1)
    return wd, clk


def test_watchdog_trips_after_k_times_the_median(capsys):
    wd, clk = _fed(flight, [1.0, 1.0, 3.0, 1.0], floor_s=1.0)
    jwd, _ = _fed(jflight, [1.0, 1.0, 3.0, 1.0], floor_s=1.0)
    assert wd.threshold_s() == jwd.threshold_s() == 4.0
    snap = len(ttel.fault_events("watchdog_stall"))
    assert wd.check(now=clk["t"] + 3.9) is False
    assert wd.check(now=clk["t"] + 4.1) is True
    assert wd.check(now=clk["t"] + 20.0) is False       # once a stall
    events = ttel.fault_events("watchdog_stall")[snap:]
    assert len(events) == 1 and events[0]["threshold_s"] == 4.0
    assert "no progress" in capsys.readouterr().err
    clk["t"] += 30.0
    wd.beat(99)
    assert wd.check(now=clk["t"] + 0.5) is False and wd.trips == 1
    short, clk2 = _fed(flight, [2.0], floor_s=0.1)
    assert short.threshold_s() is None
    assert short.check(now=clk2["t"] + 1e4) is False    # start-up never trips
    fast, _ = _fed(flight, [0.001] * 5, floor_s=5.0)
    assert fast.threshold_s() == 5.0


# -- the flight recorder ------------------------------------------------------

def test_injected_engine_oom_dumps_a_flight_record(tmp_path, monkeypatch):
    _, teng = engines(oom_batch_ladder=(2,), oom_batch_floor=1)
    real = tengine.dmod.prefill

    def oom_above_two(params, cfg, ids, *a, **k):
        if ids.shape[0] > 2:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(params, cfg, ids, *a, **k)

    monkeypatch.setattr(tengine.dmod, "prefill", oom_above_two)
    flight.enable(str(tmp_path))
    prompts = [f"{r} {s['response_format']}" for s in scenarios()
               for r in s["rephrasings"]][:6]
    rows = teng.score_prompts(prompts)
    assert len(rows) == 6 and all(r["success"] for r in rows)
    flight.get_recorder().wait()
    dumps = sorted(tmp_path.glob("flightrec-engine_oom_backoff-*.json"))
    assert len(dumps) == 1                        # one ladder walk, one dump
    doc = json.loads(dumps[0].read_text())
    assert doc["reason"] == "engine_oom_backoff"
    assert doc["trigger"]["new_batch"] == 2
    assert {"counters", "rings", "memory", "fault_events",
            "frames"} <= set(doc)


def test_preempted_sweep_leaves_a_record_next_to_its_workbook(tmp_path):
    _, teng = engines()
    out = tmp_path / "out.xlsx"

    class Preempting:
        def __init__(self, eng):
            self._eng = eng

        def __getattr__(self, name):
            return getattr(self._eng, name)

        def score_prefixed(self, *a, **k):
            os.kill(os.getpid(), signal.SIGTERM)
            return self._eng.score_prefixed(*a, **k)

    with pytest.raises(SystemExit):
        tsweep.run_model_perturbation_sweep(
            Preempting(teng), MODEL, scenarios(), str(out), log=quiet(),
            **SWEEP_KW)
    flight.get_recorder().wait()
    dumps = sorted(tmp_path.glob("flightrec-preempted-*.json"))
    assert len(dumps) == 1
    assert json.loads(dumps[0].read_text())["trigger"]["label"] == \
        "perturbation"


def test_cooldown_and_disarmed_recorder(tmp_path):
    rec = flight.FlightRecorder(cooldown_s=60.0)
    assert rec.dump("preempted") is None              # disarmed
    rec.note("heartbeat", done=1)
    assert rec._frames == []
    rec.enable(str(tmp_path))
    try:
        rec.note("heartbeat", done=2)
        assert rec.dump("watchdog_stall") is not None
        assert rec.dump("watchdog_stall") is None       # cooldown
        assert rec.dump("preempted") is not None        # per kind
    finally:
        rec.disable()
    assert len(list(tmp_path.glob("flightrec-*.json"))) == 2
    assert flight.TRIGGER_KINDS == jflight.TRIGGER_KINDS
    assert flight.TRIGGER_KINDS <= ttel.FAULT_KINDS


def test_transient_exhaustion_is_a_trigger(tmp_path):
    from llm_interpretation_replication_tpu_torch.utils.retry import RetryPolicy

    flight.enable(str(tmp_path))

    def always():
        raise faults.TransientError("injected transient")

    fast = RetryPolicy(max_retries=2, initial_delay=0.001, max_delay=0.002)
    with pytest.raises(faults.TransientError):
        faults.retry_transient(always, fast, label="texh")()
    flight.get_recorder().wait()
    assert sorted(tmp_path.glob("flightrec-transient_exhausted-*.json"))
