"""The port's engine pool, supervisor and engine teardown against the JAX
package's (``tests/test_pool.py``).

Router, hot swap, failover, breaker, routing and health tests run on both
packages' pools over ``test_sweeps.FakeEngine`` (rows from a hash of the
prompt), parametrized by package.  Over the real test model
(``test_torch_slots``: ``FLAGSHIP_SMALL_GEOMETRY`` in float32, the
reference's ``random_decoder_params`` carried across by
``params_from_jax``, ``WordTokenizer`` targets) the port's pool is held
against the port's offline rows exactly (``rows_equal``) and against the
JAX pool at the classes (verdicts identical, probabilities rtol 2e-5, the
handoff counters equal).

The prefill/decode handoff sets its slot rings' compositions by thread
timing; a row's scores do not depend on them (the engine's decode sums
the slot axis in float64 and runs every ring at its capacity), so the
role tests hold the handed-off rows exactly against one offline call.

The vendor constructors (``RemoteBackend.openai``, ``.gemini``,
``.anthropic``) run over each package's ``FakeTransport``: the JAX
package's remote-backend cases (row contract, cost- and latency-weighted
routing, deadlines without spending, typed remote failures) on both
packages, and the port's rows, requests and spend against the JAX
package's for each vendor.

Replicas on rank slices (``devices=``) run: the shared placement of one
rank here, the sliced one on gloo ranks in ``tests/test_torch_mesh_serve.py``.
Waiting for the port bench: the bench's ``--serve-load`` blocks.  The plan search's
``replica_plan`` is ported (``runtime/plan_search.py``;
``tests/test_torch_plan_search.py``).
"""

import io
import json
import threading
import time
import types

import numpy as np
import pytest

from test_sweeps import FakeEngine
from test_torch_engine import PROB_FIELDS, RTOL
from test_torch_slots import (  # noqa: F401
    PROMPTS, TOK, engines, models, one_torch_thread, targets)

import llm_interpretation_replication_tpu.api_backends as japi
import llm_interpretation_replication_tpu.serve as jserve
import llm_interpretation_replication_tpu.serve.cli as jcli
import llm_interpretation_replication_tpu.utils.telemetry as jtel
import llm_interpretation_replication_tpu.utils.testing as jtesting
import llm_interpretation_replication_tpu_torch.api_backends as tapi
import llm_interpretation_replication_tpu_torch.serve as tserve
import llm_interpretation_replication_tpu_torch.serve.cli as tcli
import llm_interpretation_replication_tpu_torch.utils.telemetry as ttel
import llm_interpretation_replication_tpu_torch.utils.testing as ttesting
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.runtime import strict
from llm_interpretation_replication_tpu_torch.serve import load as tload
from llm_interpretation_replication_tpu_torch.serve import pool as tpool

PKGS = {
    "jax": dict(serve=jserve, cli=jcli, tel=jtel, testing=jtesting,
                api=japi),
    "torch": dict(serve=tserve, cli=tcli, tel=ttel, testing=ttesting,
                  api=tapi),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def fast_pool(s, **kw):
    return s.EnginePool(s.PoolConfig(
        scheduler=s.SchedulerConfig(max_batch=4, max_wait_s=0.005), **kw))


def sup_pool(s, **kw):
    sup = s.SupervisorConfig(rebuild_backoff_initial_s=0.05,
                             rebuild_backoff_max_s=0.2, poll_s=0.01, **kw)
    return s.EnginePool(s.PoolConfig(
        scheduler=s.SchedulerConfig(max_batch=4, max_wait_s=0.005),
        supervision=sup))


def _wait_for(cond, timeout_s=8.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


class SlowEngine(FakeEngine):
    def __init__(self, model_name, delay_s=0.01):
        super().__init__(model_name)
        self.delay_s = delay_s

    def score_prompts(self, prompts, targets=("Yes", "No"),
                      with_confidence=False, max_new_tokens=None):
        time.sleep(self.delay_s)
        return super().score_prompts(prompts, targets, with_confidence,
                                     max_new_tokens)


# -- routing and hot swap (both packages) -------------------------------------

def test_per_model_queues_route_to_their_own_engines(pkg):
    s = pkg["serve"]
    alpha, beta = FakeEngine("fake/alpha-7b"), FakeEngine("fake/beta-7b")
    ref_a, ref_b = (e.score_prompts(["q0", "q1"]) for e in (alpha, beta))
    with fast_pool(s) as pool:
        pool.load("alpha", alpha)
        pool.load("beta", beta)
        fa = [pool.submit(s.ScoreRequest(prompt=f"q{i}"), model="alpha")
              for i in range(2)]
        fb = [pool.submit(s.ScoreRequest(prompt=f"q{i}", model="beta"))
              for i in range(2)]
        rows_a = [f.result(timeout=30) for f in fa]
        rows_b = [f.result(timeout=30) for f in fb]
    assert all(s.rows_equal(g, w) for g, w in zip(rows_a, ref_a))
    assert all(s.rows_equal(g, w) for g, w in zip(rows_b, ref_b))


def test_typed_errors_of_the_front_door(pkg):
    s = pkg["serve"]
    pool = fast_pool(s)
    pool.load("alpha", FakeEngine("fake/alpha-7b"))
    with pytest.raises(s.UnknownModel):
        pool.submit(s.ScoreRequest(prompt="x"), model="nope")
    assert pool.submit(s.ScoreRequest(prompt="q0")).result(
        timeout=30)["success"]                    # the one model resolves
    pool.close()
    with pytest.raises(s.PoolClosed):
        pool.submit(s.ScoreRequest(prompt="x"), model="alpha")


def test_pool_queue_deadline_backpressure_and_priority(pkg):
    s = pkg["serve"]
    order = []

    class LoggingEngine(FakeEngine):
        def score_prompts(self, prompts, *a, **kw):
            order.extend(prompts)
            return super().score_prompts(prompts, *a, **kw)

    cfg = s.SchedulerConfig(max_batch=1, max_wait_s=0.005, queue_capacity=3)
    with s.EnginePool(s.PoolConfig(scheduler=cfg)) as pool:
        r0 = pool.load("alpha", FakeEngine("fake/alpha-7b"))
        pool.unload(r0.rid)                  # the swap window: nothing live
        late = pool.submit(s.ScoreRequest(prompt="x", timeout_s=0.05),
                           model="alpha")
        assert isinstance(late.exception(timeout=10), s.DeadlineExceeded)
        futs = [pool.submit(s.ScoreRequest(prompt="low", priority=0),
                            model="alpha"),
                pool.submit(s.ScoreRequest(prompt="high", priority=5),
                            model="alpha"),
                pool.submit(s.ScoreRequest(prompt="mid", priority=1),
                            model="alpha")]
        with pytest.raises(s.QueueFull):
            pool.submit(s.ScoreRequest(prompt="over"), model="alpha")
        doc = pool.health()
        assert doc["status"] == "degraded"
        assert "no live replica" in doc["degraded_reason"]
        pool.load("alpha", LoggingEngine("fake/alpha-7b"))
        for f in futs:
            assert f.result(timeout=30)["success"]
    assert order == ["high", "mid", "low"]


def test_unload_mid_traffic_drops_nothing(pkg):
    s = pkg["serve"]
    ea = SlowEngine("fake/alpha-7b", delay_s=0.005)
    eb = SlowEngine("fake/alpha-7b", delay_s=0.005)
    with fast_pool(s) as pool:
        ra = pool.load("alpha", ea)
        pool.load("alpha", eb)
        futs, stop = [], threading.Event()

        def traffic():
            for i in range(200):
                if stop.is_set():
                    return
                futs.append(pool.submit(s.ScoreRequest(prompt=f"w{i}"),
                                        model="alpha"))
                time.sleep(0.002)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        assert _wait_for(lambda: len(futs) >= 20)
        pool.unload(ra.rid)                  # hot: eb keeps serving
        assert _wait_for(lambda: len(futs) >= 40)
        stop.set()
        t.join(timeout=5)
        rows = [f.result(timeout=60) for f in futs]
    assert futs and all(r["success"] for r in rows)
    assert eb.calls > 0 and len(pool.replicas()) == 0


def test_roles_route_fresh_prompts_off_decode_replicas(pkg):
    s, tel = pkg["serve"], pkg["tel"]
    tel.clear_counters()
    with fast_pool(s) as pool:
        pool.load("alpha", FakeEngine("fake/alpha-7b"), role="prefill")
        pool.load("alpha", FakeEngine("fake/alpha-7b"), role="decode")
        futs = [pool.submit(s.ScoreRequest(prompt=f"q{i}"), model="alpha")
                for i in range(6)]
        assert all(f.result(timeout=60)["success"] for f in futs)
        docs = {d["role"]: d for d in (r.health(0) for r in pool.replicas())}
        with pytest.raises(ValueError):
            pool.load("alpha", FakeEngine("fake/alpha-7b"), role="draft")
    assert docs["prefill"]["completed"] == 6
    assert docs["decode"]["completed"] == 0
    assert tel.counter("pool_decode_fallback") == 0
    with fast_pool(s) as pool:
        pool.load("alpha", FakeEngine("fake/alpha-7b"), role="decode")
        assert pool.submit(s.ScoreRequest(prompt="q"),
                           model="alpha").result(timeout=60)["success"]
    assert tel.counter("pool_decode_fallback") >= 1


# -- supervision (both packages) ---------------------------------------------

def test_failover_matrix_answers_every_request_exactly(pkg):
    """A replica killed mid-traffic: every request answered once, rows
    equal the no-fault rows, the crashed lineage rebuilds."""
    s, testing = pkg["serve"], pkg["testing"]
    ref = FakeEngine("tiny")
    prompts = [f"q{i}" for i in range(12)]
    offline = ref.score_prompts(prompts)
    victim = testing.BreakableEngine(FakeEngine("tiny"))
    sibling = testing.BreakableEngine(FakeEngine("tiny"))
    pool = sup_pool(s)
    try:
        pool.load("tiny", victim)
        pool.load("tiny", sibling)
        pool.supervisor.register_rebuild(
            "tiny", lambda: testing.BreakableEngine(FakeEngine("tiny")))
        victim.kill()
        futs = [pool.submit(s.ScoreRequest(prompt=p), model="tiny")
                for p in prompts]
        rows = [f.result(timeout=60) for f in futs]
        rep = pool.supervisor.report()
        assert all(s.rows_equal(a, b) for a, b in zip(rows, offline))
        assert rep["crashes"] >= 1 and rep["requests_failed_over"] >= 1
        assert rep["requests_lost"] == 0
        assert _wait_for(lambda: pool.supervisor.report()["restarts"] >= 1)
    finally:
        victim.heal()
        sibling.heal()
        pool.close()


def test_poison_row_ceiling(pkg):
    s, testing = pkg["serve"], pkg["testing"]
    engs = [testing.BreakableEngine(FakeEngine("tiny"),
                                    poison_marker="POISONROW")
            for _ in range(3)]
    pool = sup_pool(s)
    try:
        for eng in engs:
            pool.load("tiny", eng)
        fut = pool.submit(s.ScoreRequest(prompt="a POISONROW record"),
                          model="tiny")
        with pytest.raises(s.PoisonousRequest):
            fut.result(timeout=60)
        assert pool.supervisor.report()["poison_rejects"] == 1
        assert sum(1 for e in engs if e.crashes > 0) == 2
        assert pool.submit(s.ScoreRequest(prompt="clean"),
                           model="tiny").result(timeout=60)["success"]
    finally:
        pool.close()


def test_wedge_detection_reclaims_and_rebuilds(pkg):
    s, testing = pkg["serve"], pkg["testing"]
    wedged = testing.BreakableEngine(SlowEngine("tiny"))
    healthy = testing.BreakableEngine(SlowEngine("tiny"))
    pool = sup_pool(s, wedge_timeout_s=0.3)
    try:
        pool.load("tiny", wedged)
        pool.load("tiny", healthy)
        pool.supervisor.register_rebuild(
            "tiny", lambda: testing.BreakableEngine(SlowEngine("tiny")))
        wedged.wedge()
        futs = [pool.submit(s.ScoreRequest(prompt=f"q{i}"), model="tiny")
                for i in range(8)]
        assert _wait_for(lambda: pool.supervisor.report()["wedges"] >= 1)
        wedged.heal()
        assert all(f.result(timeout=120)["success"] for f in futs)
        rep = pool.supervisor.report()
        assert rep["wedges"] == 1 and rep["requests_lost"] == 0
        assert _wait_for(lambda: pool.supervisor.report()["restarts"] >= 1)
    finally:
        wedged.heal()
        healthy.heal()
        pool.close()


def test_vendor_breaker_opens_sheds_and_recloses(pkg):
    s, testing = pkg["serve"], pkg["testing"]
    vendor = testing.FlakyVendor()
    pool = sup_pool(s, breaker_failure_threshold=3, breaker_cooldown_s=0.2)
    try:
        pool.load("m", testing.BreakableEngine(FakeEngine("m")))
        pool.load_remote(s.RemoteBackend("m", vendor), model="m")
        vendor.down = True
        futs = [pool.submit(s.ScoreRequest(prompt=f"q{i}"), model="m")
                for i in range(20)]
        assert all(f.result(timeout=120) is not None for f in futs)
        assert _wait_for(
            lambda: "open" in pool.supervisor.breaker_states().values())
        assert vendor.failures >= 3
        vendor.down = False
        assert _wait_for(lambda: (
            pool.submit(s.ScoreRequest(prompt="probe"),
                        model="m").result(timeout=60) is not None
            and all(v == "closed"
                    for v in pool.supervisor.breaker_states().values())),
            timeout_s=15.0)
    finally:
        pool.close()


# -- remote backends over an injected evaluate (both packages) ----------------

def _vendor(calls, name, yes=0.8, no=0.2, usage=True):
    def evaluate(prompt, targets, with_confidence, max_new_tokens):
        calls.append(name)
        out = {"yes_prob": yes, "no_prob": no, "response": "Yes"}
        if usage:
            out["raw"] = {"usage": {"prompt_tokens": 10,
                                    "completion_tokens": 2}}
        return out
    return evaluate


def test_vendor_row_matches_result_contract(pkg):
    s = pkg["serve"]
    backend = s.RemoteBackend("gpt-cheap", _vendor([], "gpt-cheap"),
                              pricing={"gpt-cheap": {"input": 1,
                                                     "output": 2}})
    with fast_pool(s) as pool:
        pool.load_remote(backend)
        row = pool.submit(s.ScoreRequest(prompt="Is soup a beverage?"),
                          model="gpt-cheap").result(timeout=30)
    assert row == {"yes_prob": 0.8, "no_prob": 0.2,
                   "relative_prob": 0.8 / (0.8 + 0.2),
                   "odds_ratio": 0.8 / 0.2, "scan_found": True,
                   "completion": "Yes", "success": True}
    assert backend.tracker.summary()["gpt-cheap"]["requests"] == 1
    assert backend.tracker.cost("gpt-cheap") == pytest.approx(
        (10 * 1 + 2 * 2) / 1e6)


def test_cost_weight_prefers_cheaper_backend(pkg):
    s, log = pkg["serve"], []
    cheap = s.RemoteBackend("gpt-cheap", _vendor(log, "gpt-cheap"),
                            pricing={"gpt-cheap": {"input": 1.0,
                                                   "output": 1.0}})
    dear = s.RemoteBackend("gpt-dear", _vendor(log, "gpt-dear"),
                           pricing={"gpt-dear": {"input": 500.0,
                                                 "output": 500.0}})
    assert dear.cost_estimate_usd(s.ScoreRequest(prompt="x" * 40)) \
        == pytest.approx(10 / 1e6 * 500.0 + 16 / 1e6 * 500.0)
    with fast_pool(s, cost_weight=1.0, latency_weight=0.0) as pool:
        pool.load_remote(cheap, model="gpt")
        pool.load_remote(dear, model="gpt")
        for f in [pool.submit(s.ScoreRequest(prompt="Is soup a beverage?"),
                              model="gpt") for _ in range(6)]:
            f.result(timeout=30)
    assert log == ["gpt-cheap"] * 6


def test_latency_weight_prefers_faster_backend(pkg):
    s = pkg["serve"]
    pool = fast_pool(s, cost_weight=0.0, latency_weight=1.0)
    try:
        r_fast = pool.load_remote(s.RemoteBackend("f", _vendor([], "f")),
                                  model="gpt")
        r_slow = pool.load_remote(s.RemoteBackend("s", _vendor([], "s")),
                                  model="gpt")
        r_fast.note_latency(0.01)
        r_slow.note_latency(2.0)
        with pool._lock:
            assert pool._select_replica(
                "gpt", s.ScoreRequest(prompt="q")) is r_fast
        r_fast.note_latency(10.0)
        for _ in range(64):
            r_slow.note_latency(0.01)
        with pool._lock:
            assert pool._select_replica(
                "gpt", s.ScoreRequest(prompt="q")) is r_slow
    finally:
        pool.close()


def test_remote_leg_honors_deadlines_without_spending(pkg):
    s, testing = pkg["serve"], pkg["testing"]
    vendor = testing.FlakyVendor(latency_s=0.15)
    with fast_pool(s) as pool:
        pool.load_remote(s.RemoteBackend("gpt-x", vendor), model="gpt")
        f1 = pool.submit(s.ScoreRequest(prompt="a"), model="gpt")
        f2 = pool.submit(s.ScoreRequest(prompt="b", timeout_s=0.05),
                         model="gpt")
        assert isinstance(f2.exception(timeout=30), s.DeadlineExceeded)
        assert f1.result(timeout=30)["success"]
    assert vendor.calls == 1


def test_remote_failure_is_this_requests_typed_error(pkg):
    s, testing = pkg["serve"], pkg["testing"]
    vendor = testing.FlakyVendor()
    vendor.fail_next = 1
    with fast_pool(s) as pool:
        pool.load_remote(s.RemoteBackend("gpt-x", vendor), model="gpt")
        err = pool.submit(s.ScoreRequest(prompt="q"),
                          model="gpt").exception(timeout=30)
        assert isinstance(err, RuntimeError) and "503" in str(err)
        assert pool.submit(s.ScoreRequest(prompt="q"),
                           model="gpt").result(timeout=30)["success"]


# -- the vendor constructors over FakeTransport (both packages) --------------

VENDORS = ("openai", "gemini", "anthropic")


def _vendor_script(api, vendor, log=None, latency_s=0.0):
    """``FakeTransport`` handlers answering a binary prompt "Yes" (with
    first-token log-probabilities where the vendor gives them) and a
    confidence prompt "85"."""
    def text_of(call):
        body = call["json"]
        if vendor == "gemini":
            return body["contents"][0]["parts"][0]["text"]
        return body["messages"][0]["content"]

    def respond(call):
        if log is not None:
            log.append((call["json"] or {}).get("model", call["url"]))
        if latency_s:
            time.sleep(latency_s)
        conf = "How confident" in text_of(call)
        answer = "85" if conf else "Yes"
        top = ([("85", -0.3), ("90", -1.5)] if conf
               else [("Yes", -0.2), ("No", -1.8)])
        if vendor == "openai":
            return 200, {"choices": [{"message": {"content": answer},
                                      "logprobs": {"content": [{
                                          "top_logprobs": [
                                              {"token": t, "logprob": lp}
                                              for t, lp in top]}]}}],
                         "usage": {"prompt_tokens": 10,
                                   "completion_tokens": 2}}
        if vendor == "gemini":
            return 200, {"candidates": [{
                "content": {"parts": [{"text": answer}]},
                "logprobsResult": {"topCandidates": [{"candidates": [
                    {"token": t, "logProbability": lp} for t, lp in top]}]}}]}
        return 200, {"content": [{"type": "text", "text": answer}]}

    ft = api.FakeTransport()
    path = {"openai": "/chat/completions", "gemini": ":generateContent",
            "anthropic": "/messages"}[vendor]
    ft.add("POST", path, respond)
    return ft


def _vendor_backend(pkg, vendor, model, pricing=None, log=None,
                    latency_s=0.0, transport=None):
    api, s = pkg["api"], pkg["serve"]
    ft = transport or _vendor_script(api, vendor, log, latency_s)
    client = {"openai": api.OpenAIClient, "gemini": api.GeminiClient,
              "anthropic": api.AnthropicClient}[vendor](api_key="k",
                                                          transport=ft)
    return getattr(s.RemoteBackend, vendor)(client, model,
                                            pricing=pricing), ft


@pytest.mark.parametrize("vendor", VENDORS)
def test_vendor_constructor_rows_and_spend_match_reference(vendor):
    """A binary and a confidence request through each vendor constructor:
    the rows, the requests sent and the spend recorded equal the JAX
    package's, and each row is ``_result_row`` of the evaluator's output
    on the same canned response."""
    got = {}
    for name, pkg in PKGS.items():
        s = pkg["serve"]
        backend, ft = _vendor_backend(
            pkg, vendor, "m-1", pricing={"m-1": {"input": 1.5,
                                                 "output": 6.0}})
        with fast_pool(s) as pool:
            pool.load_remote(backend)
            rows = [pool.submit(s.ScoreRequest(
                prompt="Is soup a beverage?", with_confidence=conf,
                max_new_tokens=10 if conf else None),
                model="m-1").result(timeout=30) for conf in (False, True)]
        api = pkg["api"]
        binary, confidence = {
            "openai": (api.evaluate_gpt_binary, api.evaluate_gpt_confidence),
            "gemini": (api.evaluate_gemini_binary,
                       api.evaluate_gemini_confidence),
            "anthropic": (api.evaluate_claude, api.evaluate_claude)}[vendor]
        want = []
        for evaluate in (binary, confidence):
            c = {"openai": api.OpenAIClient, "gemini": api.GeminiClient,
                 "anthropic": api.AnthropicClient}[vendor](
                     "k", transport=_vendor_script(api, vendor))
            want.append(s.RemoteBackend._result_row(
                evaluate(c, "m-1", "Is soup a beverage?")))
        assert json.dumps(rows) == json.dumps(want)     # NaN as NaN
        got[name] = (json.dumps(rows),
                     [(c["method"], c["url"], c["headers"], c["json"])
                      for c in ft.calls],
                     backend.tracker.summary(), backend.tracker.total_cost())
    assert got["torch"] == got["jax"]
    assert got["torch"][3] > 0


@pytest.mark.parametrize("vendor", VENDORS)
def test_vendor_cost_weight_prefers_cheaper_backend(pkg, vendor):
    s, log = pkg["serve"], []
    cheap, _ = _vendor_backend(pkg, vendor, "v-cheap",
                               {"v-cheap": {"input": 1.0, "output": 1.0}},
                               log=log)
    dear, _ = _vendor_backend(pkg, vendor, "v-dear",
                              {"v-dear": {"input": 500.0, "output": 500.0}},
                              log=log)
    with fast_pool(s, cost_weight=1.0, latency_weight=0.0) as pool:
        pool.load_remote(cheap, model="v")
        pool.load_remote(dear, model="v")
        for f in [pool.submit(s.ScoreRequest(prompt="Is soup a beverage?"),
                              model="v") for _ in range(6)]:
            assert f.result(timeout=30)["success"]
    n_calls = 2 if vendor == "anthropic" else 1      # Claude asks twice
    assert len(log) == 6 * n_calls
    assert cheap.tracker.summary()["v-cheap"]["requests"] == 6
    assert "v-dear" not in dear.tracker.summary()


def test_vendor_latency_weight_prefers_faster_backend(pkg):
    s = pkg["serve"]
    pool = fast_pool(s, cost_weight=0.0, latency_weight=1.0)
    try:
        r_fast = pool.load_remote(
            _vendor_backend(pkg, "openai", "g-fast")[0], model="gpt")
        r_slow = pool.load_remote(
            _vendor_backend(pkg, "gemini", "g-slow")[0], model="gpt")
        r_fast.note_latency(0.01)
        r_slow.note_latency(2.0)
        with pool._lock:
            assert pool._select_replica(
                "gpt", s.ScoreRequest(prompt="q")) is r_fast
        r_fast.note_latency(10.0)
        for _ in range(64):
            r_slow.note_latency(0.01)
        with pool._lock:
            assert pool._select_replica(
                "gpt", s.ScoreRequest(prompt="q")) is r_slow
    finally:
        pool.close()


def test_vendor_leg_honors_deadlines_without_spending(pkg):
    """An expired request never reaches the vendor: it rejects with the
    typed ``DeadlineExceeded`` and no request leaves the transport."""
    s, log = pkg["serve"], []
    backend, ft = _vendor_backend(pkg, "openai", "gpt-x", log=log,
                                  latency_s=0.15)
    with fast_pool(s) as pool:
        pool.load_remote(backend, model="gpt")
        f1 = pool.submit(s.ScoreRequest(prompt="a"), model="gpt")
        f2 = pool.submit(s.ScoreRequest(prompt="b", timeout_s=0.05),
                         model="gpt")
        assert isinstance(f2.exception(timeout=30), s.DeadlineExceeded)
        assert f1.result(timeout=30)["success"]
    assert len(log) == 1 and len(ft.calls) == 1


def test_vendor_failure_is_this_requests_typed_error(pkg):
    """A vendor without a handler answers 404: that request fails with
    the client's ``RuntimeError`` and the replica keeps draining; a
    hot swap to a healthy vendor heals the traffic."""
    s, api = pkg["serve"], pkg["api"]
    bad, _ = _vendor_backend(pkg, "openai", "gpt-x",
                             transport=api.FakeTransport())
    with fast_pool(s, cost_weight=0.0, latency_weight=1.0) as pool:
        rep = pool.load_remote(bad, model="gpt")
        err = pool.submit(s.ScoreRequest(prompt="q"),
                          model="gpt").exception(timeout=30)
        assert isinstance(err, RuntimeError) and "404" in str(err)
        pool.unload(rep.rid)
        pool.load_remote(_vendor_backend(pkg, "gemini", "gem-x")[0],
                         model="gpt")
        row = pool.submit(s.ScoreRequest(prompt="q"),
                          model="gpt").result(timeout=30)
        assert row["success"] and row["completion"] == "Yes"


# -- health and labeled metrics ----------------------------------------------

def test_health_reports_per_replica_and_degrades_on_wedge(pkg):
    s = pkg["serve"]
    release, entered = threading.Event(), threading.Event()

    class WedgedEngine(FakeEngine):
        def score_prompts(self, prompts, *a, **kw):
            entered.set()
            release.wait(timeout=30)
            return super().score_prompts(prompts, *a, **kw)

    pool = s.EnginePool(s.PoolConfig(
        scheduler=s.SchedulerConfig(max_batch=4, max_wait_s=0.005),
        health_max_queue_age_s=0.03))
    try:
        pool.load("wedged", WedgedEngine("fake/w"), replica_id="rw",
                  plan_note="fits: batch 32")
        pool.load("fine", FakeEngine("fake/f"), replica_id="rf")
        f1 = pool.submit(s.ScoreRequest(prompt="a"), model="wedged")
        assert entered.wait(timeout=10)
        f2 = pool.submit(s.ScoreRequest(prompt="b"), model="wedged")

        def wedged_doc():
            return [r for r in pool.health()["replicas"]
                    if r["replica"] == "rw"][0]

        assert _wait_for(lambda: wedged_doc().get("status") == "degraded")
        doc = pool.health()
        assert doc["status"] == "degraded" and doc["pool"] == "running"
        assert wedged_doc()["plan"] == "fits: batch 32"
        fine = [r for r in doc["replicas"] if r["replica"] == "rf"][0]
        assert fine.get("status") != "degraded"
        assert pool.submit(s.ScoreRequest(prompt="c"),
                           model="fine").result(timeout=30)["success"]
        release.set()
        assert f1.result(timeout=30)["success"]
        assert f2.result(timeout=30)["success"]
    finally:
        release.set()
        pool.close()


def test_prometheus_export_labels_serve_metrics_by_replica():
    from llm_interpretation_replication_tpu_torch.obs import metrics

    with fast_pool(tserve) as pool:
        pool.load("alpha", FakeEngine("fake/a"), replica_id="ra")
        pool.load("alpha", FakeEngine("fake/a"), replica_id="rb")
        for f in [pool.submit(tserve.ScoreRequest(prompt=f"q{i}"),
                              model="alpha") for i in range(8)]:
            f.result(timeout=30)
    text = metrics.prometheus_text()
    labeled = [line for line in text.splitlines() if 'replica="r' in line]
    assert any(line.startswith("llm_interp_serve_completed{")
               for line in labeled)
    assert any("llm_interp_serve_req_e2e_ms_bucket{" in line
               for line in labeled)
    assert any('model="alpha"' in line for line in labeled)
    assert text.count("# TYPE llm_interp_serve_completed counter") == 1
    name = tserve.labeled_metric("serve_batches",
                                 {"replica": "r0", "model": "m"})
    assert name == jserve.labeled_metric("serve_batches",
                                         {"replica": "r0", "model": "m"})
    assert metrics.split_labeled_name(name) == (
        "serve_batches", {"replica": "r0", "model": "m"})


# -- what the port refuses, by item ------------------------------------------

def test_refusals_name_their_items():
    """Neither ``devices=`` nor the vendor constructors refuse any more
    (their items have landed).  On one rank (no process group: a card's
    world) a replica's slice is the reference's shared placement: it
    loads unbound, says so in its health document and answers the
    engine's rows (``tests/test_torch_mesh_serve.py`` runs the sliced
    placement on 2 and 4 gloo ranks)."""
    eng = FakeEngine("fake/a")
    with fast_pool(tserve) as pool:
        replica = pool.load("alpha", eng, devices=[0])
        assert (replica.devices, replica.placement, replica.hosted) == (
            (0,), "shared", True)
        row = pool.submit(tserve.ScoreRequest(prompt="q0")).result(
            timeout=30)
        doc = pool.health()["replicas"][0]
    assert tserve.rows_equal(row, eng.score_prompts(["q0"])[0])
    assert (doc["devices"], doc["ranks"], doc["placement"]) == (
        1, [0], "shared")
    for ctor, client in (("openai", tapi.OpenAIClient),
                         ("gemini", tapi.GeminiClient),
                         ("anthropic", tapi.AnthropicClient)):
        backend = getattr(tserve.RemoteBackend, ctor)(
            client("k", transport=tapi.FakeTransport()), "m")
        assert isinstance(backend, tserve.RemoteBackend)
        assert backend.model == "m"


def test_replica_engine_config_applies_an_operating_point():
    plan = types.SimpleNamespace(batch=8, kv_dtype="int8", prefill_chunk=64,
                                 pool_target=16, reason="fits: dp1")
    base = tengine.EngineConfig(batch_size=4)
    got = tpool.replica_engine_config(base, plan)
    assert (got.batch_size, got.kv_dtype, got.prefill_chunk,
            got.phase2_pool_target) == (8, "int8", 64, 16)
    assert tpool.replica_engine_config(base, None) is base
    eng = FakeEngine("fake/a")
    eng.ecfg = base
    with fast_pool(tserve) as pool:
        rep = pool.load("alpha", eng, plan=plan)
        assert eng.ecfg.batch_size == 8 and rep.plan_note == "fits: dp1"
        assert pool.health()["replicas"][0]["plan"] == "fits: dp1"


# -- the port's engine: teardown, shared snapshots, parity --------------------

def _weights(seed=2):
    cfg = tconfig.DecoderConfig(**tconfig.FLAGSHIP_SMALL_GEOMETRY)
    return cfg, convert.random_params(cfg, seed=seed, device="cpu",
                                      dtype="fp32")


def test_buffer_census_returns_to_baseline():
    base = tengine.live_buffer_count("cpu")
    snap = ttel.counters()
    cfg, w = _weights()
    eng = tengine.ScoringEngine("falcon", cfg, w, TOK, device="cpu",
                                engine_config=tengine.EngineConfig(
                                    batch_size=4, buckets=(32, 64)))
    assert tengine.live_buffer_count("cpu") > base
    assert all(r["success"] for r in eng.score_prompts(PROMPTS[:2]))
    eng.close()
    eng.close()
    assert eng.params is None
    assert all(b.untyped_storage().nbytes() == 0 for b in w.buffers())
    assert tengine.live_buffer_count("cpu") <= base
    assert ttel.counters_since(snap).get("engine_closed") == 1
    with pytest.raises(tengine.EngineClosed):
        eng.score_prompts(PROMPTS[:1])


def test_shared_group_releases_only_on_last_unload_any_order():
    _, teng = engines(batch_size=4, decode_completions=True,
                      max_new_tokens=12)
    _, tcfg, _, shared = models()
    cfg, w = _weights(seed=3)
    eng = tengine.ScoringEngine("falcon", cfg, w, TOK, device="cpu",
                                engine_config=teng.ecfg)
    leaf = next(iter(w.buffers()))
    offline = eng.score_prompts(PROMPTS[:1])
    pool = tcli.build_shared_pool(eng, "tiny", 2, tserve.SchedulerConfig(
        max_batch=4, max_wait_s=0.005))
    try:
        assert len({id(r.share_group) for r in pool.replicas()}) == 1
        assert all(r.engine.device == eng.device for r in pool.replicas())
        rids = [r.rid for r in pool.replicas()]
        pool.unload(rids[0])            # the primary first
        assert leaf.untyped_storage().nbytes() > 0
        row = pool.submit(tserve.ScoreRequest(prompt=PROMPTS[0]),
                          model="tiny").result(timeout=120)
        assert tserve.rows_equal(row, offline[0])
        pool.unload(rids[1])            # the last sibling releases
        assert leaf.untyped_storage().nbytes() == 0
    finally:
        pool.close()
    assert all(b.untyped_storage().nbytes() > 0 for b in shared.buffers())


def _one_bucket():
    return [p for p in PROMPTS if len(TOK(p)["input_ids"]) <= 32]


def test_every_replica_rows_exact_against_offline():
    """Two replicas over one snapshot (completions on: each row decodes
    in its own batch at the fixed batch shape): every served row equals
    the offline row exactly, whichever replica answered; against the JAX
    pool at the classes."""
    jeng, teng = engines(batch_size=4, decode_completions=True,
                         max_new_tokens=12)
    prompts = _one_bucket()[:8]
    offline = teng.score_prompts(prompts)
    rows = {}
    for name, p, eng in (("jax", PKGS["jax"], jeng),
                         ("torch", PKGS["torch"], teng)):
        pool = p["cli"].build_shared_pool(
            eng, "tiny", 2, p["serve"].SchedulerConfig(max_batch=4,
                                                       max_wait_s=0.005))
        try:
            futs = [pool.submit(p["serve"].ScoreRequest(prompt=q),
                                model="tiny") for q in prompts]
            rows[name] = [f.result(timeout=300) for f in futs]
            done = [r.completed for r in pool.replicas()]
        finally:
            for r in pool.replicas():
                r.share_group = None     # keep the engines for the others
                r.owns_engine = False
            pool.close()
    assert sum(done) == len(prompts)
    assert all(tserve.rows_equal(a, b) for a, b in zip(rows["torch"], offline))
    for g, r in zip(rows["torch"], rows["jax"]):
        assert g["scan_found"] == r["scan_found"]
        assert g["completion"] == r["completion"]
        for f in PROB_FIELDS:
            np.testing.assert_allclose(g[f], r[f], rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_roles_handoff_rows(kv):
    """A prefill and a decode replica over one engine config: the
    undecided rows' KV slabs cross replicas (export and import counters
    balance, every request arrives at the prefill replica), the served
    rows equal one offline call exactly (int8 slabs carry their codes and
    scales) and the JAX fleet's at the classes."""
    pairs = targets()
    out = {}
    for name, p in PKGS.items():
        jeng, teng = engines(batch_size=4, kv_dtype=kv)
        eng = jeng if name == "jax" else teng

        def clone():
            if name == "jax":
                return type(eng)("falcon", eng.cfg, eng.params, TOK,
                                 engine_config=eng.ecfg)
            return tengine.ScoringEngine("falcon", eng.cfg, eng.params, TOK,
                                         device="cpu",
                                         engine_config=eng.ecfg)

        p["tel"].clear_counters()
        pool = p["serve"].EnginePool(p["serve"].PoolConfig(
            scheduler=p["serve"].SchedulerConfig(max_batch=4,
                                                 max_wait_s=0.02)))
        try:
            pool.load("tiny", clone(), owns_engine=False, role="prefill")
            pool.load("tiny", clone(), owns_engine=False, role="decode")
            futs = [pool.submit(p["serve"].ScoreRequest(
                prompt=q, targets=tuple(t)), model="tiny")
                for q, t in zip(PROMPTS, pairs)]
            rows = [f.result(timeout=300) for f in futs]
            docs = {d["role"]: d for d in
                    (r.health(0) for r in pool.replicas())}
        finally:
            pool.close()
        c = p["tel"].counters()
        out[name] = (rows, {k: c.get(k, 0) for k in (
            "serve_handoff_rows", "slot_slab_import_rows",
            "slot_slab_export_rows")}, docs, clone)
    rows, c, docs, clone = out["torch"]
    assert c["serve_handoff_rows"] >= 1
    assert c["slot_slab_import_rows"] == c["slot_slab_export_rows"] \
        == c["serve_handoff_rows"]
    assert docs["prefill"]["completed"] == len(PROMPTS)
    assert docs["decode"]["completed"] == 0
    for g, r in zip(rows, out["jax"][0]):
        assert g["scan_found"] == r["scan_found"]
        for f in PROB_FIELDS:
            np.testing.assert_allclose(g[f], r[f], rtol=RTOL, atol=1e-9)
    offline = clone().score_prompts(PROMPTS, pairs)
    assert all(tserve.rows_equal(a, b) for a, b in zip(rows, offline))


def test_jsonl_driver_over_shared_pool():
    cfg, w = _weights(seed=4)
    eng = tengine.ScoringEngine("falcon", cfg, w, TOK, device="cpu",
                                engine_config=tengine.EngineConfig(
                                    batch_size=4, buckets=(32, 64),
                                    decode_completions=False))
    pool = tcli.build_shared_pool(eng, "tiny", 2, tserve.SchedulerConfig(
        max_batch=4, max_wait_s=0.005), supervise=True)
    lines = "\n".join([json.dumps({"prompt": p, "model": "tiny"})
                       for p in PROMPTS[:4]] + ["{oops"])
    out = io.StringIO()
    try:
        assert pool.supervisor is not None
        summary = tcli.run_jsonl_driver(eng, io.StringIO(lines), out,
                                        pool=pool)
    finally:
        pool.close()
    assert summary == {"requests": 5, "errors": 1}
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]
    assert all(r["success"] for r in rows[:4])
    assert rows[4]["error_type"] == "JSONDecodeError"
    assert all(b.untyped_storage().nbytes() == 0 for b in w.buffers())


def test_pool_under_load_exact_and_strict_clean():
    _, teng = engines(batch_size=4, decode_completions=True,
                      max_new_tokens=12)
    prompts = _one_bucket()[:6]
    offline = teng.score_prompts(prompts)
    pool = tcli.build_shared_pool(teng, "tiny", 2, tserve.SchedulerConfig(
        max_batch=4, max_wait_s=0.005))
    strict.activate(sentry=False)
    try:
        report = tload.run_load(
            teng, prompts, rate=30.0, duration_s=0.5, offline_rows=offline,
            scheduler_factory=lambda cfg: pool.client("tiny"))
    finally:
        strict.deactivate()
        for r in pool.replicas():
            r.share_group = None
            r.owns_engine = False
        pool.close()
    assert report["errors"] == 0 and report["completed"] > 3
    assert report["parity"]["mismatched_rows"] == 0
    assert report["blocked_transfers"] == 0
