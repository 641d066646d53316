"""The port's vendor clients, evaluators, response cache and API helpers
(``api_backends/``, ``utils/retry.RateLimiter``,
``utils/checkpoint.ProcessedSet``, ``utils/xlsx.append_xlsx``,
``scoring/prompts``) against the JAX package's.

Every case runs the same scripted ``FakeTransport`` handlers through both
packages' clients and compares what each sent (method, URL, headers, JSON
body, uploaded bytes with the multipart boundary masked) and what each
returned or raised.  Retries use a zero-delay policy and every wait an
injected clock, so nothing sleeps; nothing opens a socket (the urllib
transport runs against a patched ``urlopen``).
"""

import io
import json
import math
import re
import types
import urllib.error
import urllib.request
import uuid

import numpy as np
import pandas as pd
import pytest

import llm_interpretation_replication_tpu.api_backends as japi
import llm_interpretation_replication_tpu.api_backends.anthropic_client as jant
import llm_interpretation_replication_tpu.api_backends.cache as jcache
import llm_interpretation_replication_tpu.api_backends.evaluators as jev
import llm_interpretation_replication_tpu.api_backends.gemini_client as jgem
import llm_interpretation_replication_tpu.api_backends.openai_client as joai
import llm_interpretation_replication_tpu.api_backends.transport as jtr
import llm_interpretation_replication_tpu.scoring.prompts as jprompts
import llm_interpretation_replication_tpu.utils.checkpoint as jckpt
import llm_interpretation_replication_tpu.utils.retry as jretry
import llm_interpretation_replication_tpu.utils.xlsx as jxlsx
import llm_interpretation_replication_tpu_torch.api_backends as tapi
import llm_interpretation_replication_tpu_torch.api_backends.anthropic_client as tant
import llm_interpretation_replication_tpu_torch.api_backends.cache as tcache
import llm_interpretation_replication_tpu_torch.api_backends.evaluators as tev
import llm_interpretation_replication_tpu_torch.api_backends.gemini_client as tgem
import llm_interpretation_replication_tpu_torch.api_backends.openai_client as toai
import llm_interpretation_replication_tpu_torch.api_backends.transport as ttr
import llm_interpretation_replication_tpu_torch.scoring.prompts as tprompts
import llm_interpretation_replication_tpu_torch.utils.checkpoint as tckpt
import llm_interpretation_replication_tpu_torch.utils.retry as tretry
import llm_interpretation_replication_tpu_torch.utils.xlsx as txlsx
from test_torch_slots import one_torch_thread  # noqa: F401

PKGS = {
    "jax": types.SimpleNamespace(api=japi, tr=jtr, oai=joai, ant=jant,
                                 gem=jgem, ev=jev, cache=jcache,
                                 retry=jretry, ckpt=jckpt),
    "torch": types.SimpleNamespace(api=tapi, tr=ttr, oai=toai, ant=tant,
                                   gem=tgem, ev=tev, cache=tcache,
                                   retry=tretry, ckpt=tckpt),
}

GPT = "gpt-4.1-2025-04-14"
CLAUDE = "claude-opus-4-1-20250805"
GEMINI = "gemini-2.5-pro"
MSG = [{"role": "user", "content": "Is a tent a building?"}]


def fast_retry(p, retries=3):
    return p.retry.RetryPolicy(retry_on=(p.tr.TransportError,),
                               max_retries=retries, initial_delay=0.0,
                               sleep=lambda s: None)


def mask_calls(calls):
    """The recorded calls, with each multipart boundary (a random hex
    uuid, in the body and its Content-Type) masked."""
    out = []
    for c in calls:
        data = c["data"]
        if data is not None:
            data = re.sub(rb"[0-9a-f]{32}", b"<boundary>", data)
        headers = {k: re.sub(r"boundary=[0-9a-f]{32}", "boundary=<b>", v)
                   for k, v in c["headers"].items()}
        out.append((c["method"], c["url"], headers, c["json"], data))
    return out


def twin(script, drive):
    """Run ``drive(pkg, transport)`` on both packages, each over its own
    ``FakeTransport`` loaded with ``script(pkg)``'s handlers; returns
    ``{name: (outcome, calls)}`` with an exception as ``("raised", type
    name, message)``."""
    out = {}
    for name, p in PKGS.items():
        ft = p.tr.FakeTransport()
        for handler in script(p):
            ft.add(*handler)
        try:
            outcome = ("ok", drive(p, ft))
        except Exception as err:            # compared across the packages
            outcome = ("raised", type(err).__name__, str(err))
        out[name] = (outcome, mask_calls(ft.calls))
    return out


def assert_twins(out):
    assert out["torch"][1] == out["jax"][1]          # the requests
    assert out["torch"][0] == out["jax"][0]          # the results


# -- scripted responses -------------------------------------------------------

def chat(text, top=None, usage=None):
    content = ([{"token": text.split()[0] if text else "", "top_logprobs": top}]
               if top is not None else [])
    return {"choices": [{"message": {"content": text},
                         "logprobs": {"content": content} if content else None}],
            "usage": usage or {"prompt_tokens": 100, "completion_tokens": 5}}


def top_lp(*pairs):
    return [{"token": t, "logprob": math.log(p)} for t, p in pairs]


def gemini_response(text, top=None):
    cand = {"content": {"parts": [{"text": text}]}}
    if top is not None:
        cand["logprobsResult"] = {"topCandidates": [
            {"candidates": [{"token": t, "logProbability": math.log(pr)}
                            for t, pr in pos]} for pos in top]}
    return {"candidates": [cand]}


def counter_responder(seq):
    """A responder that answers the i-th call with ``seq[i]`` (the last
    repeats); an exception instance in ``seq`` is raised."""
    state = {"i": 0}

    def respond(call):
        item = seq[min(state["i"], len(seq) - 1)]
        state["i"] += 1
        if isinstance(item, Exception):
            raise item
        return item

    return respond


def fake_clock(step):
    """(clock, sleep): each sleep of s moves the clock s + step."""
    now = [0.0]
    return (lambda: now[0]), (lambda s: now.__setitem__(0, now[0] + s + step))


def slow_wait(wait, *args, clock_kw="clock", sleep_kw="sleep", **kwargs):
    """``wait(*args, ...)`` on a fake clock where every poll round trip
    costs 45 s past its sleep."""
    clock, sleep = fake_clock(45.0)
    return wait(*args, **{clock_kw: clock, sleep_kw: sleep}, **kwargs)


# -- OpenAI ---------------------------------------------------------------------

def _openai(p, ft):
    return p.oai.OpenAIClient("k", transport=ft, retry_policy=fast_retry(p))


def _openai_batch_script(p, n_results=3, fail=False):
    polls = counter_responder([
        (200, {"id": "batch-1", "status": "validating"}),
        (200, {"id": "batch-1", "status": "in_progress"}),
        (200, {"id": "batch-1", "status": "failed" if fail else "completed",
               "output_file_id": "out-1"})])
    lines = [{"custom_id": f"req-{i}", "response": {"body": chat(
        "Yes", top_lp(("Yes", 0.6), ("No", 0.3)))}} for i in range(n_results)]
    return [
        ("POST", "/files", counter_responder(
            [(200, {"id": f"file-{i}"}) for i in range(4)])),
        ("POST", "/batches", lambda c: (200, {"id": "batch-1",
                                              "status": "validating"})),
        ("GET", "/batches/batch-1", polls),
        ("GET", "/files/out-1/content", lambda c: (200, "\n".join(
            json.dumps(line) for line in lines).encode())),
    ]


def _batch_requests(p, n, model=GPT):
    return [p.oai.build_batch_request(f"req-{i}", model,
                                      [{"role": "user", "content": f"q{i}"}])
            for i in range(n)]


OPENAI_CASES = {
    "chat_default": (
        lambda p: [("POST", "/chat/completions",
                    lambda c: (200, chat("Yes", top_lp(("Yes", 0.7)))))],
        lambda p, ft: _openai(p, ft).chat_completion(GPT, MSG)),
    "chat_no_logprobs": (
        lambda p: [("POST", "/chat/completions", lambda c: (200, chat("No")))],
        lambda p, ft: _openai(p, ft).chat_completion(
            GPT, MSG, temperature=0.7, max_tokens=10, logprobs=False)),
    "chat_reasoning_model": (
        lambda p: [("POST", "/chat/completions", lambda c: (200, chat("No")))],
        lambda p, ft: _openai(p, ft).chat_completion("o3-2025-04-16", MSG)),
    "retry_429_then_success": (
        lambda p: [("POST", "/chat/completions", counter_responder([
            p.tr.TransportError(429, "rate limited", retryable=True),
            p.tr.TransportError(503, "overloaded", retryable=True),
            (200, chat("ok"))]))],
        lambda p, ft: _openai(p, ft).chat_completion(GPT, MSG)),
    "retries_exhausted": (
        lambda p: [("POST", "/chat/completions", counter_responder([
            p.tr.TransportError(500, "boom", retryable=True)]))],
        lambda p, ft: _openai(p, ft).chat_completion(GPT, MSG)),
    "non_retryable_raises": (
        lambda p: [("POST", "/chat/completions", counter_responder([
            p.tr.TransportError(401, "bad key", retryable=False)]))],
        lambda p, ft: _openai(p, ft).chat_completion(GPT, MSG)),
    "no_handler": (
        lambda p: [],
        lambda p, ft: _openai(p, ft).get_batch("b")),
    "batch_pipeline": (
        lambda p: _openai_batch_script(p),
        lambda p, ft: _openai(p, ft).run_batch(
            _batch_requests(p, 3), poll_interval=7, sleep=lambda s: None)),
    "batch_reasoning_requests": (
        lambda p: _openai_batch_script(p, n_results=2),
        lambda p, ft: _openai(p, ft).run_batch(
            _batch_requests(p, 2, "gpt-5"), sleep=lambda s: None)),
    "batch_terminal_failure": (
        lambda p: _openai_batch_script(p, fail=True),
        lambda p, ft: _openai(p, ft).run_batch(
            _batch_requests(p, 1), sleep=lambda s: None)),
    "batch_wall_clock_timeout": (
        lambda p: [("GET", "/batches/b", lambda c: (
            200, {"id": "b", "status": "in_progress"}))],
        lambda p, ft: slow_wait(_openai(p, ft).wait_for_batch, "b",
                                poll_interval=30, timeout=100.0)),
}


@pytest.mark.parametrize("case", sorted(OPENAI_CASES))
def test_openai_client_matches_reference(case):
    script, drive = OPENAI_CASES[case]
    assert_twins(twin(script, drive))


def test_openai_batch_chunks_at_the_cap(monkeypatch):
    """Past ``MAX_BATCH_REQUESTS`` the requests go out in chunks, one
    upload, batch and download each (the cap patched to 2 in both)."""
    monkeypatch.setattr(joai, "MAX_BATCH_REQUESTS", 2)
    monkeypatch.setattr(toai, "MAX_BATCH_REQUESTS", 2)
    out = twin(lambda p: _openai_batch_script(p),
               lambda p, ft: _openai(p, ft).run_batch(
                   _batch_requests(p, 5), sleep=lambda s: None))
    assert_twins(out)
    uploads = [c for c in out["torch"][1] if c[1].endswith("/files")]
    assert len(uploads) == 3
    assert b'"custom_id": "req-4"' in uploads[2][4]


# -- Anthropic ------------------------------------------------------------------

def _anthropic(p, ft):
    return p.ant.AnthropicClient("k", transport=ft, retry_policy=fast_retry(p))


def _messages(*texts):
    return counter_responder([(200, {"content": [{"type": "text", "text": t}]})
                              for t in texts])


def _anthropic_batch_script(p):
    lines = [{"custom_id": f"c{i}", "result": {"type": "succeeded", "message": {
        "content": [{"type": "text", "text": str(60 + i)}]}}} for i in range(3)]
    return [
        ("POST", "/messages/batches", counter_responder(
            [(200, {"id": f"b{i}", "processing_status": "in_progress"})
             for i in range(3)])),
        ("GET", "/results", lambda c: (200, "\n".join(
            json.dumps(line) for line in lines).encode())),
        ("GET", "/messages/batches/", counter_responder([
            (200, {"id": "b0", "processing_status": "in_progress"}),
            (200, {"id": "b0", "processing_status": "ended"})])),
    ]


ANTHROPIC_CASES = {
    "message_and_text": (
        lambda p: [("POST", "/messages", _messages(" Not Covered "))],
        lambda p, ft: (lambda c: (c.text_of(m := c.create_message(CLAUDE, MSG)),
                                  m))(_anthropic(p, ft))),
    "message_params": (
        lambda p: [("POST", "/messages", _messages("Yes"))],
        lambda p, ft: _anthropic(p, ft).create_message(
            CLAUDE, MSG, max_tokens=4000, temperature=0.9)),
    "approximate_logprobs_first_match": (
        lambda p: [("POST", "/messages", _messages(
            "Covered", "Covered", "Not Covered", "Not sure", "weird"))],
        lambda p, ft: _anthropic(p, ft).approximate_logprobs(
            CLAUDE, MSG, ["Covered", "Not"], n_samples=5)),
    "approximate_logprobs_uniform_fallback": (
        lambda p: [("POST", "/messages", _messages("no target"))],
        lambda p, ft: _anthropic(p, ft).approximate_logprobs(
            CLAUDE, MSG, ["Covered", "Nope"], n_samples=3)),
    "batch_cap": (
        lambda p: [],
        lambda p, ft: _anthropic(p, ft).create_batch([{}] * 10_001)),
    "batch_poll_and_results": (
        _anthropic_batch_script,
        lambda p, ft: _anthropic(p, ft).run_batches(
            [p.ant.build_batch_request(f"c{i}", CLAUDE, MSG, temperature=1.0)
             for i in range(3)], poll_interval=3, sleep=lambda s: None)),
    "retry_529": (
        lambda p: [("POST", "/messages", counter_responder([
            p.tr.TransportError(529, "overloaded", retryable=True),
            (200, {"content": [{"type": "text", "text": "Yes"}]})]))],
        lambda p, ft: _anthropic(p, ft).create_message(CLAUDE, MSG)),
    "non_retryable": (
        lambda p: [("POST", "/messages", counter_responder([
            p.tr.TransportError(400, "bad request", retryable=False)]))],
        lambda p, ft: _anthropic(p, ft).create_message(CLAUDE, MSG)),
    "batch_wall_clock_timeout": (
        lambda p: [("GET", "/messages/batches/b", lambda c: (
            200, {"id": "b", "processing_status": "in_progress"}))],
        lambda p, ft: slow_wait(_anthropic(p, ft).wait_for_batch, "b",
                                poll_interval=30, timeout=100.0)),
}


@pytest.mark.parametrize("case", sorted(ANTHROPIC_CASES))
def test_anthropic_client_matches_reference(case):
    script, drive = ANTHROPIC_CASES[case]
    assert_twins(twin(script, drive))


def test_anthropic_batches_chunk_at_the_cap(monkeypatch):
    monkeypatch.setattr(jant, "MAX_BATCH_SIZE", 2)
    monkeypatch.setattr(tant, "MAX_BATCH_SIZE", 2)
    out = twin(_anthropic_batch_script,
               lambda p, ft: _anthropic(p, ft).run_batches(
                   [p.ant.build_batch_request(f"c{i}", CLAUDE, MSG)
                    for i in range(5)], sleep=lambda s: None))
    assert_twins(out)
    posts = [c for c in out["torch"][1] if c[0] == "POST"]
    assert [len(c[3]["requests"]) for c in posts] == [2, 2, 1]


# -- Gemini -----------------------------------------------------------------------

def _gemini(p, ft, **kw):
    return p.gem.GeminiClient("k", transport=ft, retry_policy=fast_retry(p),
                              **kw)


def _gemini_batch_script(p, states, results=("yes", "no"), keys=None):
    polls = iter(states)

    def poll(_c):
        state = next(polls)
        body = {"name": "batches/b1", "metadata": {"state": state}}
        if state == "JOB_STATE_SUCCEEDED":
            inlined = [{"response": gemini_response(t)} for t in results]
            for r, k in zip(inlined, keys or ()):
                r["metadata"] = {"key": k}
            body["response"] = {"inlinedResponses": {
                "inlinedResponses": inlined}}
        return 200, body

    return [("POST", ":batchGenerateContent",
             lambda c: (200, {"name": "batches/b1"})),
            ("GET", "batches/b1", poll)]


def _gemini_texts(p, ft, **kw):
    client = _gemini(p, ft)
    out = client.run_batch(GEMINI, ["p1", "p2"], sleep_fn=lambda s: None, **kw)
    return [client.text_of(r) for r in out]


GEMINI_CASES = {
    "generate_content_logprobs": (
        lambda p: [("POST", ":generateContent", lambda c: (200, gemini_response(
            "85", [[("85", 0.9), ("90", 0.1)]])))],
        lambda p, ft: (lambda c, r: (r, c.text_of(r), c.top_candidates_of(r)))(
            *(lambda c: (c, c.generate_content(GEMINI, "q", response_logprobs=True)))(
                _gemini(p, ft)))),
    "generate_content_options": (
        lambda p: [("POST", ":generateContent",
                    lambda c: (200, gemini_response("x")))],
        lambda p, ft: _gemini(p, ft).generate_content(
            GEMINI, "q", temperature=0.7, max_output_tokens=12,
            safety_off=False)),
    "text_and_candidates_of_empty": (
        lambda p: [("POST", ":generateContent", lambda c: (200, {}))],
        lambda p, ft: (lambda c: (lambda r: (c.text_of(r),
                                             c.top_candidates_of(r)))(
            c.generate_content(GEMINI, "q")))(_gemini(p, ft))),
    "retry_then_non_retryable": (
        lambda p: [("POST", ":generateContent", counter_responder([
            p.tr.TransportError(0, "unreachable", retryable=True),
            p.tr.TransportError(403, "forbidden", retryable=False)]))],
        lambda p, ft: _gemini(p, ft).generate_content(GEMINI, "q")),
    "batch_lifecycle": (
        lambda p: _gemini_batch_script(p, ["JOB_STATE_PENDING",
                                           "JOB_STATE_RUNNING",
                                           "JOB_STATE_SUCCEEDED"]),
        lambda p, ft: _gemini_texts(p, ft, response_logprobs=True,
                                    display_name="run")),
    "batch_responses_reordered_by_key": (
        lambda p: _gemini_batch_script(p, ["JOB_STATE_SUCCEEDED"],
                                       results=("second", "first"),
                                       keys=("1", "0")),
        _gemini_texts),
    "batch_failure_state": (
        lambda p: _gemini_batch_script(p, ["JOB_STATE_FAILED"]),
        _gemini_texts),
    "batch_wall_clock_timeout": (
        lambda p: _gemini_batch_script(p, ["JOB_STATE_RUNNING"] * 10),
        lambda p, ft: slow_wait(_gemini(p, ft).wait_for_batch, "batches/b1",
                                poll_interval=30, max_wait=140.0,
                                clock_kw="clock_fn", sleep_kw="sleep_fn")),
}


@pytest.mark.parametrize("case", sorted(GEMINI_CASES))
def test_gemini_client_matches_reference(case):
    script, drive = GEMINI_CASES[case]
    assert_twins(twin(script, drive))


def test_gemini_generate_many_on_a_rate_limiter():
    """The threaded fan-out answers in submit order; its requests are the
    reference's (in any order), and the token bucket's waits, on an
    injected clock, are the reference's."""
    out = {}
    for name, p in PKGS.items():
        ft = p.tr.FakeTransport()
        ft.add("POST", ":generateContent", lambda c: (200, gemini_response(
            c["json"]["contents"][0]["parts"][0]["text"].upper())))
        client = _gemini(p, ft)
        now, waits = [0.0], []
        client.rate_limiter = p.retry.RateLimiter(
            2.5, clock=lambda: now[0], sleep=waits.append)
        rows = client.generate_many(GEMINI, [f"p{i}" for i in range(12)],
                                    max_workers=4)
        out[name] = ([client.text_of(r) for r in rows],
                     sorted(mask_calls(ft.calls), key=json.dumps),
                     sorted(waits))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [f"P{i}" for i in range(12)]


@pytest.mark.parametrize("rps,steps", [(2.3, [0.0, 0.1, 0.1, 1.0, 0.0]),
                                       (10.0, [0.5, 0.0, 0.0, 0.05])])
def test_rate_limiter_matches_reference(rps, steps):
    out = {}
    for name, p in PKGS.items():
        now, slept = [0.0], []
        limiter = p.retry.RateLimiter(rps, clock=lambda: now[0],
                                      sleep=slept.append)
        waits = []
        for step in steps:
            now[0] += step
            waits.append(limiter.acquire())
        out[name] = (waits, slept)
    assert out["torch"] == out["jax"]


def test_gemini_run_batch_resume_file(tmp_path):
    """A saved batch name re-attaches (no second submit) and is cleared on
    success; a terminal state clears it too; the files are the
    reference's byte for byte."""
    out = {}
    for name, p in PKGS.items():
        resume = str(tmp_path / name / "ckpt" / "batch_id.json")
        p.gem.save_batch_id(resume, "batches/b1")
        with open(resume, "rb") as f:
            saved = f.read()
        ft = p.tr.FakeTransport()
        for h in _gemini_batch_script(p, ["JOB_STATE_SUCCEEDED"]):
            ft.add(*h)
        texts = _gemini_texts(p, ft, resume_file=resume)
        cleared = p.gem.load_batch_id(resume)
        ft2 = p.tr.FakeTransport()
        for h in _gemini_batch_script(p, ["JOB_STATE_EXPIRED"]):
            ft2.add(*h)
        with pytest.raises(p.gem.BatchTerminalError):
            _gemini_texts(p, ft2, resume_file=resume)
        out[name] = (saved, texts, cleared, p.gem.load_batch_id(resume),
                     mask_calls(ft.calls), mask_calls(ft2.calls))
    assert out["torch"] == out["jax"]
    assert not any(":batchGenerateContent" in c[1] for c in out["torch"][4])
    assert out["torch"][2] is None and out["torch"][3] is None


@pytest.mark.parametrize("raw", [
    "candidates=[Candidate(content=Content(parts=[Part(text='85')]))]",
    'Part(text="It\'s likely")',
    "Part(text='a \\'quoted\\' word')",
    "Part(text='back\\\\slash')",
    "no text field here",
    "",
])
def test_extract_text_from_response_string_matches_reference(raw):
    assert (tapi.extract_text_from_response_string(raw)
            == japi.extract_text_from_response_string(raw))


def test_repair_batch_responses_matches_reference(tmp_path):
    req, resp = tmp_path / "requests.jsonl", tmp_path / "responses.jsonl"
    req.write_text("\n".join(json.dumps({"custom_id": f"q{i}", "request": {}})
                             for i in range(2)) + "\n")

    def corrupt(text):
        return {"response": {"candidates": [{"content": {"parts": [{
            "text": f"Candidate(content=Content(parts=[Part(text='{text}')]))"
        }]}}]}}

    resp.write_text("\n".join(json.dumps(r) for r in (
        corrupt("Yes"), corrupt("72"), {"response": {}})) + "\n")
    outs = {}
    for name, api in (("jax", japi), ("torch", tapi)):
        path = tmp_path / f"fixed_{name}.jsonl"
        n = api.repair_batch_responses(str(req), str(resp), str(path))
        outs[name] = (n, path.read_bytes())
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == 3


# -- the transport --------------------------------------------------------------

class _Resp:
    def __init__(self, status, body):
        self.status, self._body = status, body

    def read(self):
        return self._body

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("outcome", ["ok", "http_429", "http_401", "url_error"])
def test_urllib_transport_matches_reference(monkeypatch, outcome):
    """The urllib transport builds the same request, returns the same
    (status, bytes) and maps errors to the same ``TransportError`` (a
    patched ``urlopen``: no socket)."""
    seen = []

    def urlopen(req, timeout):
        seen.append((req.full_url, req.get_method(), sorted(req.header_items()),
                     req.data, timeout))
        if outcome == "ok":
            return _Resp(200, b'{"id": "x"}')
        if outcome.startswith("http"):
            code = int(outcome.split("_")[1])
            raise urllib.error.HTTPError(req.full_url, code, "err", {},
                                         io.BytesIO(b"slow down"))
        raise urllib.error.URLError("host down")

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    out = {}
    for name, p in PKGS.items():
        t = p.tr.UrllibTransport(timeout=7.5)
        got = []
        for kwargs in ({"json_body": {"a": [1, 2]}},
                       {"data": b"raw", "headers": {"X-K": "v"}}):
            try:
                got.append(("ok",) + t.request("POST", "https://h/v1/x",
                                               **kwargs))
            except p.tr.TransportError as err:
                got.append(("err", err.status, err.body, err.retryable,
                            str(err)))
        out[name] = got
    assert out["torch"] == out["jax"]
    assert seen[:2] == seen[2:]


def test_multipart_form_matches_reference(monkeypatch):
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=7))
    fields, files = {"purpose": "batch"}, {"file": ("batch.jsonl", b"{}\n{}")}
    assert ttr.multipart_form(fields, files) == jtr.multipart_form(fields, files)
    assert ttr.RETRYABLE_STATUS == jtr.RETRYABLE_STATUS


# -- evaluators -------------------------------------------------------------------

def _evaluate(kind, p, ft, responses):
    if kind.startswith("gpt"):
        client = _openai(p, ft)
        ft.add("POST", "/chat/completions", counter_responder(responses))
    elif kind.startswith("gemini"):
        client = _gemini(p, ft)
        ft.add("POST", ":generateContent", counter_responder(responses))
    else:
        client = _anthropic(p, ft)
        ft.add("POST", "/messages", counter_responder(responses))
    naps = []
    fn = {"gpt_binary": lambda: p.ev.evaluate_gpt_binary(
              client, GPT, "Is a tent a building?", targets=("Yes", "No")),
          "gpt_confidence": lambda: p.ev.evaluate_gpt_confidence(
              client, GPT, "Is a tent a building?"),
          "gemini_binary": lambda: p.ev.evaluate_gemini_binary(
              client, GEMINI, "q?", targets=("Covered", "Not")),
          "gemini_confidence": lambda: p.ev.evaluate_gemini_confidence(
              client, GEMINI, "q?"),
          "claude": lambda: p.ev.evaluate_claude(
              client, CLAUDE, "q?", sleep=naps.append, delay=1.5)}[kind]
    return fn(), naps


EVAL_CASES = {
    "gpt_binary": [(200, chat("Yes", top_lp(("Yes", 0.7), ("No", 0.2))))],
    "gpt_binary_missing_targets": [(200, chat("Maybe", top_lp(("Maybe", 0.9))))],
    "gpt_binary_no_logprobs": [(200, chat("Yes"))],
    "gpt_confidence": [(200, chat("85", top_lp(("85", 0.8), ("90", 0.2))))],
    "gpt_confidence_words": [(200, chat("about 70", top_lp(("about", 0.5))))],
    "gemini_binary": [(200, gemini_response(
        "Covered", [[(" Covered", 0.6), ("Not", 0.3)]]))],
    "gemini_confidence": [(200, gemini_response(
        "85", [[("8", 0.7), ("9", 0.2)], [("5", 0.6), ("0", 0.3)]]))],
    "gemini_confidence_empty": [(200, {"candidates": []})],
    "claude": [(200, {"content": [{"type": "text", "text": "Yes"}]}),
               (200, {"content": [{"type": "text", "text": "I'd say 85."}]})],
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluators_match_reference(case):
    kind = next(k for k in ("gpt_binary", "gpt_confidence", "gemini_binary",
                            "gemini_confidence", "claude")
                if case.startswith(k))
    out = twin(lambda p: [],
               lambda p, ft: _evaluate(kind, p, ft, EVAL_CASES[case]))
    assert_twins(out)
    assert out["torch"][0][0] == "ok"


@pytest.mark.parametrize("seed", [0, 42, 7])
def test_baselines_match_reference(seed):
    for _ in range(3):
        assert (tev.evaluate_random_baseline(np.random.default_rng(seed))
                == jev.evaluate_random_baseline(np.random.default_rng(seed)))
    assert (tev.evaluate_normal_baseline(0.619, 0.167,
                                         np.random.default_rng(seed))
            == jev.evaluate_normal_baseline(0.619, 0.167,
                                            np.random.default_rng(seed)))


def test_first_token_target_probs_and_constants_match_reference():
    top = top_lp(("Covered", 0.5), ("Not", 0.4), ("Covered", 0.1))
    assert (tapi.first_token_target_probs(top, ("Covered", "Not"))
            == japi.first_token_target_probs(top, ("Covered", "Not")))
    assert tev.BINARY_SUFFIX == jev.BINARY_SUFFIX
    assert tev.CONFIDENCE_SUFFIX == jev.CONFIDENCE_SUFFIX
    assert tgem.SAFETY_OFF == jgem.SAFETY_OFF
    for model in ("o1", "o3-mini", "o4-mini", "gpt-5", "gpt-4.1", "gpt-4o",
                  "claude-3"):
        assert tapi.is_reasoning_model(model) == japi.is_reasoning_model(model)
    assert {n for n in dir(japi) if not n.startswith("_")} <= set(dir(tapi))


# -- cache, processed set, workbook append, prompts ----------------------------

def test_response_cache_matches_reference(tmp_path):
    q = "Is a screenshot a photograph?" + "x" * 200
    gpt = {"gpt_response": "Yes", "gpt_yes_prob": 0.7, "gpt_no_prob": 0.2,
           "gpt_relative_prob": 0.78, "gpt_confidence": 80,
           "gpt_weighted_confidence": None}
    out = {}
    for name, mod in (("jax", jcache), ("torch", tcache)):
        path = str(tmp_path / name / "api_cache.json")
        cache = mod.ResponseCache(path)
        cache.put(q, gpt)
        cache.put("short?", {"claude_response": "No"}, flush=False)
        cache.put("short?", {"claude_confidence": 10})
        again = mod.ResponseCache(path)
        with open(path, "rb") as f:
            data = f.read()
        out[name] = (data, len(again), again.missing_evaluators(q),
                     again.missing_evaluators("short?", ("claude", "gpt")),
                     again.is_complete("short?", ("claude",)),
                     again.get(q[:100] + "OTHER TAIL"), again.get("absent"),
                     mod.cache_key(q))
    assert out["torch"] == out["jax"]
    assert tcache.REQUIRED_FIELDS == jcache.REQUIRED_FIELDS


def test_processed_set_matches_reference(tmp_path):
    keys = [("m", "orig", 3), "bare-model", ("m", "orig", "3"), ("a", 1),
            ["list", "key"]]
    out = {}
    for name, mod in (("jax", jckpt), ("torch", tckpt)):
        path = str(tmp_path / name / "processed.json")
        s = mod.ProcessedSet(path)
        s.add(keys[0])
        s.update(keys[1:3])
        s.update(keys[3:], flush=False)
        s.flush()
        again = mod.ProcessedSet(path)
        with open(path, "rb") as f:
            data = f.read()
        out[name] = (data, len(again), [k in again for k in keys],
                     ("m", "orig", 4) in again)
    assert out["torch"] == out["jax"]


def _frame_rows(columns, rows):
    return pd.DataFrame(rows, columns=columns)


@pytest.mark.parametrize("case", ["fresh", "append", "new_column", "empty_old"])
def test_append_xlsx_cells_match_reference(tmp_path, case):
    """The pandas-free ``append_xlsx`` writes a workbook whose cells read
    back (with the port's ``read_xlsx``) as the JAX package's do, and
    returns the combined rows."""
    cols = ["Model", "Token_1_Prob", "Odds_Ratio", "Confidence Value",
            "Weighted Confidence"]
    first = [{"Model": "m", "Token_1_Prob": 0.7, "Odds_Ratio": float("inf"),
              "Confidence Value": 85, "Weighted Confidence": None},
             {"Model": "m", "Token_1_Prob": 0.0, "Odds_Ratio": 0.0,
              "Confidence Value": None, "Weighted Confidence": 61.25}]
    second = [{"Model": "n", "Token_1_Prob": 0.25, "Odds_Ratio": 2.5,
               "Confidence Value": 40, "Weighted Confidence": 40.5,
               "Extra": "x"}]
    cols2 = cols + ["Extra"] if case == "new_column" else cols
    paths = {n: str(tmp_path / f"{n}.xlsx") for n in ("jax", "torch")}
    if case in ("append", "new_column"):
        jxlsx.append_xlsx(_frame_rows(cols, first), paths["jax"])
        txlsx.append_xlsx(cols, first, paths["torch"])
    if case == "empty_old":
        jxlsx.write_xlsx(pd.DataFrame(columns=["Old"]), paths["jax"])
        txlsx.write_xlsx(["Old"], [], paths["torch"])
    combined = jxlsx.append_xlsx(_frame_rows(cols2, second), paths["jax"])
    got = txlsx.append_xlsx(cols2, second, paths["torch"])
    jcols, jrows = txlsx.read_xlsx(paths["jax"])
    tcols, trows = txlsx.read_xlsx(paths["torch"])
    assert tcols == jcols == list(combined.columns)
    assert trows == jrows
    assert len(got) == len(combined)
    assert [r["Model"] for r in got] == list(combined["Model"])


@pytest.mark.parametrize("main,fmt", [
    ("Is a tent a building?", "Answer only 'Yes' or 'No'."),
    ("", "x"), ("Trailing space ", " lead"),
])
def test_sweep_prompt_formats_match_reference(main, fmt):
    assert (tprompts.format_binary_prompt(main, fmt)
            == jprompts.format_binary_prompt(main, fmt))
    assert (tprompts.format_confidence_prompt(main, fmt)
            == jprompts.format_confidence_prompt(main, fmt))
