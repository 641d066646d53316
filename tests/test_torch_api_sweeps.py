"""The port's frontier-API perturbation sweeps (``sweeps/api_perturbation.py``)
against the JAX package's, over the same scripted vendors.

Each vendor below is a ``FakeTransport`` script that answers from the
request's own text (a CRC of it picks the tokens and log-probabilities), so
both packages' sweeps see the same answers whatever order their threads
ask in.  Compared: every request sent, the workbook's cells (both read
back with the port's ``read_xlsx``, same columns and order), the rows each
sweep returns, and resume from a half-written workbook.  The threaded legs
(the OpenAI fan-out over models, Gemini's workers) order rows by
completion, so those runs compare rows as sets and a one-worker run
compares the order.
"""

import json
import math
import types
import zlib

import pytest

import llm_interpretation_replication_tpu.api_backends as japi
import llm_interpretation_replication_tpu.sweeps.api_perturbation as jsweep
import llm_interpretation_replication_tpu.utils.retry as jretry
import llm_interpretation_replication_tpu_torch.api_backends as tapi
import llm_interpretation_replication_tpu_torch.sweeps.api_perturbation as tsweep
import llm_interpretation_replication_tpu_torch.utils.retry as tretry
from llm_interpretation_replication_tpu_torch.config import legal_scenarios
from llm_interpretation_replication_tpu_torch.sweeps import writers
from llm_interpretation_replication_tpu_torch.utils.xlsx import read_xlsx
from test_torch_api_backends import mask_calls
from test_torch_slots import one_torch_thread  # noqa: F401

PKGS = {
    "jax": types.SimpleNamespace(api=japi, sweep=jsweep, retry=jretry),
    "torch": types.SimpleNamespace(api=tapi, sweep=tsweep, retry=tretry),
}

TOKENS = ["Covered", "Not", "Ultimate", "First", "Existing", "Future",
          "Monthly", "Payment"]


def scenarios(n_scen=2, n_reph=5):
    return [dict(s, rephrasings=[f"{s['original_main'][:60]} variant {i}?"
                                 for i in range(n_reph)])
            for s in legal_scenarios()[:n_scen]]


def crc(text):
    return zlib.crc32(text.encode())


def is_confidence(text):
    return "How confident" in text


def binary_top(text):
    """Eight candidate tokens with CRC-picked weights, best first."""
    h = crc(text)
    w = [1 + (h >> (3 * i)) % 8 for i in range(len(TOKENS))]
    total = sum(w)
    pairs = sorted(zip(TOKENS, (x / total for x in w)), key=lambda t: -t[1])
    return [{"token": t, "logprob": math.log(p)} for t, p in pairs]


def confidence_values(text):
    h = crc(text)
    return [h % 101, (h // 7) % 101, (h // 49) % 101]


def openai_body(text):
    if is_confidence(text):
        vals = confidence_values(text)
        top = [{"token": str(v), "logprob": math.log(p)}
               for v, p in zip(vals, (0.6, 0.25, 0.1))]
        answer = str(vals[0])
    else:
        top = binary_top(text)
        answer = top[0]["token"]
    return {"choices": [{"message": {"content": answer},
                         "logprobs": {"content": [{"token": answer,
                                                   "top_logprobs": top}]}}],
            "usage": {"prompt_tokens": len(text) // 4, "completion_tokens": 2}}


def fast_retry(p):
    return p.retry.RetryPolicy(retry_on=(p.api.TransportError,),
                               max_retries=2, initial_delay=0.0,
                               sleep=lambda s: None)


def quiet(*args, **kwargs):
    return None


# -- the scripted vendors -----------------------------------------------------

class OpenAIBatchVendor:
    """Files, batches and downloads: each upload is one batch whose output
    answers every request line from its own text; a reasoning model's
    request lines answer in plain text, without logprobs, and the
    confidence requests of the rephrasings marked ``variant 3`` expire."""

    def __init__(self):
        self.files, self.batches = {}, {}

    def handlers(self):
        return [("POST", "/files", self.upload), ("POST", "/batches", self.create),
                ("GET", "/batches/", self.poll), ("GET", "/content", self.download)]

    def upload(self, call):
        lines = [json.loads(line) for line in
                 call["data"].decode(errors="ignore").splitlines()
                 if line.startswith("{")]
        # ids from the content: models racing on threads get the same ids
        # in both packages
        fid = f"file-{crc(json.dumps(lines)):08x}"
        self.files[fid] = lines
        return 200, {"id": fid}

    def create(self, call):
        fid = call["json"]["input_file_id"]
        bid = f"batch-{fid[5:]}"
        self.batches[bid] = fid
        return 200, {"id": bid, "status": "validating"}

    def poll(self, call):
        bid = call["url"].rsplit("/", 1)[1]
        return 200, {"id": bid, "status": "completed",
                     "output_file_id": f"out-{self.batches[bid]}"}

    def download(self, call):
        fid = call["url"].split("/files/out-")[1].split("/content")[0]
        out = []
        for req in self.files[fid]:
            text = req["body"]["messages"][0]["content"]
            body = openai_body(text)
            if "max_completion_tokens" in req["body"]:
                body["choices"][0].pop("logprobs")
            if "variant 3" in text and is_confidence(text):
                out.append({"custom_id": req["custom_id"], "response": None,
                            "error": {"message": "expired"}})
                continue
            out.append({"custom_id": req["custom_id"],
                        "response": {"body": body}})
        return 200, "\n".join(json.dumps(x) for x in out).encode()


class ClaudeBatchVendor:
    """Message batches: every request succeeds with a verbalized
    confidence, but for the rephrasings marked ``variant 2``, which
    error."""

    def __init__(self):
        self.batches = {}

    def handlers(self):
        return [("POST", "/messages/batches", self.create),
                ("GET", "/results", self.results),
                ("GET", "/messages/batches/", self.poll)]

    def create(self, call):
        bid = f"msgbatch-{len(self.batches)}"
        self.batches[bid] = call["json"]["requests"]
        return 200, {"id": bid, "processing_status": "in_progress"}

    def poll(self, call):
        return 200, {"id": call["url"].rsplit("/", 1)[1],
                     "processing_status": "ended"}

    def results(self, call):
        bid = call["url"].split("/messages/batches/")[1].split("/")[0]
        out = []
        for req in self.batches[bid]:
            text = req["params"]["messages"][0]["content"]
            if "variant 2" in text:
                out.append({"custom_id": req["custom_id"],
                            "result": {"type": "errored"}})
                continue
            out.append({"custom_id": req["custom_id"], "result": {
                "type": "succeeded", "message": {"content": [
                    {"type": "text",
                     "text": f" I am {confidence_values(text)[0]}% sure. "}]}}})
        return 200, "\n".join(json.dumps(x) for x in out).encode()


def gpt_sync_vendor(fail_marker=None):
    def respond(call):
        text = call["json"]["messages"][0]["content"]
        if fail_marker and fail_marker in text:
            raise PKG_ERRORS[call["pkg"]](400, "bad request", retryable=False)
        return 200, openai_body(text)

    return [("POST", "/chat/completions", respond)]


def gemini_vendor(fail_marker=None):
    def respond(call):
        text = call["json"]["contents"][0]["parts"][0]["text"]
        if fail_marker and fail_marker in text:
            raise PKG_ERRORS[call["pkg"]](400, "blocked", retryable=False)
        if is_confidence(text):
            v = confidence_values(text)
            digits = [[(d, math.log(p)) for d, p in zip(pos, (0.7, 0.2))]
                      for pos in zip(f"{v[0]:02d}", f"{v[1]:02d}")]
            answer = f"{v[0]}"
        else:
            top = binary_top(text)
            digits = [[(" " + t["token"], t["logprob"]) for t in top]]
            answer = top[0]["token"]
        return 200, {"candidates": [{
            "content": {"parts": [{"text": answer}]},
            "logprobsResult": {"topCandidates": [
                {"candidates": [{"token": t, "logProbability": lp}
                                for t, lp in pos]} for pos in digits]}}]}

    return [("POST", ":generateContent", respond)]


PKG_ERRORS = {"jax": japi.TransportError, "torch": tapi.TransportError}


class Recorder:
    """A package's ``FakeTransport`` that tags every call with the package
    (the scripted vendors raise that package's ``TransportError``)."""

    def __init__(self, name, handlers):
        self.name = name
        self.ft = PKGS[name].api.FakeTransport()
        for method, sub, respond in handlers:
            self.ft.add(method, sub, self._tagged(respond))

    def _tagged(self, respond):
        def call(c):
            c["pkg"] = self.name
            return respond(c)

        return call


def client_for(kind, name, rec):
    p = PKGS[name]
    if kind == "openai":
        return p.api.OpenAIClient("k", transport=rec.ft,
                                  retry_policy=fast_retry(p))
    if kind == "anthropic":
        return p.api.AnthropicClient("k", transport=rec.ft,
                                     retry_policy=fast_retry(p))
    return p.api.GeminiClient("k", transport=rec.ft,
                              retry_policy=fast_retry(p))


def calls(rec):
    return mask_calls([{k: v for k, v in c.items() if k != "pkg"}
                       for c in rec.ft.calls])


def returned(rows):
    """A sweep's return value as row dicts (the JAX package returns a
    DataFrame read from the workbook)."""
    return rows if isinstance(rows, list) else None


def run_twin(tmp_path, kind, vendor, run):
    """``run(pkg, client, path)`` on both packages over fresh vendors;
    returns ``{name: (returned rows or None, columns, rows, calls)}``."""
    out = {}
    for name in PKGS:
        v = vendor()
        rec = Recorder(name, v.handlers() if hasattr(v, "handlers") else v)
        path = str(tmp_path / f"{name}.xlsx")
        got = run(PKGS[name], client_for(kind, name, rec), path)
        cols, rows = read_xlsx(path)
        out[name] = (returned(got), cols, rows, calls(rec))
    return out


def sort_rows(rows):
    return sorted(rows, key=lambda r: json.dumps(r, sort_keys=True, default=str))


def assert_same(out, ordered=True):
    t, j = out["torch"], out["jax"]
    assert t[1] == j[1]                                   # columns
    if ordered:
        assert t[2] == j[2]
        assert t[3] == j[3]
    else:
        assert sort_rows(t[2]) == sort_rows(j[2])
        assert sorted(t[3], key=repr) == sorted(j[3], key=repr)
    assert t[0] == t[2]                 # the port returns the workbook's rows


# -- the OpenAI batch leg -----------------------------------------------------

@pytest.mark.parametrize("models,reasoning_runs", [
    (["gpt-4.1"], False), (["gpt-5"], False), (["o3"], True),
])
def test_openai_batch_sweep_matches_reference(tmp_path, models,
                                              reasoning_runs):
    """One model at a time: requests, cells and order equal; the
    confidence rows the vendor expired stay out for resume."""
    costs = {}

    def run(p, client, path):
        cost = p.api.CostTracker(pricing={models[0]: {"input": 2.0,
                                                      "output": 8.0}})
        rows = p.sweep.run_api_perturbation_sweep(
            client, models, scenarios(), path, max_workers=1,
            skip_reasoning_logprobs=not reasoning_runs, cost_tracker=cost,
            sleep=lambda s: None, log=quiet)
        costs[p.sweep.__name__] = (cost.summary(), cost.total_cost())
        return rows

    out = run_twin(tmp_path, "openai", OpenAIBatchVendor, run)
    assert_same(out)
    assert out["torch"][1] == writers.PERTURBATION_COLUMNS
    assert len(out["torch"][2]) == 8        # variant 3's pairs are left out
    assert costs[tsweep.__name__] == costs[jsweep.__name__]
    assert costs[tsweep.__name__][1] > 0


def test_openai_batch_sweep_models_in_parallel_and_resume(tmp_path):
    """Three models on three threads (rows in completion order), then a
    resume that submits only the expired pairs again, then one more model
    appended."""
    models = ["gpt-4.1", "gpt-4o", "gpt-5"]
    out = {}
    for name, p in PKGS.items():
        rec = Recorder(name, OpenAIBatchVendor().handlers())
        client = client_for("openai", name, rec)
        path = str(tmp_path / f"{name}.xlsx")
        p.sweep.run_api_perturbation_sweep(client, models, scenarios(), path,
                                           sleep=lambda s: None, log=quiet)
        first = read_xlsx(path)
        n_calls = len(rec.ft.calls)
        p.sweep.run_api_perturbation_sweep(client, models, scenarios(), path,
                                           sleep=lambda s: None, log=quiet)
        resumed_calls = len(rec.ft.calls) - n_calls
        p.sweep.run_api_perturbation_sweep(client, ["gpt-4.1-mini"],
                                           scenarios(), path,
                                           sleep=lambda s: None, log=quiet)
        cols, rows = read_xlsx(path)
        out[name] = (first[0], sort_rows(first[1]), resumed_calls, cols,
                     rows[len(first[1]):],
                     sorted(calls(rec), key=repr))
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == 3 * 4         # one batch a model: variant 3
    assert len(out["torch"][1]) == 3 * 8
    assert len(out["torch"][4]) == 8


@pytest.mark.parametrize("model,skip", [("gpt-4.1", True), ("o3", False),
                                        ("o3", True)])
def test_batch_request_building_and_extraction_match_reference(model, skip):
    """The request list, the id map, the regrouping and the extracted rows
    (a half-failed pair, missing binary results, reasoning frequencies)
    are the reference's."""
    scen = scenarios(2, 3)
    processed = {(model, scen[0]["original_main"], scen[0]["rephrasings"][1])}
    got = {}
    for name, p in PKGS.items():
        reqs, mapping = p.sweep.create_batch_requests(
            model, scen, processed=processed, skip_reasoning_logprobs=skip,
            max_rephrasings=2)
        raw = []
        for cid, info in mapping.items():
            body = openai_body(f"{info['rephrased_main']} "
                               + (info["response_format"]
                                  if info["format_type"] == "binary"
                                  else info["confidence_format"]))
            if info["format_type"] == "binary" and "run_idx" in info:
                body["choices"][0]["message"]["content"] = (
                    info["target_tokens"][info["run_idx"] % 3 == 0])
            if info["prompt_idx"] == 1 and info["rephrase_idx"] == 0 \
                    and info["format_type"] == "confidence":
                raw.append({"custom_id": cid, "error": {"message": "x"}})
                continue
            if info["prompt_idx"] == 1 and info["rephrase_idx"] == 1 \
                    and info["format_type"] == "binary":
                continue
            raw.append({"custom_id": cid, "response": {"body": body}})
        raw.append({"custom_id": "unknown", "response": {"body": {}}})
        grouped = p.sweep.group_batch_results(raw, mapping)
        notes = []
        rows = p.sweep.extract_results_from_batch(
            grouped, model, skip_reasoning_logprobs=skip, log=notes.append)
        got[name] = (reqs, mapping, {str(k): v for k, v in grouped.items()},
                     rows, notes)
    assert got["torch"] == got["jax"]
    assert tsweep.REASONING_MODEL_RUNS == jsweep.REASONING_MODEL_RUNS


# -- the Claude message-batch leg ----------------------------------------------

def test_claude_batch_sweep_matches_reference_and_resumes(tmp_path, monkeypatch):
    """Confidence only, 16 columns; errored requests stay out; a resume
    submits only what is missing; another model in the same workbook is
    not masked (batches chunked at 4 in both packages)."""
    from llm_interpretation_replication_tpu.api_backends import (
        anthropic_client as jant)
    from llm_interpretation_replication_tpu_torch.api_backends import (
        anthropic_client as tant)

    monkeypatch.setattr(jant, "MAX_BATCH_SIZE", 4)
    monkeypatch.setattr(tant, "MAX_BATCH_SIZE", 4)
    model = "claude-opus-4-1-20250805"

    def run(p, client, path):
        first = p.sweep.run_claude_perturbation_sweep(
            client, model, scenarios(2, 3), path, max_rephrasings=2,
            sleep=lambda s: None, log=quiet)
        p.sweep.run_claude_perturbation_sweep(
            client, model, scenarios(), path, sleep=lambda s: None, log=quiet)
        p.sweep.run_claude_perturbation_sweep(
            client, "claude-sonnet-4", scenarios(1, 2), path,
            sleep=lambda s: None, log=quiet)
        rows = p.sweep.run_claude_perturbation_sweep(
            client, model, scenarios(), path, sleep=lambda s: None, log=quiet)
        return rows if isinstance(rows, list) else len(first)

    out = run_twin(tmp_path, "anthropic", ClaudeBatchVendor, run)
    assert_same(out)
    assert out["torch"][1] == writers.CLAUDE_PERTURBATION_COLUMNS
    assert len(out["torch"][2]) == 4 + 4 + 2      # variant 2 errors each time
    assert writers.CLAUDE_PERTURBATION_COLUMNS == \
        __import__("llm_interpretation_replication_tpu.sweeps.writers",
                   fromlist=["x"]).CLAUDE_PERTURBATION_COLUMNS


def test_claude_rows_and_requests_match_reference():
    scen = scenarios(2, 3)
    processed = {(scen[1]["original_main"], scen[1]["rephrasings"][0])}
    got = {}
    for name, p in PKGS.items():
        reqs, mapping = p.sweep.create_claude_batch_requests(
            "claude-x", scen, processed=processed)
        raw = [{"custom_id": cid, "result": (
            {"type": "succeeded", "message": {"content": [
                {"type": "text", "text": f"{i * 13 % 101} out of 100"}]}}
            if i % 4 else {"type": "expired"})}
            for i, cid in enumerate(mapping)]
        raw.append({"custom_id": "stray", "result": {"type": "succeeded"}})
        notes = []
        got[name] = (reqs, mapping, p.sweep.extract_claude_batch_rows(
            raw, mapping, "claude-x", log=notes.append), notes)
    assert got["torch"] == got["jax"]


# -- the GPT sync leg ------------------------------------------------------------

def test_gpt_sync_sweep_checkpoints_failures_and_resume(tmp_path):
    """A first pass where one rephrasing fails (left out, retried on
    resume), workbook appends every 3 rows, then a resume that asks only
    for the failed rows."""
    model = "gpt-4-0125-preview"

    def run(p, client, path):
        naps = []
        p.sweep.run_gpt_perturbation_sweep(
            client, model, scenarios(), path, checkpoint_every=3,
            sleep=naps.append, log=quiet)
        return naps

    out = {}
    for name, p in PKGS.items():
        path = str(tmp_path / f"{name}.xlsx")
        rec = Recorder(name, gpt_sync_vendor(fail_marker="variant 4"))
        naps = run(p, client_for("openai", name, rec), path)
        half = read_xlsx(path)
        rec2 = Recorder(name, gpt_sync_vendor())
        rows = p.sweep.run_gpt_perturbation_sweep(
            client_for("openai", name, rec2), model, scenarios(), path,
            rate_limit_sleep=0, log=quiet)
        out[name] = (naps, half, calls(rec), read_xlsx(path), calls(rec2),
                     rows if isinstance(rows, list) else None)
    t, j = out["torch"], out["jax"]
    assert t[:5] == j[:5]
    assert t[5] == t[3][1]
    assert len(t[1][1]) == 8 and len(t[3][1]) == 10
    assert len(t[4]) == 4                   # the 2 failed rows, 2 calls each
    assert t[0] == [0.5] * 10


def test_gpt_sync_sweep_refusals_match_reference(tmp_path):
    for name, p in PKGS.items():
        rec = Recorder(name, gpt_sync_vendor(fail_marker="variant"))
        client = client_for("openai", name, rec)
        with pytest.raises(ValueError, match="reasoning model"):
            p.sweep.run_gpt_perturbation_sweep(
                client, "o3", scenarios(), str(tmp_path / "r.xlsx"), log=quiet)
        with pytest.raises(RuntimeError, match="every evaluation failed"):
            p.sweep.run_gpt_perturbation_sweep(
                client, "gpt-4o", scenarios(1, 2), str(tmp_path / "f.xlsx"),
                rate_limit_sleep=0, log=quiet)
        assert not (tmp_path / "f.xlsx").exists()


# -- the Gemini threaded leg ------------------------------------------------------

def test_gemini_sweep_one_worker_matches_reference(tmp_path):
    def run(p, client, path):
        return p.sweep.run_gemini_perturbation_sweep(
            client, "gemini-2.5-pro", scenarios(), path, max_workers=1,
            checkpoint_every=4, log=quiet)

    out = run_twin(tmp_path, "gemini", lambda: gemini_vendor(), run)
    assert_same(out)
    assert len(out["torch"][2]) == 10


def test_gemini_sweep_threads_failures_and_resume(tmp_path):
    """Four workers (rows in completion order), one rephrasing blocked
    and left out, a resume over a working vendor that asks only for it,
    and a second model appended."""
    out = {}
    for name, p in PKGS.items():
        path = str(tmp_path / f"{name}.xlsx")
        rec = Recorder(name, gemini_vendor(fail_marker="variant 1"))
        p.sweep.run_gemini_perturbation_sweep(
            client_for("gemini", name, rec), "gemini-2.5-pro", scenarios(),
            path, max_workers=4, checkpoint_every=3, log=quiet)
        half = read_xlsx(path)
        rec2 = Recorder(name, gemini_vendor())
        client = client_for("gemini", name, rec2)
        p.sweep.run_gemini_perturbation_sweep(
            client, "gemini-2.5-pro", scenarios(), path, max_workers=4,
            log=quiet)
        n_resume = len(rec2.ft.calls)
        rows = p.sweep.run_gemini_perturbation_sweep(
            client, "gemini-2.0-flash", scenarios(1, 3), path, max_workers=2,
            log=quiet)
        cols, final = read_xlsx(path)
        out[name] = (half[0], sort_rows(half[1]), n_resume, cols,
                     sort_rows(final),
                     sorted(calls(rec), key=repr),
                     sorted(calls(rec2), key=repr),
                     rows if isinstance(rows, list) else None)
    t, j = out["torch"], out["jax"]
    assert t[:7] == j[:7]
    assert sort_rows(t[7]) == t[4]
    assert len(t[1]) == 8 and t[2] == 4 and len(t[4]) == 13


def test_load_processed_triples_matches_reference(tmp_path):
    path = str(tmp_path / "w.xlsx")
    assert tsweep.load_processed_triples(path) == set()
    rows = [writers.perturbation_row(m, s, r) for m in ("a", "b")
            for s in scenarios(2, 2) for r in s["rephrasings"]]
    rows.append(writers.perturbation_row("c", scenarios(1, 1)[0], "12"))
    from llm_interpretation_replication_tpu_torch.utils.xlsx import write_xlsx

    write_xlsx(writers.PERTURBATION_COLUMNS, rows, path)
    assert tsweep.load_processed_triples(path) == \
        jsweep.load_processed_triples(path)
    assert len(tsweep.load_processed_triples(path)) == 9
