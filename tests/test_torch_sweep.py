"""The sweep shell and its host copies against the JAX package: the
workbook (``utils/xlsx``, ``sweeps/writers``), the side-log, retry,
prefetch and preemption helpers, ``load_perturbations``, the engine's
``first_token_relative_prob``, and ``run_model_perturbation_sweep`` on the
same weights and tokenizer in both packages.

Model: ``FLAGSHIP_SMALL_GEOMETRY`` in float32, seed-7 weights with the
embedding rows past the tokenizer's ids zeroed (tied embeddings: every
greedy token then has a text); the tokenizer is a ``WordTokenizer`` over the
legal scenarios' words, which both engines take.  The rephrasings are
word-level edits of each scenario's first 14-21 words.  Workbooks are read
back with the port's ``read_xlsx`` and compared cell for cell: text
identical, numbers rtol 2e-5 (atol 1e-9), empty cells empty.
"""

import dataclasses
import functools
import io
import json
import os
import random
import signal
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from helpers import random_decoder_params
from llm_interpretation_replication_tpu.config import legal_scenarios as j_scenarios
from llm_interpretation_replication_tpu.gen import rephrase as jrephrase
from llm_interpretation_replication_tpu.models import config as jconfig
from llm_interpretation_replication_tpu.runtime import batching as jbatching
from llm_interpretation_replication_tpu.runtime import engine as jengine
from llm_interpretation_replication_tpu.runtime import faults as jfaults
from llm_interpretation_replication_tpu.sweeps import perturbation as jsweep
from llm_interpretation_replication_tpu.sweeps import writers as jwriters
from llm_interpretation_replication_tpu.utils import checkpoint as jcheckpoint
from llm_interpretation_replication_tpu.utils import telemetry as jtel
from llm_interpretation_replication_tpu.utils import xlsx as jxlsx
from llm_interpretation_replication_tpu.utils.retry import RetryPolicy as JRetryPolicy
from llm_interpretation_replication_tpu_torch.config import legal_scenarios
from llm_interpretation_replication_tpu_torch.gen import rephrase
from llm_interpretation_replication_tpu_torch.models import config as tconfig
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.runtime import batching
from llm_interpretation_replication_tpu_torch.runtime import engine as tengine
from llm_interpretation_replication_tpu_torch.runtime import faults
from llm_interpretation_replication_tpu_torch.sweeps import perturbation as tsweep
from llm_interpretation_replication_tpu_torch.sweeps import writers
from llm_interpretation_replication_tpu_torch.utils import checkpoint
from llm_interpretation_replication_tpu_torch.utils import telemetry as ttel
from llm_interpretation_replication_tpu_torch.utils import xlsx
from llm_interpretation_replication_tpu_torch.utils.logging import SessionLogger
from llm_interpretation_replication_tpu_torch.utils.retry import RetryPolicy
from llm_interpretation_replication_tpu_torch.utils.tokenizer import WordTokenizer
from test_torch_slots import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-5, 1e-9
MODEL = "tiny/falcon-test"
PER_SCENARIO = 3
ECFG = dict(batch_size=4, max_new_tokens=8, buckets=(32, 48, 64))
SWEEP_KW = dict(checkpoint_every=3, score_chunk=6)


# -- host copies ----------------------------------------------------------------

def test_data_asset_is_byte_identical():
    with open(os.path.join(ROOT, "llm_interpretation_replication_tpu",
                           "data_assets", "legal_scenarios.json"), "rb") as f:
        ref = f.read()
    with open(os.path.join(ROOT, "llm_interpretation_replication_tpu_torch",
                           "data_assets", "legal_scenarios.json"), "rb") as f:
        assert f.read() == ref
    assert legal_scenarios() == j_scenarios()


CELLS = {
    "text": ["plain", "bell\x07 and tab\t", "<&>\"'", "", "nul\x00x\x1f"],
    "int": [0, -3, 12345678901, 7, 1],
    "float": [0.5, float("nan"), float("inf"), -float("inf"), 1e-7],
    "none": [None, 2, None, 0.25, "x"],
    "bool": [True, False, True, False, True],
}
COLUMNS = list(CELLS)
ROWS = [{c: CELLS[c][i] for c in COLUMNS} for i in range(5)]


def _norm(v):
    """A cell as a plain Python value, with NaN read as empty."""
    if hasattr(v, "item"):
        v = v.item()
    return None if isinstance(v, float) and np.isnan(v) else v


def _same_cell(a, b):
    a, b = _norm(a), _norm(b)
    return a == b and isinstance(a, bool) == isinstance(b, bool)


def test_xlsx_cross_reads(tmp_path):
    """The port's workbook read by the JAX reader, and the JAX workbook
    read by the port's, cell for cell; both files hold the same XML (a
    column with no int beside an empty cell: pandas would make that one
    float, so the reference writes ``85.0`` where the port writes
    ``85``)."""
    import pandas as pd

    tpath, jpath = str(tmp_path / "t.xlsx"), str(tmp_path / "j.xlsx")
    xlsx.write_xlsx(COLUMNS, ROWS, tpath)
    jxlsx.write_xlsx(pd.DataFrame(ROWS, columns=COLUMNS), jpath)
    jdf = jxlsx.read_xlsx(tpath)
    cols, rows = xlsx.read_xlsx(jpath)
    assert list(jdf.columns) == cols == COLUMNS
    assert len(rows) == len(jdf) == 5
    for i, row in enumerate(rows):
        for c in COLUMNS:
            assert _same_cell(row[c], jdf[c].iloc[i]), (i, c, row[c],
                                                        jdf[c].iloc[i])
    # what each package reads of its own file equals the other's reading
    assert xlsx.read_xlsx(tpath) == (cols, rows)
    import zipfile
    with zipfile.ZipFile(tpath) as a, zipfile.ZipFile(jpath) as b:
        assert a.namelist() == b.namelist()
        for name in b.namelist():
            assert a.read(name) == b.read(name), name
    assert xlsx.read_xlsx(jpath, sheet=0)[1][0]["text"] == "plain"


def test_xlsx_sheets_and_errors(tmp_path):
    path = str(tmp_path / "s.xlsx")
    xlsx.write_xlsx_sheets({"A": (["x"], [{"x": 1}]),
                            "B": (["y", "z"], [{"y": "v"}])}, path)
    assert xlsx.read_xlsx(path, 1) == (["y", "z"], [{"y": "v", "z": None}])
    assert list(jxlsx.read_xlsx(path, 1).columns) == ["y", "z"]
    with pytest.raises(ValueError):
        xlsx.write_xlsx_sheets({}, path)
    with pytest.raises(ValueError):
        jxlsx.write_xlsx_sheets({}, path)


def test_perturbation_row_matches_reference():
    s = legal_scenarios()[2]
    kw = dict(response_text="Yes", confidence_text="85", logprobs_repr="x",
              token_1_prob=0.25, token_2_prob=0.5, odds_ratio=0.5,
              confidence_value=85, weighted_confidence=84.5)
    assert writers.perturbation_row("m/x", s, "r", **kw) == \
        jwriters.perturbation_row("m/x", s, "r", **kw)
    assert writers.perturbation_row("m/x", s, "r") == \
        jwriters.perturbation_row("m/x", s, "r")
    assert writers.PERTURBATION_COLUMNS == jwriters.PERTURBATION_COLUMNS
    for name in ("tiiuae/falcon-7b", "falcon-7b", "org/Llama-2-7b-hf"):
        assert writers.model_family_from_name(name) == \
            jwriters.model_family_from_name(name)


def test_append_jsonl_matches_reference(tmp_path):
    rows = [{"a": np.float32(0.5), "b": np.int64(3), "c": "t", "d": None},
            {"a": float("inf"), "e": [1, 2]}]
    checkpoint.append_jsonl(str(tmp_path / "t.jsonl"), rows)
    checkpoint.append_jsonl(str(tmp_path / "t.jsonl"), rows[:1], fsync=False)
    jcheckpoint.append_jsonl(str(tmp_path / "j.jsonl"), rows)
    jcheckpoint.append_jsonl(str(tmp_path / "j.jsonl"), rows[:1], fsync=False)
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()


@pytest.mark.parametrize("full_jitter", [False, True])
def test_retry_policy_delays_match_reference(full_jitter):
    kw = dict(initial_delay=2.0, max_delay=30.0, full_jitter=full_jitter)
    a = RetryPolicy(rng=random.Random(3), **kw)
    b = JRetryPolicy(rng=random.Random(3), **kw)
    assert [a.delay_for_attempt(i) for i in range(8)] == \
        [b.delay_for_attempt(i) for i in range(8)]


ERRORS = {
    "transient_error": lambda mod: mod.TransientError("x"),
    "connection_reset": lambda mod: ConnectionResetError("reset"),
    "timeout": lambda mod: TimeoutError(),
    "unavailable": lambda mod: RuntimeError("UNAVAILABLE: socket closed"),
    "deadline": lambda mod: RuntimeError("Deadline Exceeded"),
    "value_error": lambda mod: ValueError("bad shape"),
    "resource_exhausted": lambda mod: RuntimeError(
        "RESOURCE_EXHAUSTED: out of memory"),
    "cuda_oom": lambda mod: RuntimeError("CUDA out of memory. Tried to "
                                         "allocate 2.00 GiB"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_retry_transient_matches_reference(case):
    """Which errors retry (with the reference's delays and fault events)
    and which propagate at once; an exhausted budget re-raises.  The port
    also knows PyTorch's OOM text, which never retries."""
    runs = []
    for mod, tel in ((faults, ttel), (jfaults, jtel)):
        err = ERRORS[case](mod)
        slept, calls = [], []
        policy = dataclasses.replace(mod.default_transient_policy(),
                                     sleep=slept.append,
                                     rng=random.Random(0))

        def flaky(n=2):
            calls.append(1)
            if len(calls) <= n:
                raise err
            return "ok"

        before = len(tel.fault_events("transient_retry"))
        try:
            out = mod.retry_transient(flaky, policy, label="t")()
        except type(err):
            out = "raised"
        runs.append((mod.is_transient(err), out, len(calls), slept,
                     len(tel.fault_events("transient_retry")) - before))
        calls.clear()
        with pytest.raises(type(err)):
            mod.retry_transient(lambda: flaky(99), policy)()
    if case == "cuda_oom":
        assert runs[0] == (False, "raised", 1, [], 0)
    else:
        assert runs[0] == runs[1]
    assert runs[0][1] == ("ok" if runs[0][0] else "raised")


def test_host_prefetcher_order_close_and_errors():
    for cls in (batching.HostPrefetcher, jbatching.HostPrefetcher):
        pf = cls(range(6), lambda x: x * x)
        assert list(pf) == [0, 1, 4, 9, 16, 25]
        assert pf.closed
        pf.close()                                   # idempotent
        pf = cls(range(100), lambda x: x)
        it = iter(pf)
        assert [next(it), next(it)] == [0, 1]
        pf.close()
        pf.close()
        assert pf.closed

        def boom(x):
            if x == 2:
                raise KeyError("item 2")
            return x

        got = []
        with pytest.raises(KeyError):
            for v in cls(range(5), boom):
                got.append(v)
        assert got == [0, 1]


def _write_perturbations(path, records):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(records, f)


@pytest.mark.parametrize("case", ["ok", "count", "original_main",
                                  "response_format", "confidence_format",
                                  "target_tokens"])
def test_load_perturbations_matches_reference(tmp_path, case):
    recs = [dict(s, rephrasings=["r"]) for s in legal_scenarios()]
    if case == "count":
        recs = recs[:4]
    elif case == "target_tokens":
        recs[1]["target_tokens"] = ["Yes", "No"]
    elif case != "ok":
        recs[3][case] += " changed"
    path = str(tmp_path / "p.json")
    _write_perturbations(path, recs)
    outs = []
    for mod, scen in ((rephrase, legal_scenarios()),
                      (jrephrase, j_scenarios())):
        try:
            outs.append(mod.load_perturbations(path, expected_scenarios=scen))
        except ValueError as err:
            outs.append(str(err))
    assert outs[0] == outs[1]
    assert (case == "ok") == isinstance(outs[0], list)
    assert rephrase.load_perturbations(path) == jrephrase.load_perturbations(path)


def test_preemption_guard_flushes_and_raises():
    flushed = []
    for mod in (faults, jfaults):
        with pytest.raises(mod.Preempted) as info:
            with mod.PreemptionGuard(lambda: flushed.append(mod),
                                     lambda: 1 / 0, label="t") as guard:
                assert guard.active
                os.kill(os.getpid(), signal.SIGTERM)
        assert info.value.code == 128 + signal.SIGTERM
        assert not guard.active and guard.triggered == signal.SIGTERM
    assert flushed == [faults, jfaults]
    assert ttel.fault_events("preempted")
    # off the main thread no handler is installed
    box = []
    t = threading.Thread(target=lambda: box.append(
        faults.PreemptionGuard(lambda: None).__enter__().active))
    t.start()
    t.join(timeout=10)
    assert box == [False]


# -- the engines --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def scenarios():
    """The legal scenarios, each with PER_SCENARIO short rephrasings: word
    edits (a swap, a deletion, a duplication) of its first 14-21 words."""
    rng = np.random.default_rng(3)
    out = []
    for s in legal_scenarios():
        words = s["original_main"].split()
        reph = []
        for j in range(PER_SCENARIO):
            w = list(words[: 14 + 3 * j + int(rng.integers(0, 2))])
            i = int(rng.integers(1, len(w) - 1))
            w[i], w[i + 1] = w[i + 1], w[i]
            del w[int(rng.integers(0, len(w)))]
            k = int(rng.integers(0, len(w)))
            w.insert(k, w[k])
            reph.append(" ".join(w))
        out.append(dict(s, rephrasings=reph))
    return out


@functools.lru_cache(maxsize=None)
def tok():
    words = []
    for s in legal_scenarios():
        for key in ("original_main", "response_format", "confidence_format"):
            words += s[key].split()
        words += list(s["target_tokens"])
    return WordTokenizer(words)


@functools.lru_cache(maxsize=None)
def models():
    jcfg = jconfig.DecoderConfig(**{**jconfig.FLAGSHIP_SMALL_GEOMETRY,
                                    "attention_impl": "flash"})
    tcfg = tconfig.DecoderConfig(**{**tconfig.FLAGSHIP_SMALL_GEOMETRY,
                                    "attention_impl": "flash"})
    params_np = jax.tree_util.tree_map(np.array,
                                       random_decoder_params(jcfg, seed=7))
    assert len(tok()) <= jcfg.vocab_size
    params_np["embed"]["tokens"][len(tok()):] = 0
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    weights = convert.params_from_jax(params_np, tcfg, device="cpu",
                                      dtype="fp32")
    return jcfg, tcfg, params, weights


def engines(**kw):
    jcfg, tcfg, params, weights = models()
    kw = {**ECFG, **kw}
    jeng = jengine.ScoringEngine("falcon", jcfg, params, tok(),
                                 engine_config=jengine.EngineConfig(**kw))
    teng = tengine.ScoringEngine("falcon", tcfg, weights, tok(),
                                 engine_config=tengine.EngineConfig(**kw),
                                 device="cpu")
    return jeng, teng


class Faulty:
    """An engine wrapper that, on its ``at``-th scoring call, raises
    (``"crash"``), delivers SIGTERM to this process (``"sigterm"``) or
    returns NaN position-0 probabilities (``"nan"``); it delegates
    everything else."""

    def __init__(self, engine, kind, at):
        self._engine, self.kind, self.at, self.calls = engine, kind, at, 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _call(self, fn, *args, **kwargs):
        self.calls += 1
        if self.calls == self.at and self.kind == "crash":
            raise RuntimeError("injected crash")
        if self.calls == self.at and self.kind == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        out = fn(*args, **kwargs)
        if self.calls == self.at and self.kind == "nan":
            for row in out[0]:
                row["first_token_yes_prob"] = float("nan")
                row["first_token_no_prob"] = float("nan")
        return out

    def score_prefixed(self, *args, **kwargs):
        return self._call(self._engine.score_prefixed, *args, **kwargs)


def quiet():
    return SessionLogger(stream=io.StringIO())


def assert_workbooks_equal(path, ref_path):
    cols, rows = xlsx.read_xlsx(path)
    rcols, rrows = xlsx.read_xlsx(ref_path)
    assert cols == rcols == writers.PERTURBATION_COLUMNS
    assert len(rows) == len(rrows)
    for i, (a, b) in enumerate(zip(rows, rrows)):
        for c in cols:
            x, y = a[c], b[c]
            if isinstance(y, (int, float)) and not isinstance(y, bool):
                assert isinstance(x, (int, float)), (i, c, x, y)
                np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL,
                                           err_msg=f"row {i} {c}")
            else:
                assert x == y, (i, c, x, y)
    return rows


def _run(mod, engine, path, **kw):
    return mod.run_model_perturbation_sweep(
        engine, MODEL, scenarios(), str(path), log=quiet(),
        **{**SWEEP_KW, **kw})


def _sweep_rows_match(trows, jdf):
    """The port's returned rows against the JAX package's ``DataFrame``."""
    assert len(trows) == len(jdf)
    assert list(trows[0]) == list(jdf.columns)
    for i, row in enumerate(trows):
        for c, v in row.items():
            x, y = _norm(v), _norm(jdf[c].iloc[i])
            if isinstance(y, float):
                np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
            else:
                assert x == y, (i, c, x, y)


@pytest.mark.parametrize("route", ["fused", "legacy", "fallback"])
def test_sweep_workbooks_match_reference(tmp_path, route):
    """The fused route (both legs over one prefix cache, the chunks
    tokenized by the prefetcher), the two-string route, and the
    ``first_token_relative_prob`` fallback when the engine's top filter is
    not 20."""
    ecfg = dict(first_token_top_filter=5) if route == "fallback" else {}
    jeng, teng = engines(**ecfg)
    calls = []
    real = teng.first_token_relative_prob
    teng.first_token_relative_prob = lambda *a, **k: calls.append(k) or real(*a, **k)
    kw = dict(fuse_prefix=route != "legacy")
    jdf = _run(jsweep, jeng, tmp_path / "j.xlsx", **kw)
    trows = _run(tsweep, teng, tmp_path / "t.xlsx", **kw)
    _sweep_rows_match(trows, jdf)
    rows = assert_workbooks_equal(tmp_path / "t.xlsx", tmp_path / "j.xlsx")
    assert len(rows) == 5 * PER_SCENARIO
    for row, ref in zip(trows, xlsx.read_xlsx(tmp_path / "t.xlsx")[1]):
        assert list(row) == writers.PERTURBATION_COLUMNS
        for c, v in row.items():
            # a workbook keeps inf as its text
            assert _norm(v) == ref[c] or v == float(ref[c]), (c, v, ref[c])
    assert not os.path.exists(str(tmp_path / "t.xlsx") + ".rows.jsonl")
    assert bool(calls) == (route == "fallback")
    if calls:
        assert all(k["top_filter"] == 20 for k in calls)
    assert any(r["Model Response"] for r in rows)


@pytest.mark.parametrize("torn", [False, True])
def test_sweep_resumes_after_a_crash(tmp_path, torn):
    """A crash on the second chunk leaves the first chunk's rows in the
    side-log (plus, with ``torn``, a trailing line a hard kill tore); the
    same call again scores the rest, and each package's workbook equals
    the other's and an uninterrupted run's."""
    jeng, teng = engines()
    for mod, eng, name in ((jsweep, jeng, "j"), (tsweep, teng, "t")):
        out = tmp_path / f"{name}.xlsx"
        with pytest.raises(RuntimeError, match="injected crash"):
            _run(mod, Faulty(eng, "crash", 2), out)
        rows, keys = mod.load_existing_rows(str(out))
        assert len(rows) == SWEEP_KW["score_chunk"] and not out.exists()
        if torn:
            with open(str(out) + ".rows.jsonl", "a") as f:
                f.write('{"Model": "tiny/falcon-test", "Original Main Pa')
        resumed = Faulty(eng, "none", 0)
        _run(mod, resumed, out)
        assert resumed.calls == 2          # the two unfinished chunks
    assert_workbooks_equal(tmp_path / "t.xlsx", tmp_path / "j.xlsx")
    _run(tsweep, teng, tmp_path / "clean.xlsx")
    assert_workbooks_equal(tmp_path / "t.xlsx", tmp_path / "clean.xlsx")


def test_sweep_resumes_from_a_finished_workbook(tmp_path):
    """A sweep cut to 2 rephrasings a scenario, then the full sweep on the
    same workbook: only the missing rows score, resumed rows come first;
    a third call scores nothing."""
    jeng, teng = engines()
    for mod, eng, name in ((jsweep, jeng, "j"), (tsweep, teng, "t")):
        out = tmp_path / f"{name}.xlsx"
        _run(mod, eng, out, max_rephrasings=2)
        counted = Faulty(eng, "none", 0)
        _run(mod, counted, out)
        assert counted.calls == 1          # 5 new rows, one chunk
        again = Faulty(eng, "none", 0)
        _run(mod, again, out)
        assert again.calls == 0
    rows = assert_workbooks_equal(tmp_path / "t.xlsx", tmp_path / "j.xlsx")
    assert len(rows) == 5 * PER_SCENARIO
    assert [r["Rephrased Main Part"] for r in rows[:10]] == [
        s["rephrasings"][k] for s in scenarios() for k in range(2)]


def test_sweep_flushes_on_sigterm(tmp_path):
    """SIGTERM during the second chunk: the guard flushes the rows pending
    since the last checkpoint, ``Preempted`` ends the sweep, and the
    side-logs of both packages hold the same rows."""
    jeng, teng = engines()
    logs = []
    for mod, eng, name, exc in ((jsweep, jeng, "j", jfaults.Preempted),
                                (tsweep, teng, "t", faults.Preempted)):
        out = tmp_path / f"{name}.xlsx"
        with pytest.raises(exc):
            _run(mod, Faulty(eng, "sigterm", 2), out, checkpoint_every=100)
        with open(str(out) + ".rows.jsonl") as f:
            logs.append([json.loads(line) for line in f])
    assert len(logs[0]) == len(logs[1]) == SWEEP_KW["score_chunk"]
    for a, b in zip(logs[0], logs[1]):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], float):
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL)
            else:
                assert a[k] == b[k]
    assert ttel.fault_events("preempted")


def test_sweep_records_nan_logits(tmp_path):
    """NaN position-0 probabilities on the second chunk: the rows are
    written with empty probability cells and a ``nan_logits`` fault event
    records them, in both packages."""
    jeng, teng = engines()
    counts = []
    for mod, eng, name, tel in ((jsweep, jeng, "j", jtel),
                                (tsweep, teng, "t", ttel)):
        before = len(tel.fault_events("nan_logits"))
        _run(mod, Faulty(eng, "nan", 2), tmp_path / f"{name}.xlsx")
        events = tel.fault_events("nan_logits")[before:]
        counts.append([(e["rows"], e["chunk_start"], e["model"])
                       for e in events])
    assert counts[0] == counts[1] == [(SWEEP_KW["score_chunk"],
                                       SWEEP_KW["score_chunk"], MODEL)]
    rows = assert_workbooks_equal(tmp_path / "t.xlsx", tmp_path / "j.xlsx")
    assert sum(r["Token_1_Prob"] is None for r in rows) == SWEEP_KW["score_chunk"]


@pytest.mark.parametrize("top_filter", [0, 20])
def test_first_token_relative_prob_matches_reference(top_filter):
    """Per-prompt targets, string and pre-tokenized prompts."""
    jeng, teng = engines(batch_size=4)
    prompts = [r for s in scenarios() for r in s["rephrasings"]]
    targets = [tuple(s["target_tokens"]) for s in scenarios()
               for _ in s["rephrasings"]]
    targets[0] = ("Covered", "Not")
    prompts[1] = tok()(prompts[1])["input_ids"]
    got = teng.first_token_relative_prob(prompts, targets, top_filter)
    ref = jeng.first_token_relative_prob(prompts, targets, top_filter)
    assert got.shape == (len(prompts), 3)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if top_filter == 0:
        assert (got[:, :2] > 0).all()
