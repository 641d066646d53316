"""The port's 100-question base-vs-instruct sweep against the JAX package's:
its host copies (``scoring/prompts``, the data assets, ``CheckpointFile``,
the CSV writer), ``sweeps.run_sweep`` (resume, the checkpoint invariant
under SIGTERM, the transient retry, error rows), the sweep over port
engines against the sweep over JAX engines on the same weights, and
``run-100q --device cpu`` over tiny snapshots.

Classes: prompts, assets and checkpoints byte-identical; the CSV writer
writes pandas' bytes; the port's ``run_sweep`` writes the JAX
``run_sweep``'s bytes whenever the engines' rows are the same (a
deterministic fake engine, or the JAX engines themselves).  Port engines
against JAX engines: the CSVs' text cells identical and their numbers
within rtol 2e-5 (float32 results of the two frameworks differ in their
last bits, so their full-precision CSV bytes cannot be equal).
"""

import csv
import dataclasses
import hashlib
import json
import math
import os
import signal

import numpy as np
import pandas as pd
import pytest
import torch

from llm_interpretation_replication_tpu import config as jconfig_assets
from llm_interpretation_replication_tpu.runtime import faults as jfaults
from llm_interpretation_replication_tpu.runtime import loader as jloader
from llm_interpretation_replication_tpu.scoring import prompts as jprompts
from llm_interpretation_replication_tpu.sweeps import base_vs_instruct_100q as jsweep
from llm_interpretation_replication_tpu.sweeps import writers as jwriters
from llm_interpretation_replication_tpu.utils import checkpoint as jcheckpoint
from llm_interpretation_replication_tpu_torch import __main__ as tcli
from llm_interpretation_replication_tpu_torch import config as tconfig_assets
from llm_interpretation_replication_tpu_torch.models import convert
from llm_interpretation_replication_tpu_torch.runtime import faults
from llm_interpretation_replication_tpu_torch.runtime import loader
from llm_interpretation_replication_tpu_torch.scoring import prompts as tprompts
from llm_interpretation_replication_tpu_torch.sweeps import base_vs_instruct_100q as tsweep
from llm_interpretation_replication_tpu_torch.sweeps import writers
from llm_interpretation_replication_tpu_torch.utils import checkpoint
import chip_smoke
import test_torch_families as fam
from test_torch_slots import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = writers.BASE_VS_INSTRUCT_100Q_COLUMNS
PAIRS = [
    {"base": "fake/alpha-7b", "instruct": "fake/alpha-7b-instruct", "family": "Alpha"},
    {"base": "fake/beta-7b", "instruct": "fake/beta-7b-chat", "family": "Beta"},
]
NAMES = [m for p in PAIRS for m in (p["base"], p["instruct"])]
QUESTIONS = ['Is a "tweet" a "publication"?', "Is soup, served cold, a beverage?",
             'Is "a\nb" a line?', "Is café a word?", "Is 1/3 > 0.3?"]


# -- host copies ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["model_pairs_100q.json",
                                  "ordinary_meaning_questions.json"])
def test_data_assets_are_byte_identical(name):
    with open(os.path.join(ROOT, "llm_interpretation_replication_tpu",
                           "data_assets", name), "rb") as f:
        ref = f.read()
    with open(os.path.join(ROOT, "llm_interpretation_replication_tpu_torch",
                           "data_assets", name), "rb") as f:
        assert f.read() == ref
    assert tconfig_assets.model_pairs_100q() == jconfig_assets.model_pairs_100q()
    assert tconfig_assets.ordinary_meaning_questions() == \
        jconfig_assets.ordinary_meaning_questions()
    assert len(tconfig_assets.ordinary_meaning_questions()) == 100


@pytest.mark.parametrize("model", ["tiiuae/falcon-7b", "bigscience/bloomz-7b1",
                                   "baichuan-inc/Baichuan2-7B-Chat"])
def test_prompts_are_byte_identical(model):
    assert tprompts.FEW_SHOT_PREFIX == jprompts.FEW_SHOT_PREFIX
    assert tprompts.ANSWER_INSTRUCTION == jprompts.ANSWER_INSTRUCTION
    for q in tconfig_assets.ordinary_meaning_questions() + QUESTIONS:
        assert tprompts.format_base_prompt(q) == jprompts.format_base_prompt(q)
        assert tprompts.format_instruct_prompt(q, model) == \
            jprompts.format_instruct_prompt(q, model)
        for base in (True, False):
            got = tprompts.format_prompt(q, base, model)
            assert got == jprompts.format_prompt(q, base, model)
            parts = tprompts.format_prompt_parts(q, base, model)
            assert parts == jprompts.format_prompt_parts(q, base, model)
            assert "".join(parts) == got


def test_checkpoint_file_matches_reference(tmp_path):
    state = {"completed_models": ["b", "a"], "results": [
        {"model": "a", "yes_prob": float("nan"), "completion": "x\n\"y\""}]}
    for mod, name in ((checkpoint, "t.json"), (jcheckpoint, "j.json")):
        ck = mod.CheckpointFile(str(tmp_path / "sub" / name),
                                default={"completed_models": [], "results": []})
        assert ck.load() == {"completed_models": [], "results": []}
        ck.load()["results"].append(1)          # the default is not shared
        assert ck.load()["results"] == []
        ck.save(state)
        assert ck.load()["completed_models"] == ["b", "a"]
    assert (tmp_path / "sub" / "t.json").read_bytes() == \
        (tmp_path / "sub" / "j.json").read_bytes()
    assert not [p for p in os.listdir(tmp_path / "sub") if p.endswith(".tmp")]


def _csv_rows():
    """Rows with every kind of cell the 100q CSV meets: error rows (NaN
    probabilities), newlines, commas, quotes, empty completions, non-ASCII
    text, and floats across their range."""
    rng = np.random.default_rng(4)
    vals = [float(v) for v in rng.standard_normal(40)
            * 10.0 ** rng.integers(-30, 12, 40)]
    vals += [0.0, 1.0, 0.5, 1e-5, 1e-4, 1e16, 1e15, 123456.789, 5e-324,
             float("inf")]
    rows = []
    for i, v in enumerate(vals):
        err = i % 7 == 3
        rows.append({
            "yes_prob": float("nan") if err else abs(v),
            "no_prob": float("nan") if err else abs(v) / 3,
            "relative_prob": float("nan") if err else 1 / (1 + abs(v) + 1e-9),
            "completion": ("MODEL_ERROR: CUDA out of memory, \"tried\"" if err
                           else ["", " Yes.", " No,\nbecause", "\"quoted\"",
                                 " naïve — ok"][i % 5]),
            "success": not err,
            "prompt": QUESTIONS[i % len(QUESTIONS)],
            "model": NAMES[i % 4],
            "formatted_prompt": jprompts.format_prompt(
                QUESTIONS[i % len(QUESTIONS)], i % 2 == 0)[:200],
            "model_family": "Alpha" if i % 4 < 2 else "Beta",
            "base_or_instruct": "base" if i % 2 == 0 else "instruct",
        })
    return rows


def test_csv_writer_matches_pandas(tmp_path):
    rows = _csv_rows()
    writers.write_csv(COLUMNS, rows, str(tmp_path / "t.csv"))
    jwriters.base_vs_instruct_100q_frame(rows).to_csv(
        str(tmp_path / "j.csv"), index=False)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    # columns pandas types otherwise: ints, ints beside an empty cell, and
    # bools beside one
    mixed = [{"a": 1, "b": 2, "c": True, "d": "x"},
             {"a": 3, "b": None, "c": None, "d": 2.5}]
    writers.write_csv(list("abcd"), mixed, str(tmp_path / "m.csv"))
    pd.DataFrame(mixed)[list("abcd")].to_csv(str(tmp_path / "n.csv"),
                                             index=False)
    assert (tmp_path / "m.csv").read_bytes() == (tmp_path / "n.csv").read_bytes()


# -- the sweep shell on a deterministic engine -------------------------------------

class FakeEngine:
    """Rows from a hash of (model, prompt text); a ``(prefix, suffix)`` pair
    scores as its joined text.  ``fail`` raises a non-transient error;
    ``transient`` raises that many transient errors first; ``preempt``
    sends this process a SIGTERM from its first call."""

    def __init__(self, name, fail=False, transient=0, preempt=False,
                 transient_type=faults.TransientError):
        self.name, self.fail, self.preempt = name, fail, preempt
        self.transient, self.transient_type = transient, transient_type

    def score_prefixed(self, *a, **k):       # marks the fused route
        raise AssertionError("the sweep calls score_prompts with pairs")

    def score_prompts(self, prompts, targets=("Yes", "No")):
        if self.preempt:
            os.kill(os.getpid(), signal.SIGTERM)
        if self.fail:
            raise RuntimeError("simulated device failure")
        if self.transient:
            self.transient -= 1
            raise self.transient_type("simulated connection reset")
        rows = []
        for p in prompts:
            text = "".join(p) if isinstance(p, tuple) else p
            h = hashlib.sha256(f"{self.name}|{text}".encode()).digest()
            a, b = h[0] / 255.0, h[1] / 7.0
            rows.append({"yes_prob": a, "no_prob": b,
                         "relative_prob": a / (a + b) if a + b else 0.5,
                         "completion": " Yes" if a > b else " No,\n\"n\"",
                         "success": True})
        return rows


def _run_both(tmp_path, make, monkeypatch, capsys, pairs=PAIRS):
    """The port's and the JAX ``run_sweep`` over engines from ``make(name,
    package)``, each package's transient policy cut to 2 retries without
    delay; returns (port rows, port CSV bytes, JAX CSV bytes), and holds
    the port's log to the reference's."""
    out = {}
    for pkg, mod, fmod in (("t", tsweep, faults), ("j", jsweep, jfaults)):
        quick = dataclasses.replace(fmod.default_transient_policy(),
                                    max_retries=2, initial_delay=0.0,
                                    max_delay=0.0)
        monkeypatch.setattr(fmod, "default_transient_policy", lambda q=quick: q)
        csv_path = str(tmp_path / f"{pkg}.csv")
        res = mod.run_sweep(
            lambda name: make(name, pkg), model_pairs=pairs,
            prompts=QUESTIONS, checkpoint_path=str(tmp_path / f"{pkg}.json"),
            results_csv=csv_path)
        with open(csv_path, "rb") as f:
            out[pkg] = (res, f.read(), capsys.readouterr().out)
    assert out["t"][2] == out["j"][2].replace(str(tmp_path / "j."),
                                              str(tmp_path / "t."))
    return out["t"][0], out["t"][1], out["j"][1]


def test_run_sweep_matches_reference(tmp_path, monkeypatch, capsys):
    made = []

    def make(name, pkg):
        made.append((pkg, name))
        return FakeEngine(name, fail=name == NAMES[1])

    rows, tcsv, jcsv = _run_both(tmp_path, make, monkeypatch, capsys)
    assert tcsv == jcsv
    assert len(rows) == len(NAMES) * len(QUESTIONS)
    assert all(list(r) == COLUMNS for r in rows)
    bad = [r for r in rows if r["model"] == NAMES[1]]
    assert all(not r["success"] and math.isnan(r["yes_prob"])
               and r["completion"].startswith("MODEL_ERROR: simulated")
               for r in bad)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert [n for p, n in made if p == "t"] == NAMES


def test_transient_errors_retry_before_error_rows(tmp_path, monkeypatch,
                                                  capsys):
    def make(name, pkg):
        kind = faults.TransientError if pkg == "t" else jfaults.TransientError
        return FakeEngine(name, transient=1 if name == NAMES[0] else
                          5 if name == NAMES[2] else 0, transient_type=kind)

    rows, tcsv, jcsv = _run_both(tmp_path, make, monkeypatch, capsys)
    assert tcsv == jcsv
    by = {n: [r for r in rows if r["model"] == n] for n in NAMES}
    assert all(r["success"] for r in by[NAMES[0]])       # retried, then fine
    assert not any(r["success"] for r in by[NAMES[2]])   # budget spent


def test_resume_skips_completed(tmp_path):
    calls = []

    def factory(name):
        calls.append(name)
        return FakeEngine(name)

    ck, out = str(tmp_path / "ck.json"), str(tmp_path / "out.csv")
    tsweep.run_sweep(factory, model_pairs=PAIRS[:1], prompts=QUESTIONS,
                     checkpoint_path=ck, results_csv=out)
    rows = tsweep.run_sweep(factory, model_pairs=PAIRS, prompts=QUESTIONS,
                            checkpoint_path=ck, results_csv=out)
    assert calls == NAMES
    assert len(rows) == len(NAMES) * len(QUESTIONS)
    tsweep.run_sweep(lambda n: pytest.fail(f"{n} scored again"),
                     model_pairs=PAIRS, prompts=QUESTIONS, checkpoint_path=ck,
                     results_csv=str(tmp_path / "again.csv"))
    assert (tmp_path / "again.csv").read_bytes() == (tmp_path / "out.csv").read_bytes()


def test_sigterm_mid_sweep_keeps_the_checkpoint_invariant(tmp_path):
    """A SIGTERM while the third model scores: the guard's flush keeps rows
    exactly for the completed models, and the resumed sweep writes the
    uninterrupted sweep's CSV, each row once."""
    ck, out = str(tmp_path / "ck.json"), str(tmp_path / "out.csv")
    with pytest.raises(faults.Preempted):
        tsweep.run_sweep(lambda n: FakeEngine(n, preempt=n == NAMES[2]),
                         model_pairs=PAIRS, prompts=QUESTIONS,
                         checkpoint_path=ck, results_csv=out)
    with open(ck) as f:
        state = json.load(f)
    assert state["completed_models"] == sorted(NAMES[:2])
    assert {r["model"] for r in state["results"]} == set(NAMES[:2])
    assert len(state["results"]) == 2 * len(QUESTIONS)
    assert signal.getsignal(signal.SIGTERM) is not None
    calls = []
    rows = tsweep.run_sweep(lambda n: calls.append(n) or FakeEngine(n),
                            model_pairs=PAIRS, prompts=QUESTIONS,
                            checkpoint_path=ck, results_csv=out)
    assert calls == NAMES[2:]
    assert len({(r["model"], r["prompt"]) for r in rows}) == len(rows) == \
        len(NAMES) * len(QUESTIONS)
    tsweep.run_sweep(FakeEngine, model_pairs=PAIRS, prompts=QUESTIONS,
                     checkpoint_path=str(tmp_path / "whole.json"),
                     results_csv=str(tmp_path / "whole.csv"))
    assert (tmp_path / "whole.csv").read_bytes() == (tmp_path / "out.csv").read_bytes()


# -- the sweep over real engines, JAX against the port --------------------------

FAMILY_PAIRS = [{"base": f"tiny/{case}", "instruct": f"tiny/{case}-instruct",
                 "family": case} for case in fam.CASES]


def _read_csv(data):
    return list(csv.reader(data.decode("utf-8").splitlines(keepends=True)))


def test_run_sweep_over_port_engines_matches_jax_engines(tmp_path):
    """One pair a family case, both models on its weights, at
    ``EngineConfig()`` under the word tokenizer: the port's sweep over JAX
    engines writes the JAX sweep's bytes; over port engines, the same text
    and numbers within rtol 2e-5."""
    questions = fam.QUESTIONS[:4]
    jengines, tengines = {}, {}

    def engine(name, pkg):
        case = name.split("/")[1].replace("-instruct", "")
        if case not in jengines:
            jengines[case], tengines[case] = fam.engines(case)
        return (jengines if pkg == "j" else tengines)[case]

    out = {}
    for tag, mod, pkg in (("jj", jsweep, "j"), ("tj", tsweep, "j"),
                          ("tt", tsweep, "t")):
        path = str(tmp_path / f"{tag}.csv")
        mod.run_sweep(lambda n: engine(n, pkg), model_pairs=FAMILY_PAIRS,
                      prompts=questions,
                      checkpoint_path=str(tmp_path / f"{tag}.json"),
                      results_csv=path)
        with open(path, "rb") as f:
            out[tag] = f.read()
    assert out["tj"] == out["jj"]
    got, ref = _read_csv(out["tt"]), _read_csv(out["jj"])
    assert got[0] == ref[0] == COLUMNS
    assert len(got) == len(ref) == 1 + 2 * len(FAMILY_PAIRS) * len(questions)
    numeric = {"yes_prob", "no_prob", "relative_prob"}
    for g, r in zip(got[1:], ref[1:]):
        for c, a, b in zip(COLUMNS, g, r):
            if c in numeric:
                np.testing.assert_allclose(float(a), float(b), rtol=2e-5,
                                           atol=1e-12, err_msg=c)
            else:
                assert a == b, c
    assert {r[COLUMNS.index("success")] for r in got[1:]} == {"True"}


# -- run-100q on snapshots -----------------------------------------------------------

SNAPSHOT_PAIRS = [
    {"base": "tiny-org/neox-base", "instruct": "tiny-org/neox-instruct",
     "family": "NeoX"},
    {"base": "tiny-org/bloom-base", "instruct": "tiny-org/bloom-instruct",
     "family": "BLOOM"},
]


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """``org--name`` snapshot directories: the NeoX pair as safetensors with
    an NFC tokenizer, the BLOOM pair as sharded ``pytorch_model.bin`` with
    its index and a plain one (each instruct model a symlink to its base's
    directory); tokenizers learned on the questions' prompts."""
    import transformers

    root = tmp_path_factory.mktemp("snapshots")
    texts = [jprompts.format_prompt(q, b) for q in QUESTIONS
             for b in (True, False)] + [" Yes", " No"]
    for case, pair, kw in (
            ("neox_parallel", SNAPSHOT_PAIRS[0], dict(safe_serialization=True)),
            ("bloom", SNAPSHOT_PAIRS[1], dict(safe_serialization=False,
                                              max_shard_size="60KB"))):
        snap = root / pair["base"].replace("/", "--")
        arch, hf_kw = fam.CASES[case]
        torch.manual_seed(5)
        model = getattr(transformers, f"{arch}ForCausalLM")(
            getattr(transformers, f"{arch}Config")(vocab_size=1024, **hf_kw))
        model.save_pretrained(str(snap), **kw)
        spec, config, special = chip_smoke._bpe_tokenizer_files(
            texts, nfc=case.startswith("neox"))
        assert len(spec["model"]["vocab"]) < model.config.vocab_size
        for name, obj in (("tokenizer.json", spec),
                          ("tokenizer_config.json", config),
                          ("special_tokens_map.json", special)):
            (snap / name).write_text(json.dumps(obj))
        os.symlink(snap.name, root / pair["instruct"].replace("/", "--"))
    assert (root / "tiny-org--bloom-base" / "pytorch_model.bin.index.json").exists()
    return str(root)


def test_bin_shards_load_as_the_jax_loader_loads_them(snapshots):
    path = os.path.join(snapshots, "tiny-org--bloom-base")
    family, cfg, weights = loader.load_model(path, dtype="fp32", device="cpu")
    assert family == "bloom" and cfg.position_embedding == "alibi"
    import jax
    import jax.numpy as jnp

    _, _, params = jloader.load_model(path, dtype=jnp.float32)
    ref = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  cfg, device="cpu", dtype="fp32")
    a, b = dict(fam.tdec._flatten(weights.tree())), dict(fam.tdec._flatten(ref.tree()))
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=str(k))
    with pytest.raises(ValueError, match="flash"):
        loader.load_model(path, attention_impl="flash", device="cpu")
    assert loader.load_tokenizer(path).nfc is False
    assert loader.load_tokenizer(os.path.join(
        snapshots, "tiny-org--neox-base")).nfc is True


def test_run_100q_cli_matches_in_process_sweep(snapshots, tmp_path, capsys,
                                               monkeypatch):
    monkeypatch.setattr(tsweep, "model_pairs_100q", lambda: SNAPSHOT_PAIRS)
    monkeypatch.setattr(tsweep, "ordinary_meaning_questions",
                        lambda: list(QUESTIONS))
    argv = ["run-100q", "--device", "cpu", "--dtype", "float32",
            "--checkpoint-dir", snapshots, "--attention-impl", "flash",
            "--batch-size", "4", "--output-dir", str(tmp_path / "cli")]
    tcli.main(argv)
    captured = capsys.readouterr()
    n = 4 * len(QUESTIONS)
    assert f"{n} rows" in captured.out.splitlines()
    lines = [l for l in captured.err.splitlines() if ": attention " in l]
    assert lines == [
        "# tiny-org/neox-base: attention flash (--attention-impl flash)",
        "# tiny-org/neox-instruct: attention flash (--attention-impl flash)",
        "# tiny-org/bloom-base: attention xla (ALiBi; the causal kernel "
        "takes no bias)",
        "# tiny-org/bloom-instruct: attention xla (ALiBi; the causal kernel "
        "takes no bias)"]
    rc = tcli._run_config(_parse(argv))
    rows = tsweep.run_sweep(
        tcli._engine_factory(rc),
        checkpoint_path=str(tmp_path / "in" / "ck.json"),
        results_csv=str(tmp_path / "in" / "out.csv"))
    assert len(rows) == n and all(r["success"] for r in rows)
    with open(tmp_path / "cli" / "base_vs_instruct_100q_results.csv", "rb") as f:
        assert f.read() == (tmp_path / "in" / "out.csv").read_bytes()
    with open(tmp_path / "cli" / "base_vs_instruct_100q_checkpoint.json") as f:
        assert json.load(f)["completed_models"] == sorted(
            m for p in SNAPSHOT_PAIRS for m in (p["base"], p["instruct"]))


def _parse(argv):
    """The CLI's parsed arguments of ``argv``."""
    import argparse

    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command")
    p = sub.add_parser("run-100q")
    tcli._add_run_config_args(p)
    return parser.parse_args(argv)
