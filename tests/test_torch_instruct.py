"""The port's instruct-model sweep and word-meaning sweep against the JAX
package's: the roster assets, the two comparison CSVs' writers,
``run_instruct_sweep`` (the prompt fingerprint's fresh start, resume,
``MODEL_ERROR`` rows, the transient retry, the checkpoint under SIGTERM),
``run_base_vs_instruct_word_meaning``, both sweeps over port engines
against JAX engines (a T5 and the new decoder families), and
``run-instruct-sweep --device cpu`` over tiny snapshots of the four new
formats (T5 with a Unigram ``tokenizer.json``, Qwen with ``qwen.tiktoken``,
OPT with ``vocab.json`` + ``merges.txt``, Baichuan with a byte-level BPE
``tokenizer.json``).

Classes: assets and checkpoints byte-identical; the CSV bytes the JAX
frames' ``to_csv`` writes whenever the rows are the same (a deterministic
fake engine, or the JAX engines themselves); log lines identical but for
the heartbeat's measured rate and ETA.  Port engines against JAX engines:
text cells identical, numbers within rtol 2e-5.
"""

import csv
import dataclasses
import functools
import json
import math
import os
import re

import numpy as np
import pytest

from llm_interpretation_replication_tpu import config as jconfig_assets
from llm_interpretation_replication_tpu.runtime import faults as jfaults
from llm_interpretation_replication_tpu.sweeps import instruct_sweep as jsweep
from llm_interpretation_replication_tpu.sweeps import writers as jwriters
from llm_interpretation_replication_tpu_torch import __main__ as tcli
from llm_interpretation_replication_tpu_torch import config as tconfig_assets
from llm_interpretation_replication_tpu_torch.runtime import faults
from llm_interpretation_replication_tpu_torch.sweeps import instruct_sweep as tsweep
from llm_interpretation_replication_tpu_torch.sweeps import writers
import chip_smoke
import test_torch_families as fam
import test_torch_t5 as t5t
from test_torch_100q import QUESTIONS, FakeEngine, _read_csv
from test_torch_slots import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["fake/alpha-7b-instruct", "fake/beta-chat", "fake/gamma-it"]
PAIRS = [{"base": "fake/alpha-7b", "instruct": "fake/alpha-7b-instruct"},
         {"base": "fake/beta-7b", "instruct": "fake/beta-chat"}]
PAIR_NAMES = [m for p in PAIRS for m in (p["base"], p["instruct"])]


# -- host copies ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["instruct_sweep_models.json",
                                  "model_pairs_word_meaning.json"])
def test_roster_assets_are_byte_identical(name):
    with open(os.path.join(ROOT, "llm_interpretation_replication_tpu",
                           "data_assets", name), "rb") as f:
        ref = f.read()
    with open(os.path.join(ROOT, "llm_interpretation_replication_tpu_torch",
                           "data_assets", name), "rb") as f:
        assert f.read() == ref
    assert tconfig_assets.instruct_sweep_models() == \
        jconfig_assets.instruct_sweep_models()
    assert tconfig_assets.model_pairs_word_meaning() == \
        jconfig_assets.model_pairs_word_meaning()
    assert len(tconfig_assets.instruct_sweep_models()) == 10


def _outputs():
    """outputs[model][prompt] -> row, with error rows (NaN), a row missing
    fields (the frames' defaults), newlines, quotes and commas."""
    rng = np.random.default_rng(2)
    out = {}
    for mi, m in enumerate(PAIR_NAMES + MODELS):
        rows = {}
        for qi, q in enumerate(QUESTIONS):
            if (mi + qi) % 5 == 3:
                rows[q] = {"yes_prob": float("nan"), "no_prob": float("nan"),
                           "relative_prob": float("nan"),
                           "odds_ratio": float("nan"),
                           "completion": "MODEL_ERROR: out of memory, \"x\"",
                           "success": False}
            elif (mi + qi) % 7 == 1:
                rows[q] = {"yes_prob": 0.25}
            else:
                a, b = (float(v) for v in rng.random(2) * 10.0 ** rng.integers(-9, 1))
                rows[q] = {"yes_prob": a, "no_prob": b,
                           "relative_prob": a / (a + b), "odds_ratio": a / b,
                           "completion": [" Yes", " No,\nbecause", ""][qi % 3],
                           "success": True}
        out[m] = rows
    return out


def test_comparison_frames_write_pandas_bytes(tmp_path):
    outputs = _outputs()
    pairs = [(p["base"], p["instruct"]) for p in PAIRS]
    for name, rows, cols, ref in (
            ("inst", writers.instruct_comparison_frame(outputs, MODELS),
             writers.INSTRUCT_COMPARISON_COLUMNS,
             jwriters.instruct_comparison_frame(outputs, MODELS)),
            ("pairs", writers.model_comparison_frame(outputs, pairs),
             writers.MODEL_COMPARISON_COLUMNS,
             jwriters.model_comparison_frame(outputs, pairs))):
        assert cols == list(ref.columns)
        writers.write_csv(cols, rows, str(tmp_path / f"{name}.csv"))
        ref.to_csv(str(tmp_path / f"{name}_ref.csv"), index=False)
        assert (tmp_path / f"{name}.csv").read_bytes() == \
            (tmp_path / f"{name}_ref.csv").read_bytes()
    writers.write_csv(writers.INSTRUCT_COMPARISON_COLUMNS, [],
                      str(tmp_path / "empty.csv"))
    jwriters.instruct_comparison_frame({}, MODELS).to_csv(
        str(tmp_path / "empty_ref.csv"), index=False)
    assert (tmp_path / "empty.csv").read_bytes() == \
        (tmp_path / "empty_ref.csv").read_bytes()


# -- the sweep shells on a deterministic engine ---------------------------------

_HEARTBEAT = re.compile(r"\| [0-9.]+ rows/s \| ETA [0-9]+s")


def _quick_policies(monkeypatch):
    for fmod in (faults, jfaults):
        quick = dataclasses.replace(fmod.default_transient_policy(),
                                    max_retries=2, initial_delay=0.0,
                                    max_delay=0.0)
        monkeypatch.setattr(fmod, "default_transient_policy", lambda q=quick: q)


def _run_both(tmp_path, make, monkeypatch, capsys, which="instruct",
              prompts=QUESTIONS, roster=None):
    """Each package's sweep (``which``: "instruct" or "pairs") over engines
    from ``make(name, package)``; returns {package: (rows, CSV bytes,
    checkpoint bytes, log)} after holding the logs to each other (the
    heartbeat's rate and ETA aside)."""
    _quick_policies(monkeypatch)
    out = {}
    for pkg, mod in (("t", tsweep), ("j", jsweep)):
        csv_path, ck = str(tmp_path / f"{pkg}.csv"), str(tmp_path / f"{pkg}.json")
        if which == "instruct":
            res = mod.run_instruct_sweep(
                lambda name: make(name, pkg), prompts,
                models=roster or MODELS, checkpoint_path=ck,
                results_csv=csv_path)
        else:
            res = mod.run_base_vs_instruct_word_meaning(
                lambda name: make(name, pkg), prompts,
                model_pairs=roster or PAIRS, checkpoint_path=ck,
                results_csv=csv_path)
        with open(csv_path, "rb") as f, open(ck, "rb") as g:
            out[pkg] = (res, f.read(), g.read(), capsys.readouterr().out)
    tlog = _HEARTBEAT.sub("|", out["t"][3])
    jlog = _HEARTBEAT.sub("|", out["j"][3]).replace(str(tmp_path / "j."),
                                                   str(tmp_path / "t."))
    assert tlog == jlog
    return out


def test_run_instruct_sweep_matches_reference(tmp_path, monkeypatch, capsys):
    """Same CSV bytes, checkpoint and log; a failing model's rows are
    ``MODEL_ERROR`` rows; a transient error retries first."""
    def make(name, pkg):
        kind = faults.TransientError if pkg == "t" else jfaults.TransientError
        return FakeEngine(name, fail=name == MODELS[1],
                          transient=1 if name == MODELS[2] else 0,
                          transient_type=kind)

    out = _run_both(tmp_path, make, monkeypatch, capsys)
    rows, tcsv, tck, log = out["t"]
    assert tcsv == out["j"][1] and tck == out["j"][2]
    assert len(rows) == len(MODELS) * len(QUESTIONS)
    assert all(list(r) == writers.INSTRUCT_COMPARISON_COLUMNS for r in rows)
    bad = [r for r in rows if r["model"] == MODELS[1]]
    assert all(math.isnan(r["yes_prob"])
               and r["model_output"].startswith("MODEL_ERROR: simulated")
               for r in bad)
    assert all(not math.isnan(r["yes_prob"]) for r in rows
               if r["model"] == MODELS[2])
    assert log.count("[heartbeat] instruct_sweep: ") == len(MODELS)
    assert "[heartbeat] instruct_sweep: 3/3 models |" in log


def test_word_meaning_sweep_matches_reference(tmp_path, monkeypatch, capsys):
    """Base models get the few-shot prompt, instruct models the bare one
    (the fake engine's rows hash the prompt text)."""
    out = _run_both(tmp_path, lambda name, pkg: FakeEngine(
        name, fail=name == PAIR_NAMES[2]), monkeypatch, capsys, which="pairs")
    rows, tcsv, tck, log = out["t"]
    assert tcsv == out["j"][1] and tck == out["j"][2]
    assert [r["base_or_instruct"] for r in rows[::len(QUESTIONS)]] == \
        ["base", "instruct"] * 2
    assert "Running base model: fake/alpha-7b" in log
    assert all(r["model_output"].startswith("MODEL_ERROR") for r in rows
               if r["model"] == PAIR_NAMES[2])


def test_fingerprint_restarts_for_another_question_set(tmp_path, capsys):
    ck, out = str(tmp_path / "ck.json"), str(tmp_path / "out.csv")
    tsweep.run_instruct_sweep(FakeEngine, QUESTIONS[:3], models=MODELS,
                              checkpoint_path=ck, results_csv=out)
    calls = []
    rows = tsweep.run_instruct_sweep(
        lambda n: calls.append(n) or FakeEngine(n), QUESTIONS, models=MODELS,
        checkpoint_path=ck, results_csv=out)
    assert calls == MODELS and len(rows) == len(MODELS) * len(QUESTIONS)
    assert "belongs to a different prompt set" in capsys.readouterr().out
    with open(ck) as f:
        assert json.load(f)["prompts"] == tsweep._prompts_fingerprint(QUESTIONS)


def test_resume_skips_checkpointed_models(tmp_path, capsys):
    ck, out = str(tmp_path / "ck.json"), str(tmp_path / "out.csv")
    tsweep.run_instruct_sweep(FakeEngine, QUESTIONS, models=MODELS[:1],
                              checkpoint_path=ck, results_csv=out)
    calls = []
    tsweep.run_instruct_sweep(lambda n: calls.append(n) or FakeEngine(n),
                              QUESTIONS, models=MODELS, checkpoint_path=ck,
                              results_csv=out)
    assert calls == MODELS[1:]
    assert f"Skipping {MODELS[0]} (checkpointed)" in capsys.readouterr().out
    tsweep.run_instruct_sweep(lambda n: pytest.fail(f"{n} scored again"),
                              QUESTIONS, models=MODELS, checkpoint_path=ck,
                              results_csv=str(tmp_path / "again.csv"))
    assert (tmp_path / "again.csv").read_bytes() == (tmp_path / "out.csv").read_bytes()


@pytest.mark.parametrize("which", ["instruct", "pairs"])
def test_sigterm_keeps_completed_models_only(tmp_path, which):
    """A SIGTERM while the third model scores: the flush keeps exactly the
    first two models' rows, and the resumed sweep writes the
    uninterrupted sweep's CSV."""
    names = MODELS if which == "instruct" else PAIR_NAMES

    def run(factory, tag):
        kw = dict(checkpoint_path=str(tmp_path / f"{tag}.json"),
                  results_csv=str(tmp_path / f"{tag}.csv"))
        if which == "instruct":
            return tsweep.run_instruct_sweep(factory, QUESTIONS, models=MODELS,
                                             **kw)
        return tsweep.run_base_vs_instruct_word_meaning(
            factory, QUESTIONS, model_pairs=PAIRS, **kw)

    with pytest.raises(faults.Preempted):
        run(lambda n: FakeEngine(n, preempt=n == names[2]), "cut")
    with open(tmp_path / "cut.json") as f:
        assert list(json.load(f)["outputs"]) == names[:2]
    calls = []
    run(lambda n: calls.append(n) or FakeEngine(n), "cut")
    assert calls == names[2:]
    run(FakeEngine, "whole")
    assert (tmp_path / "cut.csv").read_bytes() == (tmp_path / "whole.csv").read_bytes()


# -- both sweeps over real engines, JAX against the port ------------------------

ENGINE_CASES = {"tiny/t5-instruct": ("t5", "gated_untied"),
                "tiny/opt-iml": ("decoder", "opt")}


@functools.lru_cache(maxsize=None)
def _engine_pair(name):
    """(JAX engine, port engine) of a roster name; a ``-base`` name gets
    its instruct model's weights."""
    kind, case = ENGINE_CASES[name.replace("-base", "-instruct")]
    return (t5t.engines(case, batch_size=4) if kind == "t5"
            else fam.engines(case, batch_size=4))


def _engine(name, pkg):
    return _engine_pair(name)[0 if pkg == "j" else 1]


def _assert_csv_close(got, ref, columns):
    got, ref = _read_csv(got), _read_csv(ref)
    assert got[0] == ref[0] == columns and len(got) == len(ref)
    numeric = {"yes_prob", "no_prob", "relative_prob", "odds_ratio"}
    for g, r in zip(got[1:], ref[1:]):
        for c, a, b in zip(columns, g, r):
            if c in numeric:
                np.testing.assert_allclose(float(a), float(b), rtol=2e-5,
                                           atol=1e-12, err_msg=c)
            else:
                assert a == b, c


def test_sweeps_over_port_engines_match_jax_engines(tmp_path):
    """``run_instruct_sweep`` over a T5 and OPT roster and the
    word-meaning sweep over a T5 pair (the base model's few-shot prompt on
    T5): the port's sweep over JAX engines writes the JAX sweep's bytes;
    over port engines, the same text and numbers within rtol 2e-5."""
    questions = fam.QUESTIONS[:3]
    roster = list(ENGINE_CASES)
    t5_pair = [{"base": "tiny/t5-base", "instruct": "tiny/t5-instruct"}]
    for which, kw, columns in (
            ("instruct", dict(models=roster), writers.INSTRUCT_COMPARISON_COLUMNS),
            ("pairs", dict(model_pairs=t5_pair), writers.MODEL_COMPARISON_COLUMNS)):
        out = {}
        for tag, mod, pkg in (("jj", jsweep, "j"), ("tj", tsweep, "j"),
                              ("tt", tsweep, "t")):
            path = str(tmp_path / f"{which}{tag}.csv")
            fn = (mod.run_instruct_sweep if which == "instruct"
                  else mod.run_base_vs_instruct_word_meaning)
            fn(lambda n: _engine(n, pkg), questions,
               checkpoint_path=str(tmp_path / f"{which}{tag}.json"),
               results_csv=path, **kw)
            with open(path, "rb") as f:
                out[tag] = f.read()
        assert out["tj"] == out["jj"]
        _assert_csv_close(out["tt"], out["jj"], columns)


# -- run-instruct-sweep on snapshots ------------------------------------------

CLI_ROSTER = ["tiny-org/t5-it", "tiny-org/qwen-chat", "tiny-org/opt-iml",
              "tiny-org/baichuan-chat"]


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """``org--name`` snapshots of the four new formats, tokenizers learned
    on the questions' instruct prompts."""
    import transformers

    from llm_interpretation_replication_tpu_torch.scoring import prompts

    root = tmp_path_factory.mktemp("instruct_snaps")
    texts = [prompts.format_prompt(q, False) for q in QUESTIONS] + ["Yes", "No",
                                                                    " Yes", " No"]

    def write(snap, name, obj):
        with open(os.path.join(snap, name), "w", encoding="utf-8") as f:
            json.dump(obj, f)

    # T5: a transformers model and a Unigram tokenizer.json
    snap = str(root / "tiny-org--t5-it")
    t5t.hf_model("gated_untied").save_pretrained(snap, safe_serialization=True)
    for name, obj in zip(("tokenizer.json", "tokenizer_config.json",
                          "special_tokens_map.json"),
                         chip_smoke._unigram_tokenizer_files(texts)):
        write(snap, name, obj)
    # Qwen and Baichuan: remote-code names written as safetensors
    for name, case, vocab in (("qwen-chat", "qwen", 151936),
                              ("baichuan-chat", "baichuan_7b", 1100)):
        snap = str(root / f"tiny-org--{name}")
        os.makedirs(snap)
        kw = dict(fam.NEW_CASES[case][1], vocab_size=vocab)
        write(snap, "config.json", kw)
        chip_smoke._write_safetensors(
            os.path.join(snap, "model.safetensors"),
            fam._remote_code_state_dict(case, kw))
        if case == "qwen":
            with open(os.path.join(snap, "qwen.tiktoken"), "wb") as f:
                f.write(chip_smoke._qwen_tiktoken(texts))
        else:
            for fname, obj in zip(("tokenizer.json", "tokenizer_config.json",
                                   "special_tokens_map.json"),
                                  chip_smoke._bpe_tokenizer_files(texts)):
                write(snap, fname, obj)
    # OPT: a transformers model, vocab.json + merges.txt
    snap = str(root / "tiny-org--opt-iml")
    transformers.OPTForCausalLM(transformers.OPTConfig(
        **dict(fam.NEW_CASES["opt"][1], vocab_size=1100))).save_pretrained(
            snap, safe_serialization=True)
    chip_smoke._write_gpt2_tokenizer(snap, texts)
    return str(root)


def _argv(snapshots, out, *extra):
    return ["run-instruct-sweep", "--device", "cpu", "--dtype", "float32",
            "--checkpoint-dir", snapshots, "--batch-size", "4",
            "--output-dir", str(out), *extra]


def test_run_instruct_sweep_cli_matches_in_process_sweep(
        snapshots, tmp_path, capsys, monkeypatch):
    """``--attention-impl flash --quant int8`` roster-wide: the T5 model
    runs dense on float weights (a warning says so), the decoders on the
    causal kernel's plain version with w8a8 weights; every row scored; the
    CSV equals an in-process sweep through the CLI's engine factory."""
    monkeypatch.setattr(tsweep, "instruct_sweep_models", lambda: CLI_ROSTER)
    monkeypatch.setattr(tconfig_assets, "ordinary_meaning_questions",
                        lambda: list(QUESTIONS))
    argv = _argv(snapshots, tmp_path / "cli", "--attention-impl", "flash",
                 "--quant", "int8")
    with pytest.warns(UserWarning, match="int8 quantization unsupported"):
        tcli.main(argv)
    captured = capsys.readouterr()
    n = len(CLI_ROSTER) * len(QUESTIONS)
    assert f"{n} rows over {len(QUESTIONS)} questions" in captured.out
    lines = dict(re.findall(r"^# (\S+): attention (\w+) ", captured.err, re.M))
    assert lines == {m: "xla" if "t5" in m else "flash" for m in CLI_ROSTER}
    path = tmp_path / "cli" / "instruct_model_comparison_results.csv"
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == n
    assert not any(r["model_output"].startswith("MODEL_ERROR") for r in rows)
    assert all(0.0 <= float(r["relative_prob"]) <= 1.0 for r in rows)
    assert os.path.exists(tmp_path / "cli" / "instruct_sweep_checkpoint.json")
    rc = tcli._run_config(_parse(argv))
    tsweep.run_instruct_sweep(
        tcli._engine_factory(rc), list(QUESTIONS),
        checkpoint_path=str(tmp_path / "in" / "ck.json"),
        results_csv=str(tmp_path / "in" / "out.csv"))
    assert path.read_bytes() == (tmp_path / "in" / "out.csv").read_bytes()


def test_questions_file_and_results_csv(snapshots, tmp_path, capsys,
                                        monkeypatch):
    """``--questions-file`` needs ``--results-csv``; the checkpoint is
    named after the CSV's stem, beside the other outputs."""
    monkeypatch.setattr(tsweep, "instruct_sweep_models", lambda: CLI_ROSTER[:1])
    qfile = tmp_path / "q.txt"
    qfile.write_text("\n".join(QUESTIONS[:2]) + "\n\n")
    with pytest.raises(SystemExit, match="requires --results-csv"):
        tcli.main(_argv(snapshots, tmp_path / "o", "--questions-file", str(qfile)))
    out_csv = tmp_path / "elsewhere" / "survey2_results.csv"
    tcli.main(_argv(snapshots, tmp_path / "o", "--questions-file", str(qfile),
                    "--results-csv", str(out_csv)))
    assert "2 rows over 2 questions" in capsys.readouterr().out
    assert out_csv.exists()
    assert (tmp_path / "o" / "survey2_results_checkpoint.json").exists()


def _parse(argv):
    import argparse

    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command")
    p = sub.add_parser("run-instruct-sweep")
    tcli._add_run_config_args(p)
    p.add_argument("--questions-file")
    p.add_argument("--results-csv")
    return parser.parse_args(argv)
