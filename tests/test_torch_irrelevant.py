"""The port's irrelevant-insertion corpus and rephrasing generation
(``gen/irrelevant.py``, ``gen/rephrase.py``, the ``config`` accessors and
their ``data_assets``) against the JAX package's.

The corpus the port's ``generate-irrelevant`` writes is byte for byte the
JAX package's: 3,400 perturbations whose JSON hashes to
``chip_smoke.IRRELEVANT_CORPUS_SHA256``, the constant the card's smoke
checks its own corpus against.
"""

import datetime
import hashlib
import json
import os

import numpy as np
import pytest

import chip_smoke
from llm_interpretation_replication_tpu import config as jconfig
from llm_interpretation_replication_tpu.__main__ import main as jmain
from llm_interpretation_replication_tpu.gen import irrelevant as jirr
from llm_interpretation_replication_tpu.gen import rephrase as jreph
from llm_interpretation_replication_tpu_torch import config as tconfig
from llm_interpretation_replication_tpu_torch.__main__ import main as tmain
from llm_interpretation_replication_tpu_torch.gen import irrelevant as tirr
from llm_interpretation_replication_tpu_torch.gen import rephrase as treph
from test_torch_slots import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FixedNow(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Both packages' ``generate-irrelevant`` outputs, JSON and readable
    dump, with the dump's clock fixed."""
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(datetime, "datetime", _FixedNow)
    try:
        for name, main in (("jax", jmain), ("torch", tmain)):
            d = tmp_path_factory.mktemp(f"corpus_{name}")
            main(["generate-irrelevant", "--output", str(d / "p.json"),
                  "--readable-output", str(d / "sub" / "p.txt")])
            out[name] = ((d / "p.json").read_bytes(),
                         (d / "sub" / "p.txt").read_bytes())
    finally:
        mp.undo()
    return out


def test_corpus_json_is_byte_equal_and_pinned(corpora):
    assert corpora["torch"][0] == corpora["jax"][0]
    assert (hashlib.sha256(corpora["torch"][0]).hexdigest()
            == chip_smoke.IRRELEVANT_CORPUS_SHA256)
    data = json.loads(corpora["torch"][0])
    counts = [len(s["perturbations_with_irrelevant"]) for s in data]
    assert counts == [400, 400, 600, 1000, 1000]
    assert sum(counts) == chip_smoke.IRRELEVANT_CORPUS_ROWS == 3400


def test_corpus_readable_dump_is_byte_equal(corpora):
    assert corpora["torch"][1] == corpora["jax"][1]
    text = corpora["torch"][1].decode()
    assert "Generated: 2026-01-02 03:04:05" in text
    assert "Total perturbations: 3400" in text


def test_generate_irrelevant_prints_as_reference(tmp_path, capsys):
    outs = []
    for main in (jmain, tmain):
        main(["generate-irrelevant", "--output", str(tmp_path / "x.json")])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == f"3400 perturbations -> {tmp_path / 'x.json'}\n"


@pytest.mark.parametrize("name", ["irrelevant_statements.txt",
                                  "irrelevant_scenarios.json",
                                  "decided_rate_calibration.json",
                                  "irrelevant_eval_models.json",
                                  "api_models.json", "legal_scenarios.json"])
def test_data_assets_are_byte_equal(name):
    with open(os.path.join(ROOT, "llm_interpretation_replication_tpu",
                           "data_assets", name), "rb") as f:
        ref = f.read()
    with open(os.path.join(ROOT, "llm_interpretation_replication_tpu_torch",
                           "data_assets", name), "rb") as f:
        assert f.read() == ref


@pytest.mark.parametrize("accessor", ["irrelevant_scenarios",
                                      "irrelevant_statements",
                                      "decided_rate_calibration",
                                      "irrelevant_eval_models"])
def test_config_accessors_match_reference(accessor):
    assert getattr(tconfig, accessor)() == getattr(jconfig, accessor)()
    if accessor == "irrelevant_statements":
        assert len(tconfig.irrelevant_statements()) == 200


def _texts(seed):
    """Texts with the splitter's edge cases: runs of spaces and newlines
    after periods, a missing final period, abbreviations, empty pieces."""
    rng = np.random.default_rng(seed)
    words = ["Alpha", "beta.", "gamma", "Dr.", "e.g.", "x", "end.", "",
             "  ", "\n", "3.5", "final"]
    out = []
    for _ in range(12):
        n = int(rng.integers(0, 14))
        seps = rng.choice([" ", "  ", "\n", " \n "], n)
        out.append("".join(f"{w}{s}" for w, s in
                           zip(rng.choice(words, n), seps)).strip())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sentence_helpers_match_reference(seed):
    for text in _texts(seed):
        assert tirr.split_sentences(text) == jirr.split_sentences(text)
        n = tirr.num_insertion_positions(text)
        assert n == jirr.num_insertion_positions(text)
        for pos in range(n + 2):
            for st in ("A fact", "A fact."):
                assert (tirr.insert_statement(text, st, pos)
                        == jirr.insert_statement(text, st, pos))
            assert (tirr.position_description(pos, n)
                    == jirr.position_description(pos, n))


@pytest.mark.parametrize("cap", [None, 1, 7, 200])
def test_generate_perturbations_matches_reference(cap):
    scen = tconfig.irrelevant_scenarios()[:3] + [
        {"main": "One. Two.", "name": "alt", "response_format": "R",
         "target_tokens": ["A", "B"], "confidence_format": "C"},
        {"original_main": "No period here", "response_format": "R",
         "target_tokens": ["A", "B"], "confidence_format": "C"}]
    stmts = tconfig.irrelevant_statements()[:9]
    got = tirr.generate_perturbations(scen, stmts, max_per_scenario=cap)
    assert got == jirr.generate_perturbations(scen, stmts, max_per_scenario=cap)
    assert tirr.readable_dump(got, "t") == jirr.readable_dump(got, "t")


def test_perturbation_files_roundtrip_as_reference(tmp_path):
    data = tirr.generate_perturbations(tconfig.irrelevant_scenarios()[:2],
                                       ["S one.", "S two"])
    tirr.save_perturbations(data, str(tmp_path / "t.json"))
    jirr.save_perturbations(data, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert tirr.load_perturbations(str(tmp_path / "t.json")) == data


# -- rephrasing generation ----------------------------------------------------

@pytest.mark.parametrize("text", [
    "Here are 20 variations:\n1. First rephrasing?\n2. Second rephrasing\n"
    "   that continues on another line?\n3 Third without dot?\n\n4. Fourth?\n",
    "Intro line without a number\n1. one\n2.two\n10. ten. with dots.\n",
    "5\n- dash line\n12 - twelve\n",
    "",
])
def test_parse_numbered_rephrasings_matches_reference(text):
    assert (treph.parse_numbered_rephrasings(text)
            == jreph.parse_numbered_rephrasings(text))


def _session_replies(seed):
    """A scripted model: numbered lists of varying length, and a broken
    session every so often."""
    rng = np.random.default_rng(seed)
    state = {"n": 0}

    def complete(prompt):
        state["n"] += 1
        if state["n"] % 5 == 0:
            raise RuntimeError(f"session {state['n']} broke")
        k = int(rng.integers(1, 9))
        return "Here are variations:\n" + "\n".join(
            f"{i + 1}. {prompt[20:40]} v{state['n']}.{i}?" for i in range(k))

    return complete


@pytest.mark.parametrize("sessions,target", [(3, 2000), (10, 12), (0, 5)])
def test_generate_rephrasings_matches_reference(tmp_path, sessions, target):
    scen = tconfig.legal_scenarios()
    errors = {"jax": [], "torch": []}
    got = {}
    for name, mod in (("jax", jreph), ("torch", treph)):
        got[name] = mod.generate_rephrasings(
            scen, _session_replies(sessions), sessions_per_scenario=sessions,
            target_per_scenario=target,
            on_error=lambda s, e, n=name: errors[n].append((s, str(e))))
        mod.save_perturbations(got[name], str(tmp_path / name / "p.json"))
    assert got["torch"] == got["jax"]
    assert errors["torch"] == errors["jax"]
    assert ((tmp_path / "torch" / "p.json").read_bytes()
            == (tmp_path / "jax" / "p.json").read_bytes())
    assert treph.load_perturbations(str(tmp_path / "torch" / "p.json"),
                                    expected_scenarios=scen) == got["torch"]
    assert treph.REPHRASE_TEMPLATE == jreph.REPHRASE_TEMPLATE
