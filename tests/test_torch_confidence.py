"""The port's copy of ``scoring/confidence.py`` against the JAX package's.

Every function of the module takes the same texts and candidate lists in
both packages and must give exactly the same answer (``==``, floats
included: the copy is host code with the same arithmetic).  The
``first_int_stable`` table holds the reference's own cases
(``tests/test_pooled_conf.py``) and the U+FFFD tails the pooled confidence
leg's retirement rule guards against.
"""

import math

import numpy as np
import pytest

from llm_interpretation_replication_tpu.scoring import confidence as jconf
from llm_interpretation_replication_tpu_torch.scoring import confidence as tconf
from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
    WordTokenizer)
from test_torch_slots import one_torch_thread  # noqa: F401

TEXTS = [
    "", "no digits at all", "85", "I am 85", "85 percent", "85%",
    "about 40, maybe", "x85x", "�3 a 9", "3�", "�", "100.",
    " 7 out of 10", "007 agents", "confidence: 85 ", "12abc 34", "-5 then 6",
    "v2 or 3?", "9" * 30, "line\n42\n",
]
# the reference's own first_int_stable cases, with their expected answers
STABLE_CASES = [
    ("", False), ("no digits at all", False), ("85", False),
    ("I am 85", False), ("85 percent", True), ("85%", True),
    ("about 40, maybe", True), ("x85x", False),
]
FINAL_TEXTS = [
    "", "The answer is ***72***", "### 15 ###", "reasoning\n64\n***",
    "I think 30\nthen 45", "no numbers", "a1b2", "a1b2c3d4", "4.5 or 7.25",
]


@pytest.mark.parametrize("text", TEXTS)
def test_extract_first_int_matches_reference(text):
    assert tconf.extract_first_int(text) == jconf.extract_first_int(text)


@pytest.mark.parametrize("text", TEXTS)
def test_first_int_stable_matches_reference(text):
    assert tconf.first_int_stable(text) is jconf.first_int_stable(text)


@pytest.mark.parametrize("text,stable", STABLE_CASES)
def test_first_int_stable_cases(text, stable):
    assert tconf.first_int_stable(text) is stable


def test_stability_is_append_proof():
    """Once stable, no appended text changes the first integer."""
    base = "confidence: 85 "
    assert tconf.first_int_stable(base)
    for tail in ("9", "99", " 12", "x", ".5", "000"):
        assert tconf.extract_first_int(base + tail) == 85, tail


@pytest.mark.parametrize("text", FINAL_TEXTS)
def test_extract_final_number_matches_reference(text):
    assert tconf.extract_final_number(text) == jconf.extract_final_number(text)


def _candidates(seed):
    """Three positions of 19 (token, logprob) candidates drawn from a
    numpy seed: digit tokens, multi-digit tokens, words, with or without a
    leading space."""
    rng = np.random.default_rng(seed)
    pool = ([str(d) for d in range(10)] + [" " + str(d) for d in range(10)]
            + ["10", "42", "85", "100", " 100", "7x", "the", " a", "%", "."])
    positions = []
    for _ in range(3):
        toks = rng.choice(pool, 19, replace=False)
        logits = rng.standard_normal(19) * 2
        lp = logits - math.log(np.exp(logits).sum() + rng.random() * 5)
        positions.append([(str(t), float(v)) for t, v in zip(toks, lp)])
    return positions


HAND_CASES = [
    [],
    [[("the", -0.1)]],
    [[("1", -0.2)], [("0", -0.3)], [("0", -0.4)]],       # the 1-0-0 chain
    [[("4", -0.5), ("42", -1.0)], [("2", -0.7)]],
    [[("100", -0.05), (" 9", -3.0)]],
    [[(" 5", -0.1)], [("x", -0.1)], [("0", -1.0)]],
]


@pytest.mark.parametrize("case", list(range(8)) + [
    f"hand{i}" for i in range(len(HAND_CASES))])
def test_weighted_confidence_matches_reference(case):
    positions = (HAND_CASES[int(case[4:])] if isinstance(case, str)
                 else _candidates(case))
    for fn in ("weighted_confidence_digits",
               "weighted_confidence_single_tokens"):
        assert getattr(tconf, fn)(positions) == getattr(jconf, fn)(positions)


def test_top_candidates_from_scores_matches_reference():
    tok = WordTokenizer([str(d) for d in range(10)] + ["a", "b", "c"])
    scores = np.random.default_rng(3).standard_normal(
        (4, len(tok))).astype(np.float32)
    assert tconf.top_candidates_from_scores(scores, tok, top_k=6) == \
        jconf.top_candidates_from_scores(scores, tok, top_k=6)


def test_copy_has_every_public_function():
    public = {n for n in dir(jconf) if not n.startswith("_")
              and callable(getattr(jconf, n))}
    assert public <= set(dir(tconf))
