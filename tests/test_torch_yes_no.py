"""The port's yes/no scan functions against the JAX reference.

Inputs from a numpy seed, float32.  Scan verdicts (found, position) must be
identical; probabilities match to rtol 2e-5 (the fp32 class of PARITY.md)
with an absolute floor of 1e-9 for probabilities near zero.  The tie cases
put a target exactly on the k-th candidate: the ``>=`` rule counts it as a
member on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helpers import build_test_tokenizer
from llm_interpretation_replication_tpu.scoring import yes_no as jyn
from llm_interpretation_replication_tpu_torch.scoring import yes_no as tyn
from llm_interpretation_replication_tpu_torch.utils.tokenizer import (
    WordTokenizer, default_tokenizer)
from test_torch_slots import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-5, 1e-9


def _same(got, ref):
    for f in ("yes_prob", "no_prob", "relative_prob", "odds_ratio"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))
    np.testing.assert_array_equal(got.position.numpy(), np.asarray(ref.position))


def _scores(seed, b=6, p=7, v=50):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, p, v)) * 3).astype(np.float32)


def _tie(scores, top_k, yes_id, row, pos):
    """Set row/pos's yes logit equal to its k-th largest other logit."""
    s = scores[row, pos].copy()
    s[yes_id] = -1e3
    s[yes_id] = np.sort(s)[::-1][top_k - 1]
    scores[row, pos] = s
    return scores


@pytest.mark.parametrize("valid", [False, True])
def test_yes_no_from_scores(valid):
    scores = _tie(_scores(0), 3, 4, row=1, pos=2)
    yes = np.array([4, 4, 9, 4, 1, 7], np.int32)
    no = np.array([5, 6, 3, 2, 8, 11], np.int32)
    vsteps = np.array([7, 1, 3, 0, 5, 2], np.int32) if valid else None
    ref = jyn.yes_no_from_scores(jnp.asarray(scores), jnp.asarray(yes),
                                 jnp.asarray(no), max_look_ahead=5, top_k=3,
                                 valid_steps=None if vsteps is None
                                 else jnp.asarray(vsteps))
    got = tyn.yes_no_from_scores(torch.from_numpy(scores), torch.from_numpy(yes),
                                 torch.from_numpy(no), max_look_ahead=5,
                                 top_k=3, valid_steps=None if vsteps is None
                                 else torch.from_numpy(vsteps))
    _same(got, ref)


def _reduced(scores, yes, no, k=19):
    s = torch.from_numpy(scores)
    vals, _ = torch.topk(s, k, dim=-1)
    logz = torch.logsumexp(s, dim=-1)
    tgt = torch.stack([s[np.arange(len(yes)), :, yes],
                       s[np.arange(len(no)), :, no]], dim=-1)
    return vals.numpy(), logz.numpy(), tgt.numpy()


@pytest.mark.parametrize("top_k", [1, 5, 19])
def test_yes_no_from_reduced(top_k):
    scores = _tie(_scores(1, v=60), top_k, 4, row=0, pos=1)
    yes = np.array([4, 10, 20, 4, 30, 40], np.int32)
    no = np.array([5, 11, 21, 31, 41, 50], np.int32)
    vals, logz, tgt = _reduced(scores, yes, no)
    vsteps = np.array([7, 2, 7, 3, 1, 7], np.int32)
    ref = jyn.yes_no_from_reduced(jnp.asarray(vals), jnp.asarray(logz),
                                  jnp.asarray(tgt), max_look_ahead=6,
                                  top_k=top_k, valid_steps=jnp.asarray(vsteps))
    got = tyn.yes_no_from_reduced(torch.from_numpy(vals), torch.from_numpy(logz),
                                  torch.from_numpy(tgt), max_look_ahead=6,
                                  top_k=top_k, valid_steps=torch.from_numpy(vsteps))
    _same(got, ref)
    if top_k > 1:
        assert bool(got.found[0]) and int(got.position[0]) <= 1
    with pytest.raises(ValueError):
        tyn.yes_no_from_reduced(torch.from_numpy(vals), torch.from_numpy(logz),
                                torch.from_numpy(tgt), top_k=20)


@pytest.mark.parametrize("eos", [None, 3])
def test_steps_until_eos(eos):
    tokens = np.array([[1, 3, 3, 4], [3, 0, 0, 0], [1, 2, 4, 5]], np.int32)
    ref = np.asarray(jyn.steps_until_eos(jnp.asarray(tokens), eos))
    got = tyn.steps_until_eos(torch.from_numpy(tokens), eos).numpy()
    np.testing.assert_array_equal(got, ref)


def test_first_token_scan_and_relative_prob():
    logits = _scores(2, b=8, p=1, v=40)[:, 0]
    logits = _tie(logits[:, None], 5, 7, row=3, pos=0)[:, 0]
    yes = np.full((8,), 7, np.int32)
    no = np.arange(8, dtype=np.int32) + 10
    ref = jyn.first_token_scan(jnp.asarray(logits), jnp.asarray(yes),
                               jnp.asarray(no), top_k=5)
    got = tyn.first_token_scan(torch.from_numpy(logits), torch.from_numpy(yes),
                               torch.from_numpy(no), top_k=5)
    for g, r in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    assert bool(got[4][3])                  # the tie at the 5th candidate hits
    for top_filter in (0, 3, 20):
        ref = jyn.relative_prob_first_token(jnp.asarray(logits), 7,
                                            jnp.asarray(no), top_filter)
        got = tyn.relative_prob_first_token(torch.from_numpy(logits), 7,
                                            torch.from_numpy(no), top_filter)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                       atol=ATOL)


def test_target_token_ids_match_reference():
    tok = build_test_tokenizer()
    targets = ["Yes", "No", "Answer"]
    assert tyn.target_token_ids(tok, targets) == jyn.target_token_ids(tok, targets)


def test_word_tokenizer_interface():
    """The port's own tokenizer: " Yes" and "Yes" differ, encoded batches
    read as a mapping and as attributes, decode skips specials."""
    tok = default_tokenizer()
    yes_sp = tok(" Yes", add_special_tokens=False).input_ids
    assert yes_sp == [tok.ids[" Yes"]] and tok.encode("Yes") == [tok.ids["Yes"]]
    assert tyn.target_token_ids(tok, ["Yes", "No"]) == [tok.ids[" Yes"],
                                                       tok.ids[" No"]]
    batch = tok(["Is soup a beverage? Yes", "Answer: No"])["input_ids"]
    assert batch[1] == [tok.ids["Answer:"], tok.ids[" No"]]
    assert tok.unk_token_id in batch[0]                  # "beverage?"
    assert tok.decode([tok.pad_token_id, tok.ids["Answer:"], tok.ids[" No"],
                       tok.eos_token_id], skip_special_tokens=True) == "Answer: No"
    assert len(WordTokenizer(["a", "a", "b"])) == 3 + 4
