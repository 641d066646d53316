"""Verbalized-confidence parsing and logprob-weighted confidence (a copy of
``scoring/confidence.py``: host code, no device work).

Host-side behavioral replicas of the study's confidence pipeline:

- ``extract_first_int`` — the ``re.search(r'\\b(\\d+)\\b')`` parse used on every
  confidence reply (perturb_prompts.py:443-448 and the other API legs).
- ``weighted_confidence_single_tokens`` — GPT-style: every numeric token in the
  top-logprobs of every generated position contributes value*prob
  (perturb_prompts.py:505-526, perturb_prompts_gpt.py:47-85).
- ``weighted_confidence_digits`` — Gemini-style multi-token reconstruction:
  combine 1-/2-/3-digit continuations ("1"+"0"+"0" → 100) while subtracting
  continuation mass from shorter readings
  (evaluate_closed_source_models.py:327-456, perturb_prompts_gemini.py:270-416).
- ``extract_final_number`` — thinking-model output parser: ***/### markers,
  last standalone-number line, last number, ≤3-digit concat fallback
  (evaluate_irrelevant_perturbations.py:190-265).
- ``top_candidates_from_scores`` — adapter turning our models' per-step score
  tensors into (token, logprob) candidate lists so local models get the
  same weighted-confidence treatment the APIs get.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence, Tuple

Candidate = Tuple[str, float]  # (token text, logprob)


def extract_first_int(text: str) -> Optional[int]:
    if not text:
        return None
    m = re.search(r"\b(\d+)\b", text)
    if not m:
        return None
    try:
        return int(m.group(1))
    except ValueError:
        return None


def first_int_stable(text: str) -> bool:
    """Can :func:`extract_first_int` of ``text`` still change if more text
    is APPENDED?  False means yes (keep decoding), True means the parse is
    frozen: the first ``\\b``-delimited integer ends strictly before the
    end of the string, so the character after it is a non-word boundary —
    appended text can neither extend those digits nor introduce an
    earlier match.  A trailing integer ("...about 8") is NOT stable: the
    next token could extend it ("...about 85").  The pooled confidence
    decode's early-exit retirement rests on this predicate
    (``runtime.engine._Phase2Pool._flush_confidence``)."""
    if not text:
        return False
    m = re.search(r"\b(\d+)\b", text)
    return bool(m) and m.end() < len(text)


def weighted_confidence_single_tokens(
    positions: Sequence[Sequence[Candidate]],
) -> Optional[float]:
    """Every numeric token (0-100) across all positions' top-logprobs,
    probability-weighted.  Matches the OpenAI leg's batch extractor."""
    weighted = 0.0
    total = 0.0
    for cands in positions:
        for token, logprob in cands:
            m = re.search(r"\b(\d+)\b", token)
            if not m:
                continue
            value = int(m.group(1))
            if 0 <= value <= 100:
                p = math.exp(logprob)
                weighted += value * p
                total += p
    return weighted / total if total > 0 else None


def weighted_confidence_digits(
    positions: Sequence[Sequence[Candidate]],
    max_candidates: int = 19,
) -> Optional[float]:
    """Multi-token number reconstruction over the first three positions.

    Single-digit first tokens extend to 2-digit values via position 2 and to
    100 via position 3; the probability mass of continuations is subtracted
    from the shorter readings ("1"→"10"→"100" chain).  Complete number tokens
    ("42", "100") contribute directly.
    """
    if not positions:
        return None
    first = positions[0] if len(positions) > 0 else None
    second = positions[1] if len(positions) > 1 else None
    third = positions[2] if len(positions) > 2 else None
    if not first:
        return None

    one: dict = {}
    two: dict = {}
    three: dict = {}

    def digit_cands(pos):
        out = []
        for token, logprob in pos[:max_candidates]:
            t = token.strip()
            if t.isdigit() and len(t) == 1:
                out.append((int(t), math.exp(logprob)))
        return out

    second_digits = digit_cands(second) if second else []
    second_digit_mass = sum(p for _, p in second_digits)
    third_zero_prob = 0.0
    if third:
        for token, logprob in third[:max_candidates]:
            if token.strip() == "0":
                third_zero_prob = math.exp(logprob)
                break

    for token, logprob in first[:max_candidates]:
        t = token.strip()
        p1 = math.exp(logprob)
        if t.isdigit() and len(t) == 1:
            d1 = int(t)
            standalone = p1
            if second and 1 <= d1 <= 9:
                for d2, p2 in second_digits:
                    value = d1 * 10 + d2
                    if value == 10 and third:
                        # 1-0-0 chain → 100
                        three[100] = three.get(100, 0.0) + p1 * p2 * third_zero_prob
                    if 10 <= value <= 99:
                        combined = p1 * p2
                        if value == 10 and third:
                            combined *= 1 - third_zero_prob
                        two[value] = two.get(value, 0.0) + combined
                standalone *= 1 - second_digit_mass
            one[d1] = one.get(d1, 0.0) + standalone
        elif t.isdigit():
            value = int(t)
            if value == 100:
                three[100] = three.get(100, 0.0) + p1
            elif 10 <= value <= 99:
                two[value] = two.get(value, 0.0) + p1
            elif 0 <= value <= 9:
                one[value] = one.get(value, 0.0) + p1

    all_probs: dict = {}
    all_probs.update(one)
    all_probs.update(two)
    all_probs.update(three)
    total = sum(all_probs.values())
    if total <= 0 or not all_probs:
        return None
    return sum(v * p / total for v, p in all_probs.items())


def extract_final_number(response_text: str) -> Optional[float]:
    """Robust last-answer extraction for thinking-model outputs."""
    if not response_text:
        return None
    # number sandwiched between *** / ### markers
    m = re.search(
        r"(?:\*{3,}|#{3,})\s*(\d+(?:\.\d+)?)\s*(?:\*{3,}|#{3,})",
        response_text,
        re.MULTILINE | re.DOTALL,
    )
    if m:
        return float(m.group(1))
    lines = response_text.split("\n")
    # standalone number on a line above the last marker block
    after_marker = False
    for line in reversed(lines):
        line = line.strip()
        if "***" in line or "###" in line:
            after_marker = True
        elif after_marker and line:
            m = re.match(r"^(\d+(?:\.\d+)?)$", line)
            if m:
                return float(m.group(1))
    # last line that is exactly a number
    for line in reversed(lines):
        m = re.match(r"^(\d+(?:\.\d+)?)$", line.strip())
        if m:
            return float(m.group(1))
    # last number anywhere
    numbers = re.findall(r"\b(\d+(?:\.\d+)?)\b", response_text)
    if numbers:
        return float(numbers[-1])
    # digits-only concat, short numbers only
    digits = "".join(ch for ch in response_text if ch.isdigit())
    if digits and len(digits) <= 3:
        return float(digits)
    return None


def top_candidates_from_scores(
    scores,                     # numpy [P, V] fp32 per-position scores
    tokenizer,
    num_positions: int = 3,
    top_k: int = 19,
) -> List[List[Candidate]]:
    """Turn model score rows into API-style top-candidate lists so the digit
    reconstruction above applies to local models."""
    import numpy as np

    scores = np.asarray(scores, dtype=np.float64)
    positions: List[List[Candidate]] = []
    for p in range(min(num_positions, scores.shape[0])):
        row = scores[p]
        logz = _logsumexp(row)
        idx = np.argpartition(-row, top_k)[:top_k]
        idx = idx[np.argsort(-row[idx])]
        cands = [(tokenizer.decode([int(i)]), float(row[i] - logz)) for i in idx]
        positions.append(cands)
    return positions


def _logsumexp(row):
    import numpy as np

    m = np.max(row)
    return m + math.log(np.sum(np.exp(row - m)))
