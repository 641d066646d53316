"""Per-vendor question evaluators and baselines (a copy of the JAX
package's ``api_backends/evaluators.py``, on the port's
``scoring/confidence.py``).

Each evaluator runs a binary leg (target-token probabilities from the first
token's top logprobs, where the vendor gives them) and a confidence leg (a
verbalized 0-100 and a logprob-weighted confidence); the Random and Normal
baselines draw from numpy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..scoring.confidence import (
    extract_first_int,
    weighted_confidence_digits,
    weighted_confidence_single_tokens,
)

BINARY_SUFFIX = "Answer either 'Yes' or 'No', without any other text."
CONFIDENCE_SUFFIX = (
    "How confident are you that the answer is Yes, on a scale from 0 (not "
    "confident) to 100 (most confident)? Answer only with a number, without "
    "any other explanation."
)


def first_token_target_probs(
    top_logprobs: Sequence[Dict], targets: Tuple[str, str]
) -> Tuple[float, float]:
    """exp(logprob) of each target among the FIRST token's top-logprobs; 0 when
    absent."""
    p1 = p2 = 0.0
    for item in top_logprobs:
        token = item.get("token")
        if token == targets[0]:
            p1 = math.exp(item["logprob"])
        elif token == targets[1]:
            p2 = math.exp(item["logprob"])
    return p1, p2


def openai_content_and_logprobs(response: Dict):
    choice = response["choices"][0]
    text = (choice["message"].get("content") or "").strip()
    content = (choice.get("logprobs") or {}).get("content") or []
    return text, content


def evaluate_gpt_binary(client, model: str, question: str,
                        targets: Tuple[str, str] = ("Yes", "No")) -> Dict:
    resp = client.chat_completion(
        model, [{"role": "user", "content": f"{question} {BINARY_SUFFIX}"}]
    )
    text, content = openai_content_and_logprobs(resp)
    top = content[0].get("top_logprobs", []) if content else []
    p1, p2 = first_token_target_probs(top, targets)
    total = p1 + p2
    return {
        "response": text,
        "yes_prob": p1,
        "no_prob": p2,
        "relative_prob": p1 / total if total > 0 else 0.5,
        "raw": resp,
    }


def evaluate_gpt_confidence(client, model: str, question: str) -> Dict:
    resp = client.chat_completion(
        model, [{"role": "user", "content": f"{question} {CONFIDENCE_SUFFIX}"}]
    )
    text, content = openai_content_and_logprobs(resp)
    positions = [
        [(i["token"], i["logprob"]) for i in tok.get("top_logprobs", [])]
        for tok in content
    ]
    return {
        "response": text,
        "confidence": extract_first_int(text),
        "weighted_confidence": weighted_confidence_single_tokens(positions),
        "raw": resp,
    }


def evaluate_gemini_binary(client, model: str, question: str,
                           targets: Tuple[str, str] = ("Yes", "No")) -> Dict:
    resp = client.generate_content(
        model, f"{question} {BINARY_SUFFIX}", response_logprobs=True
    )
    text = client.text_of(resp)
    positions = client.top_candidates_of(resp)
    p1 = p2 = 0.0
    if positions:
        for token, logprob in positions[0]:
            if token.strip() == targets[0]:
                p1 = math.exp(logprob)
            elif token.strip() == targets[1]:
                p2 = math.exp(logprob)
    total = p1 + p2
    return {
        "response": text,
        "yes_prob": p1,
        "no_prob": p2,
        "relative_prob": p1 / total if total > 0 else 0.5,
        "raw": resp,
    }


def evaluate_gemini_confidence(client, model: str, question: str) -> Dict:
    resp = client.generate_content(
        model, f"{question} {CONFIDENCE_SUFFIX}", response_logprobs=True
    )
    text = client.text_of(resp)
    positions = client.top_candidates_of(resp)
    return {
        "response": text,
        "confidence": extract_first_int(text),
        "weighted_confidence": weighted_confidence_digits(positions),
        "raw": resp,
    }


def evaluate_claude(client, model: str, question: str,
                    sleep=None, delay: float = 0.0) -> Dict:
    """Claude has no logprobs: binary text + verbalized confidence only.
    ``sleep``/``delay`` pace the two requests: the pause sits between the
    calls, not after the pair."""
    binary = client.create_message(
        model, [{"role": "user", "content": f"{question} {BINARY_SUFFIX}"}]
    )
    if sleep is not None:
        sleep(delay)
    confidence = client.create_message(
        model, [{"role": "user", "content": f"{question} {CONFIDENCE_SUFFIX}"}]
    )
    conf_text = client.text_of(confidence)
    return {
        "response": client.text_of(binary),
        "confidence": extract_first_int(conf_text),
        "confidence_response": conf_text,
    }


def evaluate_random_baseline(rng: Optional[np.random.Generator] = None) -> Dict:
    """Uniform Yes/No + uniform confidence."""
    rng = rng or np.random.default_rng()
    answer = "Yes" if rng.random() < 0.5 else "No"
    return {
        "response": answer,
        "relative_prob": 1.0 if answer == "Yes" else 0.0,
        "confidence": int(rng.integers(0, 101)),
    }


def evaluate_normal_baseline(human_mean: float, human_std: float,
                             rng: Optional[np.random.Generator] = None) -> Dict:
    """Draw from N(human μ, σ) clipped to [0,1]."""
    rng = rng or np.random.default_rng()
    value = float(np.clip(rng.normal(human_mean, human_std), 0.0, 1.0))
    return {
        "response": "Yes" if value >= 0.5 else "No",
        "relative_prob": value,
        "confidence": int(round(value * 100)),
    }
