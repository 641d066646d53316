"""Schema-exact perturbation rows (a copy of ``sweeps/writers.py``'s
``PERTURBATION_COLUMNS``, ``perturbation_row`` and
``model_family_from_name``).

Downstream statistics key on these exact column names, so the workbook is a
drop-in replacement for the study's own.
"""

from __future__ import annotations

from typing import Dict, Optional

#: perturbation result workbook columns, in order
PERTURBATION_COLUMNS = [
    "Model",
    "Original Main Part",
    "Response Format",
    "Confidence Format",
    "Rephrased Main Part",
    "Full Rephrased Prompt",
    "Full Confidence Prompt",
    "Model Response",
    "Model Confidence Response",
    "Log Probabilities",
    "Token_1_Prob",
    "Token_2_Prob",
    "Odds_Ratio",
    "Confidence Value",
    "Weighted Confidence",
]


def model_family_from_name(model_name: str) -> str:
    """``org/model-name`` -> family slug."""
    tail = model_name.split("/")[1] if "/" in model_name else model_name
    return tail.split("-")[0].lower()


def perturbation_row(
    model: str,
    scenario: Dict,
    rephrased_main: str,
    response_text: str = "",
    confidence_text: str = "",
    logprobs_repr: str = "",
    token_1_prob: float = 0.0,
    token_2_prob: float = 0.0,
    odds_ratio: float = 0.0,
    confidence_value: Optional[int] = None,
    weighted_confidence: Optional[float] = None,
) -> Dict:
    return {
        "Model": model,
        "Original Main Part": scenario["original_main"],
        "Response Format": scenario["response_format"],
        "Confidence Format": scenario["confidence_format"],
        "Rephrased Main Part": rephrased_main,
        "Full Rephrased Prompt": f"{rephrased_main} {scenario['response_format']}",
        "Full Confidence Prompt": f"{rephrased_main} {scenario['confidence_format']}",
        "Model Response": response_text,
        "Model Confidence Response": confidence_text,
        "Log Probabilities": logprobs_repr,
        "Token_1_Prob": token_1_prob,
        "Token_2_Prob": token_2_prob,
        "Odds_Ratio": odds_ratio,
        "Confidence Value": confidence_value,
        "Weighted Confidence": weighted_confidence,
    }
