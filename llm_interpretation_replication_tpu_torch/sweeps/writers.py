"""Schema-exact result rows (a copy of ``sweeps/writers.py``'s
``PERTURBATION_COLUMNS``, ``perturbation_row``, ``model_family_from_name``,
``BASE_VS_INSTRUCT_100Q_COLUMNS``, ``MODEL_COMPARISON_COLUMNS`` and
``INSTRUCT_COMPARISON_COLUMNS``, with the two comparison frames as row
lists) and a CSV writer that writes the bytes
``pandas.DataFrame(rows)[columns].to_csv(path, index=False)`` writes.

Downstream statistics key on these exact column names, so the workbook and
the CSV are drop-in replacements for the study's own.
"""

from __future__ import annotations

import csv
import math
import numbers
import os
from typing import Dict, List, Optional, Sequence

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


#: base_vs_instruct_100q_results.csv columns, in order
BASE_VS_INSTRUCT_100Q_COLUMNS = [
    "yes_prob", "no_prob", "relative_prob", "completion", "success",
    "prompt", "model", "formatted_prompt", "model_family", "base_or_instruct",
]


#: model_comparison_results.csv columns (the word-meaning sweep), in order
MODEL_COMPARISON_COLUMNS = [
    "prompt", "model", "model_family", "base_or_instruct", "model_output",
    "yes_prob", "no_prob", "odds_ratio",
]

#: instruct_model_comparison_results.csv columns, in order
INSTRUCT_COMPARISON_COLUMNS = [
    "prompt", "model", "model_family", "model_output",
    "yes_prob", "no_prob", "relative_prob",
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


def model_comparison_frame(outputs: Dict[str, Dict[str, Dict]],
                           model_pairs) -> List[Dict]:
    """``outputs[model][prompt]`` -> result dict, over (base, instruct)
    pairs -> the rows of ``MODEL_COMPARISON_COLUMNS``."""
    data = []
    for pair in model_pairs:
        base_name, instruct_name = pair[0], pair[1]
        for model_name in (base_name, instruct_name):
            family = model_family_from_name(model_name)
            role = "base" if model_name == base_name else "instruct"
            for prompt, result in outputs.get(model_name, {}).items():
                data.append({
                    "prompt": prompt,
                    "model": model_name,
                    "model_family": family,
                    "base_or_instruct": role,
                    "model_output": result.get("completion", "N/A"),
                    "yes_prob": result.get("yes_prob", float("nan")),
                    "no_prob": result.get("no_prob", float("nan")),
                    "odds_ratio": result.get("odds_ratio", float("nan")),
                })
    return data


def instruct_comparison_frame(outputs: Dict[str, Dict[str, Dict]],
                              models: Sequence[str]) -> List[Dict]:
    """``outputs[model][prompt]`` -> result dict -> the rows of
    ``INSTRUCT_COMPARISON_COLUMNS``, in roster order."""
    data = []
    for model_name in models:
        family = model_family_from_name(model_name)
        for prompt, result in outputs.get(model_name, {}).items():
            data.append({
                "prompt": prompt,
                "model": model_name,
                "model_family": family,
                "model_output": result.get("completion", "N/A"),
                "yes_prob": result.get("yes_prob", float("nan")),
                "no_prob": result.get("no_prob", float("nan")),
                "relative_prob": result.get("relative_prob", float("nan")),
            })
    return data


def _is_null(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _is_number(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def _csv_column(values: Sequence) -> List[str]:
    """One column's fields as pandas writes them: a column of numbers with a
    float or an empty cell is float64, every value in ``repr`` (an int
    reads ``1.0``); a column of ints only keeps them; any other column is
    object, each value in ``str``.  An empty cell (None, NaN) is empty."""
    present = [v for v in values if not _is_null(v)]
    as_float = (all(_is_number(v) for v in present) and len(present) > 0
                and (len(present) < len(values)
                     or any(not isinstance(v, numbers.Integral) for v in present)))
    return ["" if _is_null(v) else repr(float(v)) if as_float else str(v)
            for v in values]


def write_csv(columns: Sequence[str], rows: Sequence[Dict], path: str) -> None:
    """Write ``rows`` (dicts holding every column) to ``path`` as
    ``pandas.DataFrame(rows)[columns].to_csv(path, index=False)`` does:
    comma-separated, ``\\n`` line ends, fields quoted only where they hold a
    comma, a quote or a line break (quotes doubled), floats in their
    shortest round-trip form, ``True``/``False``, empty cells empty."""
    cols = [_csv_column([r[c] for r in rows]) for c in columns]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows(zip(*cols))
