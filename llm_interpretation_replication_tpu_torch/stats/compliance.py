"""Output/confidence compliance audits.

Behavioral replicas of analyze_perturbation_results.py:1191-1500 (did the model
literally obey "answer only X"?) and :1501-1718 (is the confidence reply a bare
integer 0-100?) — effectively behavioral tests of the prompt/parser contract.

A copy of the JAX package's module on row dicts: a workbook is its rows (as
``utils.frame.records`` types them), and each report is the rows its
DataFrame's ``to_dict("records")`` gives.
"""

from __future__ import annotations

import ast
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import frame

#: Expected first tokens / full responses per scenario (data contract —
#: analyze_perturbation_results.py:1206-1248)
EXPECTED_TOKENS = [
    {
        "first_tokens": ["Covered", "Not"],
        "full_responses": {
            "Covered": ["Covered"],
            "Not": ["Not Covered", "Not covered"],
        },
    },
    {
        "first_tokens": ["First", "Ultimate"],
        "full_responses": {
            "First": ["First Petition", "First petition"],
            "Ultimate": ["Ultimate Petition", "Ultimate petition"],
        },
    },
    {
        "first_tokens": ["Existing", "Future"],
        "full_responses": {
            "Existing": ["Existing Affiliates", "Existing affiliates"],
            "Future": ["Future Affiliates", "Future affiliates"],
        },
    },
    {
        "first_tokens": ["Monthly", "Payment"],
        "full_responses": {
            "Monthly": [
                "Monthly Installment Payments",
                "Monthly installment payments",
                "Monthly Installment Payment",
            ],
            "Payment": ["Payment Upon Completion", "Payment upon completion", "Payment Upon"],
        },
    },
    {
        "first_tokens": ["Covered", "Not"],
        "full_responses": {
            "Covered": ["Covered"],
            "Not": ["Not Covered", "Not covered"],
        },
    },
]


def parse_logprobs_field(value):
    """Parse the stringified 'Log Probabilities' column (JSON or repr)."""
    if isinstance(value, dict):
        return value
    if not isinstance(value, str):
        return None
    try:
        return json.loads(value)
    except (json.JSONDecodeError, ValueError):
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return None


def check_first_and_full(
    first_token: str, full_response: str, expected: Dict
) -> Tuple[bool, Optional[bool]]:
    """(first-token compliant, full-response compliant | None if first failed)."""
    matched = None
    for exp in expected["first_tokens"]:
        if first_token == exp or first_token.startswith(exp):
            matched = exp
            break
    if matched is None:
        return False, None
    norm_resp = full_response.replace(" ", "")
    for exp_full in expected["full_responses"].get(matched, []):
        norm_exp = exp_full.replace(" ", "")
        if full_response == exp_full or norm_resp == norm_exp or norm_resp.startswith(norm_exp):
            return True, True
    return True, False


def check_output_compliance(
    rows: Sequence[Dict],
    expected_tokens: Sequence[Dict] = EXPECTED_TOKENS,
    response_col: str = "Model Response",
) -> List[Dict]:
    """Per-scenario compliance rates over a perturbation workbook.

    Prefers the API-style 'Log Probabilities' content tokens when parseable
    (first token + concatenated response); otherwise falls back to the text in
    ``response_col`` (first whitespace token + full string), which covers the
    local-TPU sweep rows.
    """
    results = []
    scenarios = frame.unique(frame.column(rows, "Original Main Part"))
    for idx, original in enumerate(scenarios):
        if idx >= len(expected_tokens):
            continue
        expected = expected_tokens[idx]
        sub = [r for r in rows if r["Original Main Part"] == original]
        if sub and "Relative_Prob" in sub[0]:
            sub = [r for r in sub if np.isfinite(r["Relative_Prob"])]
        total = len(sub)
        if total == 0:
            continue
        first_ok = first_bad = full_ok = full_bad = 0
        bad_first_examples: List[str] = []
        bad_full_examples: List[str] = []
        for row in sub:
            first_token, full_response = None, None
            lp = parse_logprobs_field(row.get("Log Probabilities"))
            if lp and isinstance(lp, dict) and lp.get("content"):
                first_token = lp["content"][0].get("token", "")
                full_response = "".join(
                    t.get("token", "") for t in lp["content"]
                ).strip()
            else:
                text = str(row.get(response_col, "") or "")
                stripped = text.strip()
                first_token = stripped.split()[0] if stripped.split() else ""
                full_response = stripped
            ok1, ok2 = check_first_and_full(first_token, full_response, expected)
            if ok1:
                first_ok += 1
                if ok2:
                    full_ok += 1
                else:
                    full_bad += 1
                    if len(bad_full_examples) < 5:
                        bad_full_examples.append(full_response)
            else:
                first_bad += 1
                if len(bad_first_examples) < 5:
                    bad_first_examples.append(first_token)
        rec = {
            "Prompt": idx + 1,
            "Expected_First_Tokens": ", ".join(expected["first_tokens"]),
            "Total_Samples": total,
            "First_Token_Compliant": first_ok,
            "First_Token_Non_Compliant": first_bad,
            "First_Token_Compliance_Rate": 100.0 * first_ok / total,
            "First_Token_Non_Compliance_Rate": 100.0 * first_bad / total,
            "Non_Compliant_First_Examples": bad_first_examples,
            "Non_Compliant_Full_Examples": bad_full_examples,
        }
        if first_ok > 0:
            rec.update(
                {
                    "Conditional_Subsequent_Compliant": full_ok,
                    "Conditional_Subsequent_Non_Compliant": full_bad,
                    "Conditional_Subsequent_Compliance_Rate": 100.0 * full_ok / first_ok,
                }
            )
        results.append(rec)
    return frame.records(results)[1]


def classify_confidence_response(value) -> str:
    """'compliant' | 'out_of_range' | 'float' | 'text' | 'other'."""
    s = str(value).strip()
    try:
        v = int(s)
        return "compliant" if 0 <= v <= 100 else "out_of_range"
    except ValueError:
        pass
    try:
        float(s)
        return "float"
    except ValueError:
        pass
    if any(c.isalpha() for c in s):
        return "text"
    return "other"


def check_confidence_compliance(rows: Sequence[Dict]) -> List[Dict]:
    """Per-scenario confidence-format compliance over the workbook."""
    results = []
    scenarios = frame.unique(frame.column(rows, "Original Main Part"))
    for idx, original in enumerate(scenarios):
        sub = [r for r in rows if r["Original Main Part"] == original
               and not frame.is_na(r["Model Confidence Response"])]
        total = len(sub)
        if total == 0:
            continue
        counts = {"compliant": 0, "out_of_range": 0, "float": 0, "text": 0, "other": 0}
        for row in sub:
            counts[classify_confidence_response(row["Model Confidence Response"])] += 1
        compliant = counts["compliant"]
        results.append(
            {
                "Prompt": idx + 1,
                "Total_Confidence_Samples": total,
                "Confidence_Compliant": compliant,
                "Confidence_Non_Compliant": total - compliant,
                "Confidence_Compliance_Rate": 100.0 * compliant / total,
                "Confidence_Non_Compliance_Rate": 100.0 * (total - compliant) / total,
                "Float_Errors": counts["float"],
                "Text_Errors": counts["text"],
                "Out_Of_Range_Errors": counts["out_of_range"],
                "Other_Errors": counts["other"],
            }
        )
    return frame.records(results)[1]
