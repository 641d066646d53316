"""The perturbation file loader (a copy of ``gen/rephrase.py``'s
``load_perturbations``)."""

from __future__ import annotations

import json
from typing import List, Optional, Sequence


def load_perturbations(path: str, expected_scenarios: Optional[Sequence[dict]] = None) -> List[dict]:
    """Load with the study's identity check: the saved original_main,
    response_format, target_tokens and confidence_format must match the
    current scenario definitions, or a reload would mix prompts."""
    with open(path, encoding="utf-8") as f:
        records = json.load(f)
    if expected_scenarios is not None:
        if len(records) != len(expected_scenarios):
            raise ValueError(
                f"perturbation file has {len(records)} scenarios, expected {len(expected_scenarios)}"
            )
        for rec, scen in zip(records, expected_scenarios):
            for key in ("original_main", "response_format", "confidence_format"):
                if rec[key] != scen[key]:
                    raise ValueError(f"scenario mismatch on {key!r}: reload would mix prompts")
            if list(rec["target_tokens"]) != list(scen["target_tokens"]):
                raise ValueError("scenario mismatch on target_tokens")
    return records
