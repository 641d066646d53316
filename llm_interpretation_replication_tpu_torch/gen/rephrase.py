"""Rephrasing generation for the prompt-sensitivity study (a copy of the
JAX package's ``gen/rephrase.py``): per scenario, N sessions of "rephrase
in 20 variations", a numbered-list parser that joins continuation lines,
and the ``perturbations.json`` schema with its identity check on reload.

The model call is a ``complete(prompt) -> str`` callable, so any backend
(``api_backends.AnthropicClient``, a local model, a test fake) can drive
generation.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Sequence

REPHRASE_TEMPLATE = (
    'Here is a question:\n###"{main_prompt}"###\n'
    "Please rephrase this question in 20 variations that differ from the "
    "original question but preserve the substance of the question. Each "
    "rephrasing should be a complete question, not just a fragment of a "
    "question. Number each rephrasing from 1 to 20."
)


def parse_numbered_rephrasings(text: str) -> List[str]:
    """Parse a numbered list; unnumbered lines continue the previous entry."""
    out: List[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.lower().startswith("here are"):
            continue
        if line[0].isdigit():
            parts = line.split(".", 1)
            if len(parts) > 1:
                rephrase = parts[1].strip()
            else:
                rephrase = line.lstrip("0123456789").strip(" .-\t")
            out.append(rephrase)
        elif out:
            out[-1] += " " + line
        else:
            out.append(line)
    return out


def generate_rephrasings(
    scenarios: Sequence[dict],
    complete: Callable[[str], str],
    sessions_per_scenario: int = 100,
    target_per_scenario: int = 2000,
    on_error: Optional[Callable[[int, Exception], None]] = None,
) -> List[dict]:
    """Run the generation loop; returns the perturbations.json records."""
    results = []
    for scenario in scenarios:
        main = scenario["original_main"]
        prompt = REPHRASE_TEMPLATE.format(main_prompt=main)
        rephrasings: List[str] = []
        for session in range(sessions_per_scenario):
            if len(rephrasings) >= target_per_scenario:
                break
            try:
                rephrasings.extend(parse_numbered_rephrasings(complete(prompt)))
            except Exception as err:  # sweep continues past broken sessions
                if on_error:
                    on_error(session, err)
        results.append(
            {
                "original_main": main,
                "response_format": scenario["response_format"],
                "target_tokens": list(scenario["target_tokens"]),
                "confidence_format": scenario["confidence_format"],
                "rephrasings": rephrasings[:target_per_scenario],
            }
        )
    return results


def save_perturbations(records: Sequence[dict], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(list(records), f, indent=2, ensure_ascii=False)


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
