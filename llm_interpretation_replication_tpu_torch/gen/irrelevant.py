"""The irrelevant-statement perturbation generator (a copy of the JAX
package's ``gen/irrelevant.py``).

Each scenario is split into sentences on ``(?<=\\.)\\s+`` and each of the
200 statements is inserted at every position (the beginning and after each
sentence).  The output is the ``perturbations_irrelevant.json`` schema: per
scenario ``{scenario_name, original_main, response_format, target_tokens,
confidence_format, perturbations_with_irrelevant: [{perturbation_id,
irrelevant_statement, position_index, position_description,
perturbed_text}]}``, 400/400/600/1000/1000 = 3,400 perturbations for the
study's scenarios.
"""

from __future__ import annotations

import json
import re
from typing import List, Optional, Sequence


def split_sentences(text: str) -> List[str]:
    """Period-boundary sentence split; every returned sentence ends with '.'"""
    parts = re.split(r"(?<=\.)\s+", text)
    out = []
    for s in parts:
        s = s.strip()
        if not s:
            continue
        if not s.endswith("."):
            s += "."
        out.append(s)
    return out


def num_insertion_positions(text: str) -> int:
    """Beginning + after each sentence."""
    return len([s for s in re.split(r"(?<=\.)\s+", text) if s.strip()]) + 1


def insert_statement(text: str, statement: str, position_index: int) -> str:
    sentences = split_sentences(text)
    if not statement.endswith("."):
        statement += "."
    if position_index <= len(sentences):
        sentences.insert(position_index, statement)
    else:
        sentences.append(statement)
    return " ".join(sentences)


def position_description(position_index: int, num_positions: int) -> str:
    if position_index == 0:
        return "beginning"
    if position_index == num_positions - 1:
        return "end"
    return f"after_sentence_{position_index}"


def generate_perturbations(
    scenarios: Sequence[dict],
    statements: Sequence[str],
    max_per_scenario: Optional[int] = None,
) -> List[dict]:
    """All (position × statement) insertions per scenario, ids starting at
    1, in the order and with the names of ``perturbations_irrelevant.json``."""
    out = []
    for scenario in scenarios:
        main = scenario.get("main") or scenario["original_main"]
        n_positions = num_insertion_positions(main)
        perturbations = []
        pid = 1
        for pos in range(n_positions):
            for statement in statements:
                perturbations.append(
                    {
                        "perturbation_id": pid,
                        "irrelevant_statement": statement,
                        "position_index": pos,
                        "position_description": position_description(pos, n_positions),
                        "perturbed_text": insert_statement(main, statement, pos),
                    }
                )
                pid += 1
                if max_per_scenario and pid > max_per_scenario:
                    break
            if max_per_scenario and pid > max_per_scenario:
                break
        out.append(
            {
                "scenario_name": scenario.get("name") or scenario.get("scenario_name", ""),
                "original_main": main,
                "response_format": scenario["response_format"],
                "target_tokens": scenario["target_tokens"],
                "confidence_format": scenario["confidence_format"],
                "perturbations_with_irrelevant": perturbations,
            }
        )
    return out


def save_perturbations(perturbed: Sequence[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(list(perturbed), f, indent=2)


def readable_dump(perturbed: Sequence[dict], generated_at: str = "") -> str:
    """The human-readable companion of the JSON, line for line the JAX
    package's layout.

    ``generated_at`` fills the ``Generated:`` timestamp line; it is a
    parameter so that tests and reproducible builds need no clock.
    """
    lines = [
        "PERTURBATIONS WITH IRRELEVANT STATEMENTS",
        "=" * 80,
        f"Generated: {generated_at}",
        f"Total scenarios: {len(perturbed)}",
        f"Total perturbations: "
        f"{sum(len(p['perturbations_with_irrelevant']) for p in perturbed)}",
    ]
    for p in perturbed:
        lines.append(f"  {p['scenario_name']}: "
                     f"{len(p['perturbations_with_irrelevant'])} perturbations")
    lines += ["=" * 80, ""]
    for scenario in perturbed:
        lines += [
            "",
            f"SCENARIO: {scenario['scenario_name']}",
            "-" * 60,
            f"ORIGINAL:\n{scenario['original_main']}",
            "",
            f"RESPONSE FORMAT: {scenario['response_format']}",
            f"TARGET TOKENS: {scenario['target_tokens']}",
            "-" * 60,
        ]
        for pert in scenario["perturbations_with_irrelevant"]:
            lines += [
                "",
                f"Perturbation #{pert['perturbation_id']}:",
                f"Irrelevant Statement: {pert['irrelevant_statement']}",
                f"Position: {pert['position_description']} "
                f"(index: {pert['position_index']})",
                f"Perturbed Text:\n{pert['perturbed_text']}",
                "-" * 40,
            ]
        lines += ["", "=" * 80]
    return "\n".join(lines) + "\n"


def save_readable(perturbed: Sequence[dict], path: str,
                  generated_at: str = "") -> None:
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(readable_dump(perturbed, generated_at))


def load_perturbations(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)
