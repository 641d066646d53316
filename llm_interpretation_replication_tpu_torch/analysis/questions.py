"""Question-list loaders for the ordinary-meaning evaluation.

Rebuilds evaluate_closed_source_models.py:51-81 (first 50 prompts of the
instruct CSV + 50 parsed out of the survey-2 Qualtrics headers) and
extract_survey2_questions.py (header extraction incl. attention-check skip).

A copy of the JAX package's module on ``utils.frame.read_csv`` in place of
``pd.read_csv``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import frame


def question_from_header(text) -> Optional[str]:
    """Question text out of a Qualtrics column header: the last ``' - '``
    segment when it ends with '?' (shared by every survey-header consumer)."""
    if not isinstance(text, str) or " - " not in text:
        return None
    question = text.split(" - ")[-1].strip()
    return question if question.endswith("?") else None


def extract_survey2_questions(survey_csv: str) -> Tuple[List[str], Dict[str, str]]:
    """Unique questions (and their columns) from a Qualtrics header row,
    skipping the *_8 attention checks."""
    columns, rows = frame.read_csv(survey_csv)
    headers = rows[0]
    questions: List[str] = []
    question_to_col: Dict[str, str] = {}
    for col in columns:
        if col.startswith("Q") and "_" in col and not col.endswith("_8"):
            text = headers[col]
            if not frame.is_na(text) and isinstance(text, str) and " - " in text:
                question = text.split(" - ")[-1].strip()
                if question not in questions:
                    questions.append(question)
                    question_to_col[question] = col
    return questions, question_to_col


def load_ordinary_meaning_questions(
    instruct_csv: str,
    survey2_csv: str,
    n_part1: int = 50,
    n_part2: int = 50,
) -> List[str]:
    """First ``n_part1`` unique prompts of the instruct comparison CSV + the
    first ``n_part2`` questions parsed from the survey-2 headers (the
    reference's marker filter: columns containing 'Left = No, Right = Yes')."""
    _, rows1 = frame.read_csv(instruct_csv)
    questions: List[str] = frame.unique(frame.column(rows1, "prompt"))[:n_part1]
    survey2_columns, _ = frame.read_csv(survey2_csv, skiprows=1)
    part2: List[str] = []
    for col in survey2_columns:
        if "Left = No, Right = Yes" in col:
            q = question_from_header(col)
            if q is not None and q not in part2:
                part2.append(q)
    questions.extend(part2[:n_part2])
    return questions


def write_question_list(questions: List[str], path: str) -> None:
    with open(path, "w") as f:
        for q in questions:
            f.write(q + "\n")


def load_human_survey_means(
    part1_csv: str,
    part2_csv: str,
    return_full: bool = False,
):
    """Pooled per-question human means from BOTH survey parts, 0-1 scale
    (evaluate_closed_source_models.py:83-159).

    Unlike the preregistered survey pipeline (survey/pipeline.py), this loader
    applies NO exclusions — the closed-source comparison pools every numeric
    response under each 'Left = No, Right = Yes' column, exactly as the
    reference does; questions appearing in both parts pool across parts.
    With ``return_full`` also returns question -> list of responses.
    """
    responses: Dict[str, List[float]] = {}
    for path in (part1_csv, part2_csv):
        columns, rows = frame.read_csv(path, skiprows=1)
        for col in columns:
            if "Left = No, Right = Yes" not in col:
                continue
            question = question_from_header(col)
            if question is None:
                continue
            values = frame.dropna(frame.to_numeric(frame.column(rows, col)))
            if len(values):
                responses.setdefault(question, []).extend(
                    (np.asarray(values, dtype=float) / 100.0).tolist())
    means = {q: float(np.mean(v)) for q, v in responses.items()}
    if return_full:
        return means, responses
    return means
