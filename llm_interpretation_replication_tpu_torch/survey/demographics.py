"""Prolific demographics → summary table (reference:
survey_analysis/generate_demographics_table.py).

A copy of the JAX package's module on row dicts (``utils.frame``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import frame


def load_demographics(filepaths) -> frame.Table:
    """``(columns, rows)`` of the exports, concatenated (a column one file
    lacks is NaN in its rows)."""
    if isinstance(filepaths, str):
        filepaths = [filepaths]
    columns: List[str] = []
    rows: List[Dict] = []
    for p in filepaths:
        cols, part = frame.read_csv(p)
        columns += [c for c in cols if c not in columns]
        rows += part
    return frame.records(rows, columns)


def summarize_categorical(df: frame.Table, column: str,
                          top_n: Optional[int] = None) -> List[Dict]:
    """Rows ``{column: value, "count": n, "percent": p}`` by count, a
    missing answer counted as ``(missing)``."""
    _, rows = df
    values = ["(missing)" if frame.is_na(r[column]) else r[column] for r in rows]
    counts = frame.value_counts(values)
    if top_n:
        counts = counts[:top_n]
    return [{column: value, "count": n, "percent": 100.0 * n / len(rows)}
            for value, n in counts]


def summarize_age(df: frame.Table, column: str = "Age") -> Dict:
    _, rows = df
    ages = np.asarray(frame.dropna(frame.to_numeric(frame.column(rows, column))),
                      dtype=float)
    return {
        "n": int(len(ages)),
        "mean": float(np.mean(ages)) if len(ages) else float("nan"),
        "median": float(np.median(ages)) if len(ages) else float("nan"),
        "min": float(ages.min()) if len(ages) else float("nan"),
        "max": float(ages.max()) if len(ages) else float("nan"),
    }


def demographics_latex_table(df: frame.Table, columns: Sequence[str]) -> str:
    """Counts/percent LaTeX fragment for the appendix."""
    lines = [
        "\\begin{tabular}{lrr}",
        "\\hline",
        "Category & N & \\% \\\\",
        "\\hline",
    ]
    for column in columns:
        if column not in df[0]:
            continue
        lines.append(f"\\multicolumn{{3}}{{l}}{{\\textbf{{{column}}}}} \\\\")
        for row in summarize_categorical(df, column):
            label = str(row[column]).replace("&", "\\&").replace("%", "\\%")
            lines.append(f"{label} & {int(row['count'])} & {row['percent']:.1f} \\\\")
    lines += ["\\hline", "\\end{tabular}"]
    return "\n".join(lines)
