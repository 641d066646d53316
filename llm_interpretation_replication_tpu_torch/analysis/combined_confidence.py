"""Three-model confidence combiner + stacked visualization.

Rebuild of combine_model_confidence_analysis.py's ``ModelConfidenceAnalyzer``
(:23-610), run_three_model_analysis.py / run_combined_confidence_analysis.py
wiring, and the stacked Figure-5/6 builders
(create_three_model_stacked_visualization.py, create_combined_visualization.py).

A copy of the JAX package's module on workbook row dicts; the combined
table is a row list in the outer merge's key order, and the stacked figure
is drawn by ``viz.figures``, imported only when it is drawn.
"""

from __future__ import annotations

import os
from itertools import combinations
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.stats import pearsonr, spearmanr

from ..utils import frame

KEYS = ["Original Main Part", "Rephrased Main Part"]


class ModelConfidenceAnalyzer:
    """Joins per-model perturbation-sweep confidence frames on
    (Original Main Part, Rephrased Main Part) and computes cross-model
    statistics."""

    def __init__(self, frames: Dict[str, List[Dict]],
                 confidence_col: str = "Confidence Value"):
        self.confidence_col = confidence_col
        self.frames = frames
        self.combined = self._combine()

    def _combine(self) -> List[Dict]:
        combined: Optional[List[Dict]] = None
        columns: List[str] = []
        for model, df in self.frames.items():
            # the reference combiner reads 'Confidence Value' unconditionally
            # (combine_model_confidence_analysis.py:52-55); fall back to the
            # weighted column only when a frame lacks it
            col = (self.confidence_col if df and self.confidence_col in df[0]
                   else "Weighted Confidence")
            name = f"confidence_{model}"
            values = frame.to_numeric(frame.column(df, col))
            sub, seen = [], set()
            for r, v in zip(df, values):
                key = tuple(r[k] for k in KEYS)
                if key not in seen:
                    seen.add(key)
                    sub.append({**dict(zip(KEYS, key)), name: v})
            columns.append(name)
            combined = sub if combined is None else _outer_merge(
                combined, sub, columns)
        if combined is None:
            return []
        return frame.records(combined, KEYS + columns)[1]

    @property
    def models(self) -> List[str]:
        return list(self.frames)

    def _values(self, rows: Sequence[Dict], model: str) -> np.ndarray:
        return np.asarray(frame.dropna(frame.column(rows, f"confidence_{model}")),
                          dtype=float)

    def summary_stats(self) -> List[Dict]:
        records = []
        scenarios = sorted(frame.unique(
            frame.dropna(frame.column(self.combined, "Original Main Part"))))
        for scenario in scenarios:
            sub = [r for r in self.combined if r["Original Main Part"] == scenario]
            for model in self.models:
                vals = self._values(sub, model)
                if not vals.size:
                    continue
                p = np.percentile(vals, [2.5, 97.5])
                records.append(
                    {
                        "scenario": scenario[:60],
                        "model": model,
                        "n": int(vals.size),
                        "mean": float(vals.mean()),
                        # ddof=1: the reference's pandas .std() convention
                        # (pinned against per_prompt_statistics.csv); a
                        # single sample has no ddof-1 std, like pandas
                        "std": float(vals.std(ddof=1)) if vals.size > 1 else float("nan"),
                        "p2_5": float(p[0]),
                        "p97_5": float(p[1]),
                        "ci_width": float(p[1] - p[0]),
                    }
                )
        return records

    def cross_model_correlations(self) -> List[Dict]:
        rows = []
        for a, b in combinations(self.models, 2):
            pairs = [(r[f"confidence_{a}"], r[f"confidence_{b}"])
                     for r in self.combined]
            pairs = [p for p in pairs if not (frame.is_na(p[0]) or frame.is_na(p[1]))]
            if len(pairs) < 3:
                continue
            x, y = np.asarray(pairs, dtype=float).T
            pr, pp = pearsonr(x, y)
            sr, sp = spearmanr(x, y)
            rows.append(
                {
                    "model_1": a, "model_2": b, "n": len(pairs),
                    "pearson_r": float(pr), "pearson_p": float(pp),
                    "spearman_r": float(sr), "spearman_p": float(sp),
                }
            )
        return rows

    def latex_summary(self) -> str:
        stats = self.summary_stats()
        lines = [
            "\\begin{tabular}{llrrrr}",
            "\\hline",
            "Scenario & Model & N & Mean & Std & CI width \\\\",
            "\\hline",
        ]
        for row in stats:
            lines.append(
                f"{row['scenario'][:30]}... & {row['model']} & {row['n']} & "
                f"{row['mean']:.1f} & {row['std']:.1f} & {row['ci_width']:.1f} \\\\"
            )
        lines += ["\\hline", "\\end{tabular}"]
        return "\n".join(lines)

    def stacked_visualization(self, output_path: str, scenarios: Optional[Sequence[str]] = None):
        """One jitter-strip panel per model, stacked (Fig. 5/6 style)."""
        from ..viz import figures

        scenario_keys = scenarios or frame.unique(
            frame.column(self.combined, "Original Main Part"))
        values = {
            model: [self._values([r for r in self.combined
                                  if r["Original Main Part"] == s], model)
                    for s in scenario_keys]
            for model in self.models
        }
        return figures.stacked_confidence_strips(values, len(scenario_keys),
                                                 output_path)


def _outer_merge(left: List[Dict], right: List[Dict],
                 columns: List[str]) -> List[Dict]:
    """``left.merge(right, on=KEYS, how="outer")`` for keys unique on each
    side: every key once, in sorted order, a side's missing values NaN."""
    by_key: Dict = {}
    for r in left + right:
        key = tuple(r[k] for k in KEYS)
        row = by_key.setdefault(key, {**dict(zip(KEYS, key)),
                                      **{c: frame.NAN for c in columns}})
        row.update({c: v for c, v in r.items() if c not in KEYS})
    return [by_key[k] for k in sorted(by_key)]


def run_combined_analysis(frames: Dict[str, List[Dict]], output_dir: str,
                          confidence_col: str = "Confidence Value") -> Dict:
    os.makedirs(output_dir, exist_ok=True)
    analyzer = ModelConfidenceAnalyzer(frames, confidence_col=confidence_col)
    stats = analyzer.summary_stats()
    corr = analyzer.cross_model_correlations()
    frame.write_csv(*frame.records(stats),
                 os.path.join(output_dir, "combined_confidence_stats.csv"))
    frame.write_csv(*frame.records(corr),
                 os.path.join(output_dir, "cross_model_correlations.csv"))
    with open(os.path.join(output_dir, "combined_tables.tex"), "w") as f:
        f.write(analyzer.latex_summary())
    fig_path = analyzer.stacked_visualization(
        os.path.join(output_dir, "stacked_confidence.png")
    )
    return {
        "stats": stats,
        "correlations": corr,
        "figure": fig_path,
        "combined": analyzer.combined,
    }
