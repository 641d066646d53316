"""Ordinary-meaning evaluation of frontier API models (100 questions).

Rebuild of evaluate_closed_source_models.py:602-2110: per question run the
GPT/Gemini/Claude evaluators (binary + confidence) plus the random baseline,
cache every response with completeness checking and partial re-runs, write the
per-question results CSV (§2.8 schema), then compute correlations, MAE vs the
human survey with bootstrap CIs, the Always-50 and N(μ,σ) baselines, MAE
difference p-values, LaTeX tables, and the heatmap/error-strip figures.

A copy of the JAX package's module on row dicts and ``utils.frame`` in place
of pandas: the results are a list of dicts, one a question, each holding
every column of ``RESULT_COLUMNS`` typed as ``pd.DataFrame`` types them.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
from scipy.stats import pearsonr, spearmanr

from ..api_backends.cache import ResponseCache
from ..api_backends.evaluators import (
    evaluate_claude,
    evaluate_gemini_binary,
    evaluate_gemini_confidence,
    evaluate_gpt_binary,
    evaluate_gpt_confidence,
    evaluate_random_baseline,
)
from ..stats.bootstrap import bootstrap_mae, bootstrap_mae_difference
from ..utils import frame
from ..viz import latex

#: per-vendor pause after EACH API call (reference GPT_DELAY/GEMINI_DELAY/
#: CLAUDE_DELAY, evaluate_closed_source_models.py:39-41); single source for
#: both the evaluation loop and the orchestrator's wall-time estimate.
DEFAULT_SLEEPS = {"gpt": 0.5, "gemini": 6.0, "claude": 1.0}

#: evaluator names in the human comparison (order = report row order)
MODEL_NAMES = ("GPT", "Gemini", "Claude", "Random")

RESULT_COLUMNS = [
    "question",
    "gpt_response", "gpt_yes_prob", "gpt_no_prob", "gpt_relative_prob",
    "gpt_confidence", "gpt_weighted_confidence",
    "gemini_response", "gemini_yes_prob", "gemini_no_prob", "gemini_relative_prob",
    "gemini_confidence", "gemini_weighted_confidence",
    "claude_response", "claude_confidence",
    "random_response", "random_relative_prob", "random_confidence",
]

RESULTS_CSV = "closed_source_evaluation_results.csv"


def evaluate_all_models(
    questions: Sequence[str],
    gpt_client=None, gpt_model: str = "gpt-4-0125-preview",
    gemini_client=None, gemini_model: str = "gemini-2.0-flash-exp",
    claude_client=None, claude_model: str = "claude-opus-4-1-20250805",
    cache: Optional[ResponseCache] = None,
    rng: Optional[np.random.Generator] = None,
    intermediate_csv: Optional[str] = None,
    intermediate_every: int = 10,
    sleep: Callable[[float], None] = lambda s: None,
    sleeps: Dict[str, float] = None,
) -> List[Dict]:
    """The per-question evaluation loop with cache + partial re-runs; one
    row dict a question holding every column of ``RESULT_COLUMNS``."""
    # NOTE: explicit None check — an empty ResponseCache is falsy (__len__==0)
    cache = ResponseCache() if cache is None else cache
    rng = np.random.default_rng(42) if rng is None else rng
    sleeps = sleeps or DEFAULT_SLEEPS
    rows: List[Dict] = []
    for qi, question in enumerate(questions):
        record = dict(cache.get(question) or {})
        missing = cache.missing_evaluators(question)
        if "gpt" in missing and gpt_client is not None:
            b = evaluate_gpt_binary(gpt_client, gpt_model, question)
            sleep(sleeps["gpt"])
            c = evaluate_gpt_confidence(gpt_client, gpt_model, question)
            record.update(
                gpt_response=b["response"], gpt_yes_prob=b["yes_prob"],
                gpt_no_prob=b["no_prob"], gpt_relative_prob=b["relative_prob"],
                gpt_confidence=c["confidence"],
                gpt_weighted_confidence=c["weighted_confidence"],
            )
            sleep(sleeps["gpt"])
        if "gemini" in missing and gemini_client is not None:
            b = evaluate_gemini_binary(gemini_client, gemini_model, question)
            sleep(sleeps["gemini"])
            c = evaluate_gemini_confidence(gemini_client, gemini_model, question)
            record.update(
                gemini_response=b["response"], gemini_yes_prob=b["yes_prob"],
                gemini_no_prob=b["no_prob"], gemini_relative_prob=b["relative_prob"],
                gemini_confidence=c["confidence"],
                gemini_weighted_confidence=c["weighted_confidence"],
            )
            sleep(sleeps["gemini"])
        if "claude" in missing and claude_client is not None:
            c = evaluate_claude(claude_client, claude_model, question,
                                sleep=sleep, delay=sleeps["claude"])
            record.update(claude_response=c["response"], claude_confidence=c["confidence"])
            sleep(sleeps["claude"])
        if "random" in missing:
            r = evaluate_random_baseline(rng)
            record.update(
                random_response=r["response"],
                random_relative_prob=r["relative_prob"],
                random_confidence=r["confidence"],
            )
        cache.put(question, record)
        rows.append({"question": question, **record})
        if intermediate_csv and (qi + 1) % intermediate_every == 0:
            frame.write_csv(*frame.records(rows), intermediate_csv)
    return frame.records(rows, RESULT_COLUMNS)[1]


def _numeric_column(rows: Sequence[Dict], col: str) -> List:
    return frame.to_numeric([r[col] for r in rows])


def calculate_correlations(rows: Sequence[Dict]) -> Dict:
    """Pairwise correlations between model relative probabilities /
    confidences (reference :788-816)."""
    out: Dict = {}
    pairs = [
        ("gpt_relative_prob", "gemini_relative_prob"),
        ("gpt_confidence", "gemini_confidence"),
        ("gpt_confidence", "claude_confidence"),
        ("gemini_confidence", "claude_confidence"),
    ]
    columns = set(rows[0]) if rows else set()
    for a, b in pairs:
        if a not in columns or b not in columns:
            continue
        both = [(x, y) for x, y in zip(_numeric_column(rows, a),
                                       _numeric_column(rows, b))
                if not (frame.is_na(x) or frame.is_na(y))]
        if len(both) < 3:
            continue
        xs = np.asarray([x for x, _ in both])
        ys = np.asarray([y for _, y in both])
        pr, pp = pearsonr(xs, ys)
        sr, sp = spearmanr(xs, ys)
        out[f"{a}__{b}"] = {
            "pearson": float(pr), "pearson_p": float(pp),
            "spearman": float(sr), "spearman_p": float(sp), "n": len(both),
        }
    return out


def compare_with_human_data(
    rows: Sequence[Dict],
    human_means: Dict[str, float],          # question text -> mean in [0,1]
    human_std: Optional[float] = None,
    n_bootstrap: int = 10_000,
    seed: int = 42,
) -> Dict:
    """MAE vs human mean + baselines + paired difference tests, mirroring
    evaluate_closed_source_models.py:985-1135 exactly (the JAX package
    pins it to the paper's Table 3/4):

    - model prediction = verbalized WEIGHTED confidence / 100 for GPT/Gemini
      (fallback to plain confidence when weighted is NaN); plain
      confidence / 100 for Claude and the random evaluator (:1024-1035);
    - questions match by SUBSTRING in either direction, first hit in dict
      order (:1016-1018);
    - top-level Equanimity (always-0.5) and N(mu,sigma) baselines run over
      ALL survey questions (:917-983); per-model difference tests re-derive
      both baselines over that model's matched questions only (:1060-1099);
    - the Normal baseline replays the reference's legacy global-seed RNG
      (np.random.seed(43), N(mu*100, sigma*100), clip to [0,100], /100) so
      its draws are bit-identical;
    - mu/sigma come from ALL question means (sigma overridable via
      ``human_std``).
    """
    def match(question: str) -> Optional[float]:
        for hq, hv in human_means.items():
            if question in hq or hq in question:
                return hv
        return None

    def numeric(v):
        return frame.to_numeric([v])[0]

    def model_value(row, name: str):
        key = name.lower()
        if name in ("Claude", "Random"):
            return numeric(row.get(f"{key}_confidence"))
        v = numeric(row.get(f"{key}_weighted_confidence"))
        if frame.is_na(v):
            v = numeric(row.get(f"{key}_confidence"))
        return v

    errors: Dict[str, List[float]] = {}
    pairs: Dict[str, List[tuple]] = {}   # name -> [(prediction, human mean)]
    paired_h: Dict[str, List[float]] = {}
    # row-aligned error matrix for per-question figures: one slot per
    # matched row per model, NaN when that model had no parseable value (the
    # stats vectors above skip instead — they must stay dense for bootstrap)
    errors_aligned: Dict[str, List[float]] = {n: [] for n in MODEL_NAMES}
    matched_questions: List[str] = []
    for row in rows:
        h = match(str(row["question"]))
        if h is None:
            continue
        matched_questions.append(str(row["question"]))
        for name in MODEL_NAMES:
            v = model_value(row, name)
            if not frame.is_na(v):
                pred = float(v) / 100.0
                errors.setdefault(name, []).append(abs(pred - h))
                pairs.setdefault(name, []).append((pred, h))
                paired_h.setdefault(name, []).append(h)
                errors_aligned[name].append(abs(pred - h))
            else:
                errors_aligned[name].append(float("nan"))

    all_h = list(human_means.values())
    mu = float(np.mean(all_h)) if all_h else 0.5
    sigma = float(human_std) if human_std is not None else float(np.std(all_h))

    def normal_draws(count: int) -> List[float]:
        # legacy global-RNG replay: np.random.seed(43) + sequential normals
        legacy = np.random.RandomState(43)
        return [
            float(np.clip(legacy.normal(mu * 100, sigma * 100), 0, 100) / 100.0)
            for _ in range(count)
        ]

    errors["Equanimity"] = [abs(0.5 - h) for h in all_h]
    if all_h:
        errors["Normal"] = [abs(d - h) for d, h in zip(normal_draws(len(all_h)), all_h)]

    results: Dict = {"mae": {}, "differences": {}}
    for name, errs in errors.items():
        mean, lo, hi = bootstrap_mae(errs, n_bootstrap=n_bootstrap, seed=seed)
        record = {"mae": mean, "ci_lower": lo, "ci_upper": hi, "n": len(errs)}
        pred_h = pairs.get(name, [])
        if len(pred_h) >= 3 and np.std([p for p, _ in pred_h]) > 0 and np.std(
            [hh for _, hh in pred_h]
        ) > 0:
            r, p = pearsonr([p for p, _ in pred_h], [hh for _, hh in pred_h])
            record.update(correlation=float(r), p_value=float(p),
                          n_matched=len(pred_h))
        results["mae"][name] = record
    if "Normal" in results["mae"] and all_h:
        results["mae"]["Normal"].update(human_mean=mu, human_std=sigma)

    for name in ("GPT", "Claude", "Gemini"):
        if name not in errors:
            continue
        hs = paired_h[name]
        baselines = {"Equanimity": [abs(0.5 - h) for h in hs],
                     "Normal": [abs(d - h) for d, h in zip(normal_draws(len(hs)), hs)]}
        if "Random" in errors:
            baselines["Random"] = errors["Random"]
        diffs = {}
        for baseline, base_errs in baselines.items():
            d, lo, hi, p = bootstrap_mae_difference(
                errors[name], base_errs, n_bootstrap=n_bootstrap, seed=seed
            )
            diffs[baseline] = {"diff": d, "ci_lower": lo, "ci_upper": hi, "p_value": p}
        results["differences"][name] = diffs
    results["errors"] = errors
    results["errors_aligned"] = {
        k: v for k, v in errors_aligned.items() if np.isfinite(v).any()
    }
    results["matched_questions"] = matched_questions
    return results


def write_report(
    rows: Sequence[Dict],
    comparisons: Dict,
    correlations: Dict,
    output_dir: str,
    columns: Sequence[str] = RESULT_COLUMNS,
) -> Dict[str, str]:
    """CSV + LaTeX tables + heatmap/error-strip figures; ``columns`` are
    the CSV's (a loaded results file's own)."""
    os.makedirs(output_dir, exist_ok=True)
    paths = {}
    csv_path = os.path.join(output_dir, RESULTS_CSV)
    frame.write_csv(columns, rows, csv_path)
    paths["csv"] = csv_path
    tex = latex.mae_results_tables(comparisons["mae"], comparisons["differences"])
    tex_path = os.path.join(output_dir, "mae_results_tables.tex")
    with open(tex_path, "w") as f:
        f.write(tex)
    paths["latex"] = tex_path
    paths.update(_figures(rows, comparisons, correlations, output_dir))
    with open(os.path.join(output_dir, "correlations.json"), "w") as f:
        json.dump(correlations, f, indent=2)
    with open(os.path.join(output_dir, "human_comparisons.json"), "w") as f:
        json.dump(
            {k: v for k, v in comparisons.items() if k != "errors"}, f, indent=2,
            default=float,
        )
    return paths


def _figures(rows, comparisons: Dict, correlations: Dict,
             output_dir: str) -> Dict[str, str]:
    from ..viz import figures

    paths = {}
    # Per-question figures use the NaN-padded row-aligned matrix so every
    # column is the same question for every model (the dense stats vectors
    # shift when a model skips a question; the all-questions baselines are
    # in human_means order and excluded from these figures entirely).
    errors = comparisons.get("errors_aligned") or {
        k: v for k, v in comparisons.get("errors", {}).items() if k in MODEL_NAMES
    }
    if errors:
        paths["error_strip"] = figures.per_question_error_strip(
            errors, "Per-question absolute error vs human mean",
            os.path.join(output_dir, "per_question_errors.png"),
        )
        names = [n for n in errors if len(errors[n])]
        if names:
            width = min(len(errors[n]) for n in names)
            mat = np.array([list(errors[n])[:width] for n in names])
            paths["heatmap"] = figures.mae_heatmap(
                mat, names, [f"q{i + 1}" for i in range(width)],
                "Absolute error heatmap", os.path.join(output_dir, "mae_heatmap.png"),
            )
    mae = comparisons.get("mae", {})
    if mae:
        dashboard_input = {
            "models": {k: v for k, v in mae.items()
                       if k in ("GPT", "Gemini", "Claude")},
            "baselines": {
                key: mae[name]
                for key, name in (("always_50", "Equanimity"), ("normal_human", "Normal"))
                if name in mae
            },
        }
        paths["dashboard"] = figures.model_comparison_dashboard(
            rows, correlations, dashboard_input,
            os.path.join(output_dir, "model_comparison_plots.png"),
        )
        paths["mae_comparison"] = figures.mae_comparison_bar(
            dashboard_input, os.path.join(output_dir, "mae_comparison.png"),
        )
    return paths


def run_closed_source_evaluation(
    questions: Sequence[str],
    output_dir: str,
    human_means: Optional[Dict[str, float]] = None,
    human_std: Optional[float] = None,
    cache_file: Optional[str] = None,
    confirm_fn: Optional[Callable[[str], bool]] = None,
    log: Callable[[str], None] = print,
    **eval_kwargs,
) -> Optional[List[Dict]]:
    """The reference main()'s orchestration shell (:1902-2110).

    Short-circuits to ``closed_source_evaluation_results.csv`` when a previous
    run finished; otherwise reports how many questions the cache already
    covers, and for the remainder estimates API-call count and wall time from
    the per-vendor sleeps and gates on ``confirm_fn`` (the reference's
    interactive "Proceed with evaluation? (yes/no)" prompt, :1938-1942; pass
    None to skip, e.g. under ``--yes``).  Returns the result rows, or None
    when the user declines.
    """
    saved = os.path.join(output_dir, RESULTS_CSV)
    columns: Sequence[str] = RESULT_COLUMNS
    if os.path.exists(saved):
        log(f"Loading existing results from {saved}")
        columns, rows = frame.read_csv(saved)
    else:
        cache = ResponseCache(cache_file) if cache_file else ResponseCache()
        done = sum(1 for q in questions if cache.is_complete(q))
        fresh = len(questions) - done
        if done:
            log(f"Cache mode: ENABLED ({done}/{len(questions)} questions "
                f"complete in {cache_file})")
        vendors_configured = [v for v in ("gpt", "gemini", "claude")
                              if eval_kwargs.get(f"{v}_client") is not None]
        if fresh and vendors_configured:
            sleeps = eval_kwargs.get("sleeps") or DEFAULT_SLEEPS
            # 2 calls (binary + confidence) per CONFIGURED vendor per
            # question, one sleep after each call — mirrors the loop exactly
            calls = fresh * 2 * len(vendors_configured)
            minutes = fresh * 2 * sum(sleeps[v] for v in vendors_configured) / 60.0
            log(f"Estimated processing time: {minutes:.1f} minutes")
            log(f"Total API calls: {calls}")
            if confirm_fn is not None and not confirm_fn(
                "Proceed with evaluation? (yes/no): "
            ):
                log("Evaluation cancelled.")
                return None
        rows = evaluate_all_models(questions, cache=cache, **eval_kwargs)
    correlations = calculate_correlations(rows)
    comparisons = (
        compare_with_human_data(rows, human_means, human_std)
        if human_means else {"mae": {}, "differences": {}, "errors": {}}
    )
    write_report(rows, comparisons, correlations, output_dir, columns)
    return rows
