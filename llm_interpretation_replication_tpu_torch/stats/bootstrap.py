"""Bootstrap machinery: MAE CIs, MAE differences, paired diffs.

Behavioral replicas with the reference's seed discipline (seed 42,
``np.random.default_rng``, percentile method):

- ``bootstrap_mae`` — evaluate_closed_source_models.py:818-850 (scipy
  ``bootstrap`` over mean absolute error).
- ``bootstrap_mae_difference`` — ibid.:852-915 (resample-index difference with
  the two-sided sign-crossing p-value).
- ``paired_mean_diff_bootstrap`` — run_base_vs_instruct_100q.py:606-712 and
  analyze_base_vs_instruct_mae_100q.py:270-420 (instruct−base paired diffs).

A copy of the JAX package's module; ``base_vs_instruct_analysis`` takes the
results' row dicts in place of a DataFrame.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import bootstrap as scipy_bootstrap

from ..utils import frame


def bootstrap_mae(
    values: Sequence[float],
    n_bootstrap: int = 10_000,
    confidence_level: float = 0.95,
    seed: int = 42,
) -> Tuple[Optional[float], Optional[float], Optional[float]]:
    """(mean, ci_low, ci_high) of the mean of ``values`` (absolute errors)."""
    values = np.asarray(list(values), dtype=float)
    if values.size == 0:
        return None, None, None
    rng = np.random.default_rng(seed)
    res = scipy_bootstrap(
        (values,),
        np.mean,
        n_resamples=n_bootstrap,
        confidence_level=confidence_level,
        random_state=rng,
        method="percentile",
    )
    return (
        float(np.mean(values)),
        float(res.confidence_interval.low),
        float(res.confidence_interval.high),
    )


def bootstrap_mae_difference(
    model_values: Sequence[float],
    baseline_values,
    n_bootstrap: int = 10_000,
    confidence_level: float = 0.95,
    seed: int = 42,
):
    """(diff, ci_low, ci_high, p) for mean(model) − mean(baseline).

    Scalar baselines broadcast; mismatched lengths collapse the baseline to its
    mean (reference semantics).  p is the doubled one-sided sign-crossing
    proportion of the bootstrap distribution.
    """
    model = np.asarray(list(model_values), dtype=float)
    if model.size == 0:
        return None, None, None, None
    if np.isscalar(baseline_values):
        baseline = np.full_like(model, float(baseline_values))
    else:
        baseline = np.asarray(list(baseline_values), dtype=float)
        if baseline.size != model.size:
            baseline = np.full_like(model, float(np.mean(baseline)))
    observed = float(np.mean(model) - np.mean(baseline))
    rng = np.random.default_rng(seed)
    n = model.size
    idx = rng.choice(n, size=(n_bootstrap, n), replace=True)
    diffs = np.mean(model[idx], axis=1) - np.mean(baseline[idx], axis=1)
    alpha = 1 - confidence_level
    ci_low = float(np.percentile(diffs, 100 * alpha / 2))
    ci_high = float(np.percentile(diffs, 100 * (1 - alpha / 2)))
    if observed > 0:
        p = 2 * min(float(np.mean(diffs <= 0)), float(np.mean(diffs >= 0)))
    else:
        p = 2 * min(float(np.mean(diffs >= 0)), float(np.mean(diffs <= 0)))
    return observed, ci_low, ci_high, min(p, 1.0)


def paired_mean_diff_bootstrap(
    diffs: Sequence[float],
    n_bootstrap: int = 10_000,
    seed: int = 42,
) -> Dict:
    """Bootstrap of a paired-difference mean (e.g. instruct − base per prompt):
    CI + two-sided p against 0."""
    diffs = np.asarray(list(diffs), dtype=float)
    diffs = diffs[np.isfinite(diffs)]
    if diffs.size == 0:
        return {"n": 0}
    rng = np.random.default_rng(seed)
    idx = rng.choice(diffs.size, size=(n_bootstrap, diffs.size), replace=True)
    boot = np.mean(diffs[idx], axis=1)
    observed = float(np.mean(diffs))
    if observed > 0:
        p = 2 * float(np.mean(boot <= 0))
    else:
        p = 2 * float(np.mean(boot >= 0))
    return {
        "n": int(diffs.size),
        "mean_diff": observed,
        "mae": float(np.mean(np.abs(diffs))),
        "ci_lower": float(np.percentile(boot, 2.5)),
        "ci_upper": float(np.percentile(boot, 97.5)),
        "p_value": min(p, 1.0),
    }


def base_vs_instruct_analysis(rows: Sequence[Dict], value_col: str = "relative_prob",
                              n_bootstrap: int = 10_000, seed: int = 42) -> Dict[str, Dict]:
    """Per-family instruct−base paired bootstrap over a 100q results frame
    (columns model_family / base_or_instruct / prompt / value_col)."""
    out: Dict[str, Dict] = {}
    for family in frame.unique(frame.column(rows, "model_family")):
        fam = [r for r in rows if r["model_family"] == family]
        base, inst = ([{"prompt": r["prompt"], value_col: r[value_col]}
                       for r in fam if r["base_or_instruct"] == role]
                      for role in ("base", "instruct"))
        merged = [r for r in frame.inner_merge(
            base, inst, "prompt", suffixes=("_base", "_instruct"))
            if not any(frame.is_na(v) for v in r.values())]
        if len(merged) < 10:
            out[family] = {"n": len(merged), "skipped": True}
            continue
        diffs = (np.asarray([r[f"{value_col}_instruct"] for r in merged], dtype=float)
                 - np.asarray([r[f"{value_col}_base"] for r in merged], dtype=float))
        out[family] = paired_mean_diff_bootstrap(diffs, n_bootstrap, seed)
    return out


def bootstrap_statistic(
    values: Sequence[float],
    statistic=np.mean,
    n_bootstrap: int = 1000,
    confidence_level: float = 0.95,
    seed: int = 42,
) -> Dict:
    """Generic percentile bootstrap of any statistic (the survey pipeline's
    helper — bootstrap_confidence_intervals.py)."""
    values = np.asarray(list(values), dtype=float)
    rng = np.random.default_rng(seed)
    idx = rng.choice(values.size, size=(n_bootstrap, values.size), replace=True)
    boots = np.array([statistic(values[row]) for row in idx])
    alpha = 1 - confidence_level
    return {
        "estimate": float(statistic(values)),
        "ci_lower": float(np.percentile(boots, 100 * alpha / 2)),
        "ci_upper": float(np.percentile(boots, 100 * (1 - alpha / 2))),
        "n": int(values.size),
    }
