"""Power analysis: analytic sample-size requirements + simulated power.

Behavioral replica of power_analysis.py:10-95 (one-sample t-test framing over
MAE differences from a baseline, with the t-correction and safety margin, and
seeded Monte-Carlo power curves).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
from scipy import stats as scipy_stats

POWER_LEVELS = (0.70, 0.80, 0.85, 0.90, 0.95)


def required_sample_size(
    observed_mae_diff: float,
    observed_std: float,
    alpha: float = 0.05,
    margin_factor: float = 1.5,
    power_levels: Sequence[float] = POWER_LEVELS,
) -> Dict:
    effect_size = abs(observed_mae_diff) / observed_std if observed_std > 0 else 0.0
    sample_sizes = {}
    for target_power in power_levels:
        key = f"power_{int(target_power * 100)}"
        if effect_size > 0:
            z_alpha = scipy_stats.norm.ppf(1 - alpha / 2)
            z_beta = scipy_stats.norm.ppf(target_power)
            n = ((z_alpha + z_beta) / effect_size) ** 2
            if n > 2:
                n = n * (1 + 1 / (4 * (n - 1)))  # t-distribution correction
            sample_sizes[key] = {
                "raw": int(np.ceil(n)),
                "with_margin": int(np.ceil(n * margin_factor)),
            }
        else:
            sample_sizes[key] = {"raw": np.inf, "with_margin": np.inf}
    return {
        "effect_size": effect_size,
        "sample_sizes": sample_sizes,
        "observed_mae_diff": observed_mae_diff,
        "observed_std": observed_std,
    }


def simulated_power(
    mae_diff: float,
    std: float,
    sample_size: int,
    n_simulations: int = 10_000,
    alpha: float = 0.05,
    seed: int = 42,
) -> float:
    """Proportion of seeded simulations where a one-sample t-test vs 0 rejects."""
    rng = np.random.default_rng(seed)
    samples = rng.normal(mae_diff, std, size=(n_simulations, sample_size))
    _, p = scipy_stats.ttest_1samp(samples, 0.0, axis=1)
    return float(np.mean(p < alpha))


def power_curve(
    mae_diff: float,
    std: float,
    sample_sizes: Sequence[int],
    n_simulations: int = 2000,
    alpha: float = 0.05,
    seed: int = 42,
) -> Dict[int, float]:
    return {
        int(n): simulated_power(mae_diff, std, int(n), n_simulations, alpha, seed)
        for n in sample_sizes
    }


def power_report(
    model_results: Dict[str, Dict],
    baseline_mae: float,
    sample_size: int,
    alpha: float = 0.05,
    n_simulations: int = 10_000,
    output_tex: str = None,
) -> Dict:
    """Full power-analysis report (power_analysis.py `main`, :96-278).

    ``model_results`` maps model name -> {"mae", "mae_std", "mae_diff",
    "ci_lower", "ci_upper"}.  Computes per-model effect sizes, required
    sample sizes at every power level, simulated power at the current
    ``sample_size``, and the 80%/90%-power recommendation (the max over
    models, i.e. the smallest effect is the limiting factor).  Optionally
    writes a LaTeX table (``power_analysis_report.tex``).
    """
    report: Dict = {"models": {}, "baseline_mae": baseline_mae,
                    "sample_size": sample_size}
    for name, res in model_results.items():
        analysis = required_sample_size(
            res["mae_diff"], res["mae_std"], alpha=alpha
        )
        analysis["achieved_power"] = simulated_power(
            res["mae_diff"], res["mae_std"], sample_size,
            n_simulations=n_simulations, alpha=alpha,
        )
        analysis["significant"] = not (
            res.get("ci_lower", -np.inf) <= 0 <= res.get("ci_upper", np.inf)
        )
        report["models"][name] = analysis

    def _max_required(level: str):
        best_n, best_margin, limiting = 0, 0, None
        for name, analysis in report["models"].items():
            sizes = analysis["sample_sizes"][level]
            if sizes["raw"] > best_n:
                best_n, best_margin, limiting = sizes["raw"], sizes["with_margin"], name
        # a zero-effect model keeps raw=inf: no N can power it, and the
        # recommendation must say so rather than silently dropping the model
        return {"raw": best_n, "with_margin": best_margin, "limiting_model": limiting}

    report["recommendation"] = {
        "power_80": _max_required("power_80"),
        "power_90": _max_required("power_90"),
    }

    if output_tex:
        from ..viz.latex import power_analysis_table

        with open(output_tex, "w") as f:
            f.write(power_analysis_table(report, alpha=alpha,
                                         sample_size=sample_size))
        report["tex_path"] = output_tex
    return report
