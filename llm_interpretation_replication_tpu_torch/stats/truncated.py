"""Zero/one-inflated clipped-normal fit with Monte-Carlo adequacy tests.

Behavioral replica of analyze_perturbation_results.py:113-337: find (μ, σ) of
an underlying normal whose [0,1]-clipped version matches the observed mean/std
(damped iterative search, max 30 iterations, 1e-4 convergence, direct mean
shift), with a scipy ``truncnorm`` alternative when the relative error stays
above 1%; adequacy via two-sample KS and k-sample Anderson-Darling against
100k simulated draws.

Improvement over the reference: an explicit seeded Generator instead of global
numpy state, so fits are reproducible.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy import stats as scipy_stats

EPSILON = 1e-6


def simulate_clipped_normal(rng, mu: float, sigma: float, n: int) -> np.ndarray:
    return np.clip(rng.normal(mu, sigma, n), 0.0, 1.0)


def fit_clipped_normal(
    values,
    n_simulations: int = 100_000,
    seed: int = 42,
    max_iterations: int = 30,
    convergence_threshold: float = 1e-4,
    damping: float = 0.5,
) -> Tuple[Dict, np.ndarray]:
    """Fit + test; returns (results dict, simulated draws)."""
    values = np.asarray(values, dtype=float)
    values = values[np.isfinite(values)]
    if len(values) == 0:
        return {"fit": "failed-no-finite-values"}, np.array([])

    n_zeros = int(np.sum(values < EPSILON))
    n_ones = int(np.sum(values > 1 - EPSILON))
    zero_prop = n_zeros / len(values)
    one_prop = n_ones / len(values)
    interior = values[(values >= EPSILON) & (values <= 1 - EPSILON)]
    if len(interior) == 0:
        return (
            {
                "fit": "failed-all-boundary",
                "zero_proportion": zero_prop,
                "one_proportion": one_prop,
            },
            np.array([]),
        )

    target_mean = float(np.mean(values))
    target_std = float(np.std(values))
    rng = np.random.default_rng(seed)
    mu, sigma = target_mean, target_std

    for _ in range(max_iterations):
        sim = simulate_clipped_normal(rng, mu, sigma, n_simulations)
        sim_mean, sim_std = float(np.mean(sim)), float(np.std(sim))
        mean_diff = abs(sim_mean - target_mean)
        std_diff = abs(sim_std - target_std)
        if mean_diff < convergence_threshold and std_diff < convergence_threshold:
            break
        mean_adj = (target_mean / sim_mean) if sim_mean > 0 else 1.0
        std_adj = (target_std / sim_std) if sim_std > 0 else 1.0
        mu *= 1 + damping * (mean_adj - 1)
        sigma *= 1 + damping * (std_adj - 1)
        if mean_diff > 1e-3:
            mu += damping * (target_mean - sim_mean)

    simulated = simulate_clipped_normal(rng, mu, sigma, n_simulations)
    sim_mean, sim_std = float(np.mean(simulated)), float(np.std(simulated))
    mean_err = abs(sim_mean - target_mean) / target_mean if target_mean else abs(sim_mean)
    std_err = abs(sim_std - target_std) / target_std if target_std else abs(sim_std)

    if mean_err > 0.01 or std_err > 0.01:
        # scipy truncnorm alternative (truncates instead of clipping — no
        # boundary atoms, but sometimes matches moments better)
        try:
            a = (0 - mu) / sigma
            b = (1 - mu) / sigma
            alt = scipy_stats.truncnorm.rvs(
                a, b, loc=mu, scale=sigma, size=n_simulations, random_state=rng
            )
            alt_mean, alt_std = float(np.mean(alt)), float(np.std(alt))
            alt_mean_err = abs(alt_mean - target_mean) / target_mean if target_mean else abs(alt_mean)
            alt_std_err = abs(alt_std - target_std) / target_std if target_std else abs(alt_std)
            if alt_mean_err < mean_err and alt_std_err < std_err:
                simulated, sim_mean, sim_std = alt, alt_mean, alt_std
                mean_err, std_err = alt_mean_err, alt_std_err
        except Exception:
            pass

    ks_stat, ks_p = scipy_stats.ks_2samp(values, simulated)
    try:
        ad = scipy_stats.anderson_ksamp([values, simulated])
        ad_stat, ad_p = float(ad.statistic), float(ad.pvalue)
        ad_ok = ad_p > 0.05
    except Exception:
        ad_stat, ad_p, ad_ok = float("nan"), float("nan"), False

    results = {
        "fit": "ok",
        "model_type": "Truncated Normal with Zero/One Inflation",
        "underlying_mean": mu,
        "underlying_std": sigma,
        "observed_mean": target_mean,
        "observed_std": target_std,
        "simulated_mean": sim_mean,
        "simulated_std": sim_std,
        "mean_relative_error": mean_err,
        "std_relative_error": std_err,
        "zero_proportion": zero_prop,
        "one_proportion": one_prop,
        "interior_mean": float(np.mean(interior)),
        "interior_std": float(np.std(interior)),
        "ks_stat": float(ks_stat),
        "ks_p": float(ks_p),
        "ad_stat": ad_stat,
        "ad_p": ad_p,
        "adequate_ks": bool(ks_p > 0.05),
        "adequate_ad": bool(ad_ok),
        "adequate": bool(ks_p > 0.05) and bool(ad_ok),
    }
    return results, simulated
