"""Normality tests: KS + Anderson-Darling against a fitted normal.

Behavioral replica of analyze_perturbation_results.py:21-110, including the
reference's banded AD p-value approximation from the critical-value table
(scipy provides no AD p-value for the normal case).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy import stats as scipy_stats


# Known AD critical-value tables for the 'norm' case.  scipy 1.17 revised
# BOTH the asymptotic table (Stephens' values → recomputed ones) and the
# finite-n correction divisor, so critical values (and hence the banded
# p-values and normal/not-normal flags) shift between scipy eras.  The
# reference's recorded analyses were produced on a legacy-table scipy;
# pinning code detects the active era and compares bit-exactly against the
# matching table instead of a loose tolerance (PARITY.md §6).
AD_NORM_TABLES = {
    # scipy < 1.17: Stephens (1974) via D'Agostino correction
    "legacy": ((0.576, 0.656, 0.787, 0.918, 1.092),
               lambda n: 1.0 + 4.0 / n - 25.0 / n ** 2),
    # scipy >= 1.17: revised table + 1 + 0.75/n + 2.25/n^2 correction
    "scipy117": ((0.561, 0.631, 0.752, 0.873, 1.035),
                 lambda n: 1.0 + 0.75 / n + 2.25 / n ** 2),
}


def ad_critical_values(n: int, version: str) -> np.ndarray:
    """The five AD critical values scipy's anderson(..., 'norm') returns for
    a sample of size ``n`` under the given table era (3-decimal rounding
    exactly as scipy applies it)."""
    base, correction = AD_NORM_TABLES[version]
    return np.around(np.asarray(base) / correction(n), 3)


def active_ad_table_version(probe_n: int = 100) -> str:
    """Which AD table era the INSTALLED scipy uses, detected empirically:
    run anderson() on a fixed sample and match the returned critical values
    against each known table.  Returns 'unknown' for a future scipy whose
    table matches neither — callers should fail loudly and add the new era
    to AD_NORM_TABLES."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = scipy_stats.anderson(np.linspace(-2.0, 2.0, probe_n), "norm")
    crit = np.asarray(res.critical_values, dtype=float)
    for version in AD_NORM_TABLES:
        if np.array_equal(crit, ad_critical_values(probe_n, version)):
            return version
    return "unknown"


def ad_pvalue_from_bands(ad_statistic: float, critical_values) -> float:
    """Reference's banded approximation (index 2 = 5% level)."""
    if ad_statistic > 10:
        return 0.0001
    if ad_statistic > critical_values[4]:
        return 0.005
    if ad_statistic > critical_values[3]:
        return 0.015
    if ad_statistic > critical_values[2]:
        return 0.035
    if ad_statistic > critical_values[1]:
        return 0.075
    return 0.15


def normality_tests(values, label: Optional[str] = None) -> Dict:
    """KS + AD tests of ``values`` against a normal fitted to them.

    Returns the reference's result fields; non-finite values are dropped, and
    n<3 yields a degenerate record with NaN statistics.
    """
    values = np.asarray(values, dtype=float)
    values = values[np.isfinite(values)]
    base = {"label": label, "n": int(len(values))}
    if len(values) < 3:
        return {
            **base,
            "mean": float(np.mean(values)) if len(values) else float("nan"),
            "std": float(np.std(values)) if len(values) > 1 else float("nan"),
            "ks_stat": float("nan"),
            "ks_p": float("nan"),
            "ks_normal": False,
            "ad_stat": float("nan"),
            "ad_p": float("nan"),
            "ad_crit_5pct": float("nan"),
            "ad_normal": False,
        }
    mu, sigma = scipy_stats.norm.fit(values)
    ks_stat, ks_p = scipy_stats.kstest(values, "norm", args=(mu, sigma))
    ad = scipy_stats.anderson(values, "norm")
    ad_p = ad_pvalue_from_bands(ad.statistic, ad.critical_values)
    return {
        **base,
        "mean": float(mu),
        "std": float(sigma),
        "ks_stat": float(ks_stat),
        "ks_p": float(ks_p),
        "ks_normal": bool(ks_p > 0.05),
        "ad_stat": float(ad.statistic),
        "ad_p": float(ad_p),
        "ad_crit_5pct": float(ad.critical_values[2]),
        "ad_normal": bool(ad.statistic < ad.critical_values[2]),
    }
