"""The statistics layer that needs no pandas: bootstrap CIs, normality
tests, power analysis, the clipped-normal fit and the prompt-similarity
validator (copies of the JAX package's modules).  ``compliance`` and
``correlations`` take DataFrames and are not ported yet (ROADMAP.md
queue 1, "Statistics, survey, analysis and figures — the pandas part")."""

from .bootstrap import (
    bootstrap_mae,
    bootstrap_mae_difference,
    bootstrap_statistic,
    paired_mean_diff_bootstrap,
)
from .normality import ad_pvalue_from_bands, normality_tests
from .power import power_curve, power_report, required_sample_size, simulated_power
from .similarity import (
    BM25Okapi,
    bm25_similarity_matrix,
    calculate_all_similarities,
    levenshtein_similarity_matrix,
    tfidf_cosine_matrix,
)
from .truncated import fit_clipped_normal, simulate_clipped_normal
