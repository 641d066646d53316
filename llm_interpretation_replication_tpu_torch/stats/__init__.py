"""The statistics layer, without pandas: bootstrap CIs, normality tests,
power analysis, the clipped-normal fit, the prompt-similarity validator,
the compliance audits and the inter-model correlation engine (copies of
the JAX package's modules; those that took DataFrames take row dicts and
``utils.frame.Pivot`` tables)."""

from .bootstrap import (
    base_vs_instruct_analysis,
    bootstrap_mae,
    bootstrap_mae_difference,
    bootstrap_statistic,
    paired_mean_diff_bootstrap,
)
from .compliance import (
    EXPECTED_TOKENS,
    check_confidence_compliance,
    check_first_and_full,
    check_output_compliance,
    classify_confidence_response,
)
from .correlations import (
    cohens_kappa,
    compare_correlation_distributions,
    correlation_summary_bootstrap,
    fisher_z_pvalue,
    pairwise_correlations,
    pairwise_kappa,
    pivot_model_values,
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
