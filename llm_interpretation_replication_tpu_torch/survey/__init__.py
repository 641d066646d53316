"""The survey analyses on row dicts (copies of the JAX package's
``survey/``: the consolidated pipeline, Table 5's MAE analysis, the
demographics table and the agreement variants)."""

from .demographics import (
    demographics_latex_table,
    load_demographics,
    summarize_age,
    summarize_categorical,
)
from .mae_100q import (
    MODEL_FAMILIES,
    analyze_families,
    mae_per_model,
    paired_bootstrap_mae_difference,
    validate_model_data,
)
from .variants import (
    agreement_bootstrap,
    family_differences,
    family_differences_text,
    ground_truth_figures,
    ground_truth_values,
    human_proportions_by_prompt,
    model_human_correlations,
    output_validity_audit,
    probability_distribution_stats,
    three_way_report,
)
from .pipeline import (
    apply_exclusion_criteria,
    cross_prompt_difference_ci,
    extract_question_text,
    human_cross_prompt_correlations,
    human_llm_correlation,
    human_responses_by_question,
    llm_cross_prompt_correlations,
    llm_responses_by_question,
    load_and_clean_survey_data,
    match_survey_to_llm_questions,
    pearson_with_bootstrap,
    per_item_agreement_humans,
    per_item_agreement_llms,
)
