"""The analysis commands' modules on row dicts: copies of the JAX package's
``analysis/``, its three vendor-evaluation modules (``closed_source_eval``,
``irrelevant_eval``, ``replication``) among them.  Importing the package
loads no matplotlib: each figure imports ``viz.figures`` when it is
drawn."""

from .base_vs_instruct_figs import base_vs_instruct_figures, process_model_pair
from .closed_source_eval import (
    calculate_correlations,
    compare_with_human_data,
    evaluate_all_models,
    write_report,
)
from .combined_confidence import ModelConfidenceAnalyzer, run_combined_analysis
from .irrelevant_eval import (
    analyze_results,
    build_vendor_evaluators,
    consistency_statistics,
    create_stacked_visualization,
    process_scenario_perturbations,
    run_irrelevant_evaluation,
    save_results,
    summary_frame,
    write_outputs,
)
from .model_comparison import (
    cross_experiment_kappa,
    difference_strip_plot,
    model_comparison_report,
)
from .perturbation_report import add_relative_prob, analyze_model, analyze_workbook
from .similarity_report import similarity_report
