"""The analysis commands' modules on row dicts (copies of the JAX
package's ``analysis/`` but its three vendor-evaluation modules,
``closed_source_eval``, ``irrelevant_eval`` and ``replication``, which
ROADMAP.md queue 1's "Statistics, survey, analysis and figures — the
pandas part" still lists).  Importing the package loads no matplotlib:
each figure imports ``viz.figures`` when it is drawn."""

from .base_vs_instruct_figs import base_vs_instruct_figures, process_model_pair
from .combined_confidence import ModelConfidenceAnalyzer, run_combined_analysis
from .model_comparison import (
    cross_experiment_kappa,
    difference_strip_plot,
    model_comparison_report,
)
from .perturbation_report import add_relative_prob, analyze_model, analyze_workbook
from .similarity_report import similarity_report
