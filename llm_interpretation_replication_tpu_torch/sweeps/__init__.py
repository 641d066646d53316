"""The port's sweep shells (copies of ``sweeps/``'s local-model
perturbation sweep, the 100-question base-vs-instruct sweep, the
instruct-model sweep, the word-meaning base-vs-instruct sweep and the
frontier-API perturbation sweeps)."""

from .api_perturbation import (
    load_processed_triples,
    run_api_perturbation_sweep,
    run_claude_perturbation_sweep,
    run_gemini_perturbation_sweep,
    run_gpt_perturbation_sweep,
)

from .base_vs_instruct_100q import run_model_on_prompts, run_sweep
from .instruct_sweep import (run_base_vs_instruct_word_meaning,
                             run_instruct_sweep)
from .perturbation import (
    load_existing_keys,
    load_existing_rows,
    run_model_perturbation_sweep,
    run_packed_perturbation_sweep,
)
from .writers import (
    BASE_VS_INSTRUCT_100Q_COLUMNS,
    CLAUDE_PERTURBATION_COLUMNS,
    INSTRUCT_COMPARISON_COLUMNS,
    MODEL_COMPARISON_COLUMNS,
    PERTURBATION_COLUMNS,
    base_vs_instruct_100q_frame,
    instruct_comparison_frame,
    model_comparison_frame,
    model_family_from_name,
    perturbation_frame,
    perturbation_row,
    write_csv,
)

__all__ = ["BASE_VS_INSTRUCT_100Q_COLUMNS", "CLAUDE_PERTURBATION_COLUMNS",
           "INSTRUCT_COMPARISON_COLUMNS",
           "MODEL_COMPARISON_COLUMNS", "PERTURBATION_COLUMNS",
           "base_vs_instruct_100q_frame", "instruct_comparison_frame",
           "model_comparison_frame", "perturbation_frame",
           "load_existing_keys", "load_existing_rows",
           "load_processed_triples", "run_api_perturbation_sweep",
           "run_claude_perturbation_sweep", "run_gemini_perturbation_sweep",
           "run_gpt_perturbation_sweep",
           "model_family_from_name", "perturbation_row",
           "run_base_vs_instruct_word_meaning", "run_instruct_sweep",
           "run_model_on_prompts", "run_model_perturbation_sweep",
           "run_packed_perturbation_sweep", "run_sweep", "write_csv"]
