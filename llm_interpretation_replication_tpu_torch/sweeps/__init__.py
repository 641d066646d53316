"""The port's sweep shells (copies of ``sweeps/``'s local-model
perturbation sweep, the 100-question base-vs-instruct sweep, the
instruct-model sweep and the word-meaning base-vs-instruct sweep)."""

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
    INSTRUCT_COMPARISON_COLUMNS,
    MODEL_COMPARISON_COLUMNS,
    PERTURBATION_COLUMNS,
    model_family_from_name,
    perturbation_row,
    write_csv,
)

__all__ = ["BASE_VS_INSTRUCT_100Q_COLUMNS", "INSTRUCT_COMPARISON_COLUMNS",
           "MODEL_COMPARISON_COLUMNS", "PERTURBATION_COLUMNS",
           "load_existing_keys", "load_existing_rows",
           "model_family_from_name", "perturbation_row",
           "run_base_vs_instruct_word_meaning", "run_instruct_sweep",
           "run_model_on_prompts", "run_model_perturbation_sweep",
           "run_packed_perturbation_sweep", "run_sweep", "write_csv"]
