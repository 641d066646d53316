"""The port's sweep shells (a copy of ``sweeps/``'s local-model
perturbation sweep)."""

from .perturbation import (
    load_existing_keys,
    load_existing_rows,
    run_model_perturbation_sweep,
)
from .writers import PERTURBATION_COLUMNS, model_family_from_name, perturbation_row

__all__ = ["PERTURBATION_COLUMNS", "load_existing_keys", "load_existing_rows",
           "model_family_from_name", "perturbation_row",
           "run_model_perturbation_sweep"]
