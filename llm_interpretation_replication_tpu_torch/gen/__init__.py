from .irrelevant import (
    generate_perturbations,
    insert_statement,
    num_insertion_positions,
    position_description,
    split_sentences,
)
from .rephrase import (
    REPHRASE_TEMPLATE,
    generate_rephrasings,
    load_perturbations,
    parse_numbered_rephrasings,
    save_perturbations,
)
