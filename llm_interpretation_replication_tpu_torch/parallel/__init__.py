"""Parallelism on ``torch.distributed``, one process a rank: device meshes
(``mesh``), tensor-parallel sharding (``sharding``) and its Megatron
collectives (``tensor_parallel``), the GPipe pipeline (``pipeline``), and
ring and Ulysses sequence-parallel attention.  The package exports the
reference's names; the scoring engine runs on a mesh through
``runtime/row_parallel.py``."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    data_sharded,
    enumerate_mesh_shapes,
    initialize_distributed,
    make_mesh,
    mesh_shape_for,
    replicated,
)
from .pipeline import (
    pipeline_apply,
    pipeline_decoder_forward,
    split_stage_params,
)
from .ring_attention import ring_attention, ring_attention_sharded
from .ulysses import ulysses_attention, ulysses_attention_sharded
from .sharding import (
    activation_spec,
    batch_spec,
    constrain,
    param_specs,
    shard_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "pipeline_apply",
    "pipeline_decoder_forward",
    "split_stage_params",
    "data_sharded",
    "initialize_distributed",
    "enumerate_mesh_shapes",
    "make_mesh",
    "mesh_shape_for",
    "replicated",
    "ring_attention",
    "ring_attention_sharded",
    "ulysses_attention",
    "ulysses_attention_sharded",
    "activation_spec",
    "batch_spec",
    "constrain",
    "param_specs",
    "shard_params",
]
