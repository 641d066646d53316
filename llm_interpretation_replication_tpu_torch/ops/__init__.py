from .attention import attention, flash_attention
from .moe import init_moe_params, moe_mlp_dense, moe_mlp_sharded
from .quant import (
    int8_matmul,
    quantize_decoder_params,
    quantize_decoder_params_np,
    quantize_weight,
)

__all__ = [
    "attention",
    "flash_attention",
    "init_moe_params",
    "int8_matmul",
    "moe_mlp_dense",
    "moe_mlp_sharded",
    "quantize_decoder_params",
    "quantize_decoder_params_np",
    "quantize_weight",
]
