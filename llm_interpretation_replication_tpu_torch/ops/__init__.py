from .attention import attention, flash_attention
from .quant import (
    int8_matmul,
    quantize_decoder_params,
    quantize_decoder_params_np,
    quantize_weight,
)

__all__ = [
    "attention",
    "flash_attention",
    "int8_matmul",
    "quantize_decoder_params",
    "quantize_decoder_params_np",
    "quantize_weight",
]
