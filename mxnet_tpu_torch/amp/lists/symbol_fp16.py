"""fp16 AMP cast lists (a copy of mxnet_tpu/amp/lists/symbol_fp16.py):
the bf16 tables under the fp16 names, since ``float16`` maps to bf16 here
as in the JAX package; kept as its own module so the spellings
``amp.lists.symbol_fp16.FP16_FUNCS`` resolve.
"""
from .symbol_bf16 import (
    BF16_FP32_FUNCS as FP16_FP32_FUNCS,  # noqa: F401
    BF16_FUNCS as FP16_FUNCS,  # noqa: F401
    CONDITIONAL_FP32_FUNCS,  # noqa: F401
    FP32_FUNCS,  # noqa: F401
    LOSS_OUTPUT_FUNCTIONS,  # noqa: F401
    WIDEST_TYPE_CASTS,  # noqa: F401
)
