"""AMP op cast lists (counterpart of mxnet_tpu/amp/lists/)."""
from . import symbol_bf16, symbol_fp16  # noqa: F401
