"""Contributed modules (counterpart of mxnet_tpu/contrib/): INT8
quantization. The others (ops, dgl, io, text, tensorboard, onnx) are not
ported yet."""
from . import quantization

__all__ = ["quantization"]
