"""Gluon of the port (counterpart of mxnet_tpu/gluon)."""
from . import loss, model_zoo, nn
from .block import Block, HybridBlock
from .parameter import Parameter
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "Trainer", "loss",
           "model_zoo", "nn"]
