"""Gluon of the port (counterpart of mxnet_tpu/gluon)."""
from . import loss, model_zoo, nn
from .block import Block, HybridBlock
from .parameter import Parameter
from .train_step import TrainStep
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "TrainStep", "Trainer",
           "loss", "model_zoo", "nn"]
