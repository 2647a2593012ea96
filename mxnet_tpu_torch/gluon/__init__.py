"""Gluon of the port (counterpart of mxnet_tpu/gluon)."""
from . import data, loss, metric, model_zoo, nn, utils
from ..base import DeferredInitializationError
from .block import Block, HybridBlock
from .parameter import Constant, Parameter
from .train_step import TrainStep
from .trainer import Trainer

__all__ = ["Block", "Constant", "DeferredInitializationError", "HybridBlock",
           "Parameter", "ParameterDict", "TrainStep", "Trainer", "data", "loss",
           "metric", "model_zoo", "nn", "utils"]


class ParameterDict(dict):
    """The 1.x name-to-Parameter dict (gluon/__init__.py:15), kept as a
    plain dict as in the JAX package."""
