"""Model zoo of the port (counterpart of mxnet_tpu/gluon/model_zoo)."""
from . import bert, vision
from .vision import get_model

__all__ = ["bert", "get_model", "vision"]
