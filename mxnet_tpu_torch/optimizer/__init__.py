"""Optimizers (counterpart of mxnet_tpu/optimizer/): the base class, the
registry and the rules ported so far."""
from .optimizer import (  # noqa: F401
    Adam,
    AdamW,
    NAG,
    Optimizer,
    SGD,
    Signum,
    Updater,
    create,
    get_updater,
    register,
)
