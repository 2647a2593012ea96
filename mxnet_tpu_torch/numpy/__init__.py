"""``mx.np``: the NumPy-compatible frontend of the port (counterpart of
mxnet_tpu/numpy). Its functions are generated over torch from the JAX
package's name lists (``multiarray.py``), plus hand-written creation and
random functions that honor the device scope."""
from . import linalg, random  # noqa: F401
from .multiarray import *  # noqa: F401,F403
from .multiarray import GENERATED, MISSING, __all__, ndarray  # noqa: F401
