"""``mx.nd.linalg``: the la_op family under its names without the
``linalg_`` prefix (counterpart of mxnet_tpu/ndarray/linalg.py)."""
from __future__ import annotations

from ..ops import linalg as _ops  # noqa: F401 - registers the ops
from .register import populate

populate(globals(), predicate=lambda n: n.startswith("linalg_"),
         rename=lambda n: n[len("linalg_"):])
