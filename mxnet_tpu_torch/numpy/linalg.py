"""``mx.np.linalg`` over ``torch.linalg`` (counterpart of
mxnet_tpu/numpy/linalg.py).

The functions take NDArrays (``multi_dot`` a list of them) and run where
they lie, recorded inside ``autograd.record()``: each is the registry's
NDArray wrapper (``ndarray/register.py:make_eager``) of a function over
tensors. Where the reference's conventions and numpy's differ, the
reference's hold (``ops/np_linalg.py``: ``svd``, ``eigh``, ``eigvalsh``,
``matrix_rank``, ``lstsq``, ``eig``, ``eigvals``); ``pinv`` keeps
``jnp.linalg.pinv``'s default cutoff.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import apply_op  # noqa: F401 - as the reference's
from ..ndarray.register import make_eager
from ..ops import linalg as _la
from ..ops import np_linalg as _npla
from ..ops import promote as _promote
from .multiarray import _trace as _mx_trace

__all__ = ["cholesky", "det", "slogdet", "eig", "eigh", "eigvals",
           "eigvalsh", "inv", "lstsq", "matrix_power", "matrix_rank", "norm",
           "pinv", "qr", "solve", "svd", "svdvals", "tensorinv",
           "tensorsolve", "cond", "multi_dot", "matrix_norm", "vector_norm",
           "cross", "outer", "matmul", "trace", "diagonal"]


_FNS = {
    "cholesky": torch.linalg.cholesky, "det": torch.linalg.det,
    "slogdet": lambda a: tuple(torch.linalg.slogdet(a)),
    "inv": torch.linalg.inv, "matrix_power": torch.linalg.matrix_power,
    "norm": lambda x, ord=None, axis=None, keepdims=False:  # noqa: A002
        _la.matrix_norm(x, ord, axis, keepdims),
    "pinv": lambda a, rtol=None, hermitian=False, rcond=None:  # noqa: ARG005
        _la.pinv_cutoff(a, rcond if rcond is not None else rtol),
    "qr": lambda a, mode="reduced": tuple(torch.linalg.qr(a, mode=mode)),
    "solve": torch.linalg.solve,
    "svdvals": lambda x: torch.linalg.svdvals(_promote.inexact(x)),
    "tensorinv": lambda a, ind=2: torch.linalg.tensorinv(a, ind=ind),
    "tensorsolve": lambda a, b, axes=None: torch.linalg.tensorsolve(
        a, b, dims=axes),
    "cond": lambda x, p=None: torch.linalg.cond(x, p),
    "multi_dot": lambda arrays: torch.linalg.multi_dot(list(arrays)),
    "matrix_norm": lambda x, keepdims=False, ord="fro":  # noqa: A002
        torch.linalg.matrix_norm(_promote.inexact(x), ord=ord,
                                 keepdim=keepdims),
    "vector_norm": lambda x, axis=None, keepdims=False, ord=2:  # noqa: A002
        torch.linalg.vector_norm(_promote.inexact(x), ord=ord, dim=axis,
                                 keepdim=keepdims),
    "cross": lambda x1, x2, axis=-1: torch.linalg.cross(x1, x2, dim=axis),
    "outer": torch.outer, "matmul": torch.matmul,
    "trace": lambda x, offset=0, dtype=None: _mx_trace(x, offset, -2, -1,
                                                       dtype),
    "diagonal": lambda x, offset=0: torch.diagonal(x, offset=offset,
                                                   dim1=-2, dim2=-1),
}
_FNS.update({name: getattr(_npla, name) for name in _npla.__all__})

for _name in __all__:
    globals()[_name] = make_eager(_name, _FNS[_name])
del _name
