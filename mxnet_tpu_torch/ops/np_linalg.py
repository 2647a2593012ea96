"""The reference conventions of ``mx.np.linalg`` (counterpart of
mxnet_tpu/ops/np_linalg.py), shared by the ``mx.np.linalg`` frontend and
the ``_npi_*`` names of the op registry.

* ``svd``: numpy's reduced SVD ``(u, s, vh)``;
* ``eigh``/``eigvalsh``: a bool ``upper`` picks the triangle read;
* ``matrix_rank``: ``rtol``/``hermitian``;
* ``lstsq``: ``rcond="warn"`` (the default) is the machine-eps cutoff,
  with numpy's residuals;
* ``eig``/``eigvals``: real in, real out (the real parts), and no
  gradient: a backward through them raises, as the reference registers
  none (np_eig.cc).
"""
from __future__ import annotations

import torch

from . import linalg as _la
from . import promote as _promote
from .registry import register_op

__all__ = ["svd", "eigh", "eigvalsh", "matrix_rank", "lstsq", "eig",
           "eigvals"]


def svd(a):
    return tuple(torch.linalg.svd(a, full_matrices=False))


def eigh(a, upper=False):
    return tuple(torch.linalg.eigh(a, UPLO="U" if upper else "L"))


def eigvalsh(a, upper=False):
    return torch.linalg.eigvalsh(a, UPLO="U" if upper else "L")


def matrix_rank(M, rtol=None, hermitian=False):
    """The singular values (or |eigenvalues| when ``hermitian``) above
    ``max * rtol`` (rtol None: ``max(M, N) * eps``)."""
    M = _promote.inexact(M)
    s = (torch.linalg.eigvalsh(M).abs() if hermitian
         else torch.linalg.svdvals(M))
    top = s.amax(-1, keepdim=True)
    if rtol is None:
        cut = top * max(M.shape[-2:]) * torch.finfo(s.dtype).eps
    else:
        cut = top * torch.as_tensor(rtol, dtype=s.dtype,
                                    device=s.device)[..., None]
    return (s > cut).sum(-1)


def lstsq(a, b, rcond="warn"):
    """``(x, residuals, rank, s)``; ``"warn"`` is numpy's rcond -1 (the
    machine epsilon), a numeric string a tolerance."""
    if isinstance(rcond, str):
        if rcond == "warn":
            rcond = -1
        else:
            try:
                rcond = float(rcond)
            except ValueError:
                raise ValueError(
                    f"rcond must be a number, None, or 'warn'; got "
                    f"{rcond!r}") from None
    return _la.lstsq(a, b, rcond, numpy_resid=True)


class _NoGradient(torch.autograd.Function):
    """The real parts of ``fn(a)``; a backward through it raises."""

    @staticmethod
    def forward(ctx, a, fn):  # noqa: ARG004
        if not a.is_floating_point():
            a = a.to(torch.float32)
        out = fn(a)
        if isinstance(out, tuple):
            return tuple(o.real.to(a.dtype) for o in out)
        return out.real.to(a.dtype)

    @staticmethod
    def backward(ctx, *grads):  # noqa: ARG004
        raise NotImplementedError(
            "np.linalg.eig has no gradient (reference np_eig.cc registers "
            "no backward)")


def eig(a):
    return _NoGradient.apply(a, lambda x: tuple(torch.linalg.eig(x)))


def eigvals(a):
    return _NoGradient.apply(a, torch.linalg.eigvals)


for _name in __all__:
    register_op(f"_npi_{_name}", globals()[_name])
register_op("_npi_matrix_rank_none_tol", matrix_rank)
del _name
