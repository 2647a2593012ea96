"""The ``linalg_*`` la_op family (counterpart of mxnet_tpu/ops/linalg.py),
registered under its public and its ``_linalg_*`` names.

Every op batches over the leading dims, as the reference's. The
factorizations are ``torch.linalg``'s (LAPACK on the CPU, cuSOLVER on a
card), as the JAX package leaves them to XLA; the conventions are the
JAX package's: ``gemm``'s alpha, beta and transposes, the lower triangle
by default in ``potrf``/``potri``/``trsm``/``trmm``, ``syevd`` as
``(U, L)`` with ``A = U^T diag(L) U`` and eigenvalues ascending,
``gelqf`` as ``(Q, L)`` with ``A = L Q``, ``svd`` as ``(UT, L, V)``.
"""
from __future__ import annotations

import math

import torch

from . import promote as _promote
from .registry import _OPS, register_op

__all__ = ["pinv_cutoff", "lstsq"]


def _tri(a, lower, offset=0):
    return torch.tril(a, offset) if lower else torch.triu(a, offset)


@register_op("linalg_gemm")
def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
         beta=1.0, axis=-2):  # noqa: ARG001 - the reference's batch axis
    """``alpha * op(A) @ op(B) + beta * C``."""
    a = A.mT if transpose_a else A
    b = B.mT if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register_op("linalg_gemm2")
def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    a = A.mT if transpose_a else A
    b = B.mT if transpose_b else B
    return alpha * torch.matmul(a, b)


@register_op("linalg_potrf")
def potrf(A):
    """The lower Cholesky factor L, ``A = L L^T``."""
    return torch.linalg.cholesky(A)


@register_op("linalg_potri")
def potri(A):
    """``(L L^T)^-1`` from the lower factor L."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    linv = torch.linalg.solve_triangular(torch.tril(A), eye, upper=False)
    return torch.matmul(linv.mT, linv)


@register_op("linalg_trmm")
def trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    """``alpha * op(tri(A)) @ B`` (or ``B @ op(tri(A))``)."""
    tri = _tri(A, lower)
    if transpose:
        tri = tri.mT
    return alpha * (torch.matmul(B, tri) if rightside
                    else torch.matmul(tri, B))


@register_op("linalg_trsm")
def trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0):
    """``X`` with ``op(tri(A)) X = alpha B`` (or ``X op(tri(A)) = alpha
    B``)."""
    m = _tri(A, lower)
    upper = not lower
    if transpose:
        m, upper = m.mT, lower
    return torch.linalg.solve_triangular(m, alpha * B, upper=upper,
                                         left=not rightside)


@register_op("linalg_syrk")
def syrk(A, transpose=False, alpha=1.0):
    """``alpha * A A^T`` (``A^T A`` with ``transpose``)."""
    return alpha * (torch.matmul(A.mT, A) if transpose
                    else torch.matmul(A, A.mT))


@register_op("linalg_gelqf")
def gelqf(A):
    """``(Q, L)`` with ``A = L Q`` and Q's rows orthonormal, from the QR
    factorization of ``A^T``."""
    q, r = torch.linalg.qr(A.mT, mode="reduced")
    return q.mT, r.mT


@register_op("linalg_syevd")
def syevd(A):
    """``(U, L)``: eigenvectors as rows and ascending eigenvalues, ``A =
    U^T diag(L) U``."""
    w, v = torch.linalg.eigh(A)
    return v.mT, w


@register_op("linalg_sumlogdiag")
def sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register_op("linalg_extractdiag")
def extractdiag(A, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register_op("linalg_makediag")
def makediag(A, offset=0):
    """Square matrices with ``A``'s last axis on the ``offset``
    diagonal."""
    return torch.diag_embed(A, offset=offset)


def _trian_index(n, offset, lower, device):
    fn = torch.tril_indices if lower else torch.triu_indices
    return fn(n, n, offset, device=device)


@register_op("linalg_extracttrian")
def extracttrian(A, offset=0, lower=True):
    """The (lower or upper) triangle from the ``offset`` diagonal on,
    packed row by row."""
    rows, cols = _trian_index(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]


@register_op("linalg_maketrian")
def maketrian(A, offset=0, lower=True):
    """The inverse of :func:`extracttrian`; n follows from the packed
    length m in closed form (linalg.py:maketrian)."""
    m = A.shape[-1]
    o = offset if lower else -offset
    if o <= 0:
        n = (math.isqrt(8 * m + 1) - 1) // 2 - o
    else:
        disc = (1 + 2 * o) ** 2 + 4 * (o * o + o + 2 * m)
        n = (math.isqrt(disc) - (1 + 2 * o)) // 2
    rows, cols = _trian_index(n, offset, lower, A.device)
    if rows.numel() != m:
        raise ValueError(f"packed length {m} does not form a triangle "
                         f"with offset {offset}")
    out = A.new_zeros(tuple(A.shape[:-1]) + (n, n))
    out[..., rows, cols] = A
    return out


@register_op("linalg_inverse")
def inverse(A):
    return torch.linalg.inv(A)


@register_op("linalg_det")
def det(A):
    return torch.linalg.det(A)


@register_op("linalg_slogdet")
def slogdet(A):
    sign, logabs = torch.linalg.slogdet(A)
    return sign, logabs


@register_op("linalg_svd")
def svd(A):
    """``(U^T, s, Vh)`` of the reduced SVD (gesvd's ``(UT, L, V)``)."""
    u, s, vh = torch.linalg.svd(A, full_matrices=False)
    return u.mT, s, vh


@register_op("linalg_matrix_rank")
def matrix_rank(A, tol=None):
    """The number of singular values above ``tol``, by default above
    ``max(s) * max(M, N) * eps`` (``jnp.linalg.matrix_rank``)."""
    A = _promote.inexact(A)
    s = torch.linalg.svdvals(A)
    if tol is None:
        cut = (s.amax(-1, keepdim=True) * max(A.shape[-2:])
               * torch.finfo(s.dtype).eps)
    else:
        cut = torch.as_tensor(tol, dtype=s.dtype, device=s.device)[..., None]
    return (s > cut).sum(-1)


@register_op("linalg_norm")
def matrix_norm(A, ord=None, axis=None, keepdims=False):  # noqa: A002
    """``numpy.linalg.norm``."""
    return torch.linalg.norm(_promote.inexact(A), ord=ord, dim=axis,
                             keepdim=keepdims)


@register_op("linalg_solve")
def solve(A, B):
    return torch.linalg.solve(A, B)


@register_op("linalg_tensorinv")
def tensorinv(A, ind=2):
    return torch.linalg.tensorinv(A, ind=ind)


@register_op("linalg_tensorsolve")
def tensorsolve(A, B, axes=None):
    return torch.linalg.tensorsolve(A, B, dims=axes)


@register_op("linalg_cholesky")
def cholesky(A, lower=True):
    L = torch.linalg.cholesky(A)
    return L if lower else L.mT


@register_op("linalg_qr")
def qr(A):
    return tuple(torch.linalg.qr(A, mode="reduced"))


@register_op("linalg_eig")
def eig(A):
    """Complex eigenvalues and eigenvectors (``jnp.linalg.eig``)."""
    return tuple(torch.linalg.eig(A))


@register_op("linalg_eigh")
def eigh(A, upper=False):
    return tuple(torch.linalg.eigh(A, UPLO="U" if upper else "L"))


@register_op("linalg_eigvals")
def eigvals(A):
    return torch.linalg.eigvals(A)


@register_op("linalg_eigvalsh")
def eigvalsh(A):
    return torch.linalg.eigvalsh(A)


def lstsq(a, b, rcond=None, numpy_resid=False):
    """``(x, residuals, rank, s)`` by the SVD, as ``jnp.linalg.lstsq``
    computes them: singular values below ``rcond * s[0]`` (rcond None:
    ``eps * max(M, N)``; negative: eps) count as zero; the residuals are
    the squared norms of ``b - a x`` by column, or empty under
    ``numpy_resid`` when the rank is short or M <= N."""
    a = _promote.inexact(a)
    b = b.to(a.dtype)
    vector = b.dim() == 1
    if vector:
        b = b[:, None]
    m, n = a.shape
    eps = torch.finfo(a.dtype).eps
    if rcond is None:
        rcond = eps * max(n, m)
    elif rcond < 0:
        rcond = eps
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[:, None]
    x = torch.matmul(vt.mT, s_inv * torch.matmul(u.mT, b))
    if numpy_resid and (int(rank) < n or m <= n):
        resid = a.new_zeros((0,))
    else:
        resid = torch.linalg.vector_norm(b - torch.matmul(a, x),
                                         dim=0) ** 2
    return (x.reshape(-1) if vector else x), resid, rank, s


@register_op("linalg_lstsq")
def linalg_lstsq(A, B, rcond=None):
    return lstsq(A, B, rcond)


def pinv_cutoff(a, rtol=None):
    """The pseudo-inverse as ``jnp.linalg.pinv`` computes it: singular
    values at or below ``rtol * s_max`` (rtol None: ``10 * max(M, N) *
    eps``) are dropped."""
    a = _promote.inexact(a)
    if rtol is None:
        rtol = 10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cut = torch.as_tensor(rtol, dtype=s.dtype, device=s.device)[..., None] \
        * s[..., :1]
    s = torch.where(s > cut, s, torch.full_like(s, math.inf))
    return torch.matmul(vh.mT, u.mT / s[..., None])


@register_op("linalg_pinv")
def pinv(A, rcond=None):
    return pinv_cutoff(A, rcond)


@register_op("linalg_multi_dot")
def multi_dot(*arrays):
    return torch.linalg.multi_dot(list(arrays))


@register_op("linalg_matrix_power")
def matrix_power(A, n):
    return torch.linalg.matrix_power(A, n)


@register_op("linalg_kron")
def kron(a, b):
    return torch.kron(a, b)


@register_op("linalg_matmul")
def matmul(a, b):
    return torch.matmul(a, b)


# la_op.cc registers every op under its internal spelling too
for _key in [k for k in _OPS if k.startswith("linalg_")]:
    register_op("_" + _key, _OPS[_key])
del _key
