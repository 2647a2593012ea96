"""Sparse NDArrays: CSR and row-sparse storage (counterpart of
mxnet_tpu/ndarray/sparse.py).

Storage over tensors on the array's own device. A CSR array holds
``data`` (nnz,), ``indices`` (nnz,) column ids and ``indptr`` (rows + 1,);
a row-sparse array holds ``data`` (k, *row shape) and ascending
``indices`` (k,), every other row zero. The index tensors are int32, as in
the JAX package; ``.data``, ``.indices`` and ``.indptr`` give them as
NDArrays.

Every structural operation stays on the device of the array: casting a
dense array finds its nonzeros with ``torch.nonzero``, ``retain`` keeps
rows by ``torch.isin``, and the merged add and subtract of two row-sparse
arrays take the union of their rows by ``torch.unique`` and
``torch.searchsorted``, where the JAX package computes these on the host
through numpy. Their results are the same.

The compute is plain PyTorch, as the JAX package's is XLA (no Pallas
kernel): ``dot`` of a CSR array gathers the rows of the dense operand it
needs (``index_select``) and sums them into the output rows
(``index_add``); of a row-sparse array it multiplies the stored rows and
scatters them into place. Gradients flow to the dense operand.
``torch.sparse`` is not used: it coalesces and orders on its own terms.

What densifies, as in the JAX package: ``dot`` with a dense left operand,
``multiply``/``divide`` with a sparse operand, add and subtract unless
both operands are row-sparse, and any method reached through the fluent
fallback.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import normalize_dtype, numpy_dtype
from ..ops.registry import register_op
from .ndarray import NDArray, apply_op, creation_device

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "zeros", "empty", "array",
           "add", "subtract", "multiply", "divide", "dot", "retain",
           "cast_storage"]


def _tensor(x, device=None, dtype=None):
    """A tensor from an NDArray, a tensor or host data (copied, numpy's
    dtype kept unless ``dtype``), on ``device`` where given."""
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(_np.array(x))
    return x.detach().to(device=device, dtype=dtype)


def _source_device(x, ctx):
    """``ctx`` where given, else the device of a tensor or NDArray ``x``,
    else the current device."""
    if ctx is not None:
        return creation_device(ctx)
    if isinstance(x, NDArray):
        return x._data.device
    if isinstance(x, torch.Tensor):
        return x.device
    return creation_device()


class BaseSparseNDArray:
    """What CSR and row-sparse arrays share. Not an NDArray: a value
    container whose dense view (``todense()``) enters autograd."""

    stype = None

    def __init__(self, shape, dtype):
        self._shape = tuple(int(s) for s in shape)
        self._dtype = normalize_dtype(dtype)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return numpy_dtype(self._dtype)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def size(self):
        out = 1
        for s in self._shape:
            out *= s
        return out

    @property
    def device(self):
        return self._values.device

    ctx = device
    context = device

    @property
    def data(self):
        return NDArray(self._values)

    @property
    def indices(self):
        return NDArray(self._idx)

    def asnumpy(self):
        return self.todense().asnumpy()

    def astype(self, dtype):
        raise NotImplementedError

    def todense(self) -> NDArray:
        raise NotImplementedError

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        return cast_storage(self.todense(), stype)

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._assign(self.todense()._data.to(other.device))
            return other
        raise TypeError(f"copyto target {type(other)}")

    def wait_to_read(self):
        if self._values.is_cuda:
            torch.cuda.current_stream(self._values.device).synchronize()
        return self

    def copy(self):
        raise NotImplementedError

    def __repr__(self):
        return (f"\n<{type(self).__name__} {self._shape} "
                f"dtype={str(self._dtype).replace('torch.', '')} "
                f"@{self.device}>")

    # members that hold autograd state would act on a throwaway dense copy
    _FLUENT_DENY = frozenset(
        {"attach_grad", "grad", "backward", "detach", "as_in_context",
         "as_in_ctx"})

    def __getattr__(self, name):
        """The fluent surface densifies, as every op without a sparse form
        does in the JAX package: ``rsp.sum()``, ``csr.softmax()``. Private
        names, unknown names and the stateful members raise without
        densifying."""
        if name.startswith("_") or name in BaseSparseNDArray._FLUENT_DENY:
            raise AttributeError(
                f"{type(self).__name__} has no attribute {name!r}"
                + (f" ({name} would act on a temporary dense copy; "
                   f"convert with .todense() first)"
                   if name in BaseSparseNDArray._FLUENT_DENY else ""))
        if not hasattr(NDArray, name):
            from .. import ndarray as _nd_ns

            if not callable(getattr(_nd_ns, name, None)):
                raise AttributeError(
                    f"{type(self).__name__} has no attribute {name!r}")
        return getattr(self.todense(), name)


class CSRNDArray(BaseSparseNDArray):
    """A compressed-sparse-row matrix: ``data`` (nnz,), ``indices`` (nnz,)
    column ids, ``indptr`` (rows + 1,)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, dtype=None):
        data = _tensor(data)
        super().__init__(shape, dtype if dtype is not None else data.dtype)
        self._values = data.to(self._dtype)
        dev = self._values.device
        self._idx = _tensor(indices, dev, torch.int32)
        self._ptr = _tensor(indptr, dev, torch.int32)

    @property
    def indptr(self):
        return NDArray(self._ptr)

    def astype(self, dtype):
        return CSRNDArray(self._values, self._idx, self._ptr, self._shape,
                          dtype)

    def copy(self):
        return CSRNDArray(self._values.clone(), self._idx.clone(),
                          self._ptr.clone(), self._shape, self._dtype)

    def _row_ids(self):
        """The row of each stored value, (nnz,) int64."""
        rows = torch.arange(self._shape[0], device=self._ptr.device)
        return torch.repeat_interleave(rows, torch.diff(self._ptr).long(),
                                       output_size=self._values.shape[0])

    def todense(self):
        dense = torch.zeros(self._shape, dtype=self._dtype,
                            device=self.device)
        dense.index_put_((self._row_ids(), self._idx.long()), self._values,
                         accumulate=True)
        return NDArray(dense)

    def slice(self, start, end):
        """Rows ``start:end`` (the JAX package's row slice), cut from the
        stored arrays: the two bounds of ``indptr`` are read on the host,
        no value is."""
        start, end, _ = slice(start, end).indices(self._shape[0])
        end = max(start, end)
        lo, hi = (int(v) for v in self._ptr[[start, end]].tolist())
        return CSRNDArray(self._values[lo:hi], self._idx[lo:hi],
                          self._ptr[start:end + 1] - lo,
                          (end - start, self._shape[1]), self._dtype)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.slice(key.start or 0, key.stop)
        raise TypeError("CSR supports row-slice indexing only")


class RowSparseNDArray(BaseSparseNDArray):
    """A row-sparse tensor: rows ``indices`` (ascending) are stored as
    ``data``, all others are zero."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, dtype=None):
        # trusts ascending indices: every internal constructor gives them,
        # and row_sparse_array() sorts what a caller passes
        data = _tensor(data)
        super().__init__(shape, dtype if dtype is not None else data.dtype)
        self._values = data.to(self._dtype)
        self._idx = _tensor(indices, self._values.device, torch.int32)

    def astype(self, dtype):
        return RowSparseNDArray(self._values, self._idx, self._shape, dtype)

    def copy(self):
        return RowSparseNDArray(self._values.clone(), self._idx.clone(),
                                self._shape, self._dtype)

    def todense(self):
        dense = torch.zeros(self._shape, dtype=self._dtype,
                            device=self.device)
        dense.index_put_((self._idx.long(),), self._values, accumulate=True)
        return NDArray(dense)

    def retain(self, indices):
        return retain(self, indices)


# -- construction ------------------------------------------------------------

def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` and ``shape``, a dense
    array, or another CSRNDArray."""
    if isinstance(arg1, CSRNDArray):
        return arg1 if dtype is None else arg1.astype(dtype)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise ValueError("shape required with (data, indices, indptr)")
        dev = _source_device(data, ctx)
        return CSRNDArray(_tensor(data, dev), indices, indptr, shape, dtype)
    return _dense_to_csr(_tensor(arg1, _source_device(arg1, ctx)), dtype)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` and ``shape`` (the rows
    sorted), a dense array, or another RowSparseNDArray."""
    if isinstance(arg1, RowSparseNDArray):
        return arg1 if dtype is None else arg1.astype(dtype)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if shape is None:
            raise ValueError("shape required with (data, indices)")
        dev = _source_device(data, ctx)
        data = _tensor(data, dev)
        idx = _tensor(indices, dev, torch.int64).reshape(-1)
        # a caller's rows may come in any order: sort them (stable, so
        # ascending input stays as it is)
        idx, order = torch.sort(idx, stable=True)
        return RowSparseNDArray(data[order], idx, shape, dtype)
    return _dense_to_rsp(_tensor(arg1, _source_device(arg1, ctx)), dtype)


def _dense_to_csr(dense, dtype=None):
    if dense.dim() != 2:
        raise ValueError("csr requires 2-D")
    rows, cols = torch.nonzero(dense, as_tuple=True)
    counts = torch.bincount(rows, minlength=dense.shape[0])
    indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                         device=dense.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return CSRNDArray(dense[rows, cols], cols, indptr, tuple(dense.shape),
                      dtype if dtype is not None else dense.dtype)


def _dense_to_rsp(dense, dtype=None):
    flat = dense.reshape(dense.shape[0], -1)
    rows = torch.nonzero(flat.ne(0).any(dim=1)).reshape(-1)
    return RowSparseNDArray(dense[rows], rows, tuple(dense.shape),
                            dtype if dtype is not None else dense.dtype)


def zeros(stype, shape, ctx=None, dtype=None, **kwargs):  # noqa: ARG001
    """An all-zero array of storage ``stype`` (float32 by default)."""
    dtype = normalize_dtype(dtype if dtype is not None else "float32")
    dev = creation_device(ctx)
    shape = tuple(shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros(0, dtype=dtype, device=dev),
                          torch.zeros(0, dtype=torch.int32, device=dev),
                          torch.zeros(shape[0] + 1, dtype=torch.int32,
                                      device=dev), shape, dtype)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dtype, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev), shape, dtype)
    if stype == "default":
        return NDArray(torch.zeros(shape, dtype=dtype, device=dev))
    raise ValueError(f"unknown stype {stype}")


empty = zeros


def array(source_array, ctx=None, dtype=None):
    """A sparse-aware ``array``: a sparse array keeps its storage, a
    ``scipy.sparse`` matrix becomes a CSRNDArray, anything else a dense
    NDArray of the source's own dtype."""
    if isinstance(source_array, BaseSparseNDArray):
        return source_array if dtype is None else source_array.astype(dtype)
    try:
        import scipy.sparse as sps

        if sps.issparse(source_array):
            csr = source_array.tocsr()
            return CSRNDArray(_tensor(csr.data, creation_device(ctx)),
                              csr.indices, csr.indptr, csr.shape, dtype)
    except ImportError:
        pass
    t = _tensor(source_array, _source_device(source_array, ctx))
    return NDArray(t if dtype is None else t.to(normalize_dtype(dtype)))


def cast_storage(arr, stype):
    """``arr`` in storage ``stype`` ('default', 'csr', 'row_sparse'); a
    tensor in gives a tensor for 'default'."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if stype == "default":
        return arr
    dense = arr._data if isinstance(arr, NDArray) else arr
    if stype == "csr":
        return _dense_to_csr(dense.detach())
    if stype == "row_sparse":
        return _dense_to_rsp(dense.detach())
    raise ValueError(f"unknown stype {stype}")


# -- compute -----------------------------------------------------------------

def _csr_dot(data, indices, row_ids, n_rows, n_cols, d, transpose_a):
    """``csr @ d`` (``csr.T @ d`` with ``transpose_a``) over tensors: the
    needed rows of ``d`` gathered and scaled by the stored values, then
    summed into the output rows."""
    vec = d.dim() == 1
    if vec:
        d = d[:, None]
    src, dst, n_out = (row_ids, indices, n_cols) if transpose_a \
        else (indices, row_ids, n_rows)
    gathered = data[:, None] * d.index_select(0, src)
    out = torch.zeros((n_out, d.shape[1]), dtype=gathered.dtype,
                      device=gathered.device).index_add(0, dst, gathered)
    return out[:, 0] if vec else out


def _rsp_dot(data, indices, n_rows, d, transpose_b):
    if transpose_b:
        d = d.T
    vec = d.dim() == 1
    if vec:
        d = d[:, None]
    partial = data @ d
    out = torch.zeros((n_rows, d.shape[1]), dtype=partial.dtype,
                      device=partial.device).index_add(0, indices, partial)
    return out[:, 0] if vec else out


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse·dense products: ``csr @ d``, ``csr.T @ d`` (``transpose_a``),
    ``rsp @ d``; a dense left operand takes the dense product of the
    densified right one. The gradient flows to a dense NDArray operand."""
    if isinstance(lhs, CSRNDArray):
        if transpose_b:
            rhs = rhs.transpose() if isinstance(rhs, NDArray) else rhs.T
        n_rows, n_cols = lhs.shape
        data, indices, row_ids = lhs._values, lhs._idx, lhs._row_ids()

        def pure(d):
            return _csr_dot(data, indices, row_ids, n_rows, n_cols, d,
                            transpose_a)

        if isinstance(rhs, NDArray):
            return apply_op(pure, rhs)
        return NDArray(pure(_tensor(rhs, lhs.device)))
    if isinstance(lhs, RowSparseNDArray):
        if transpose_a:
            raise ValueError("transpose_a unsupported for row_sparse lhs "
                             "(dot(rsp, dense) only)")
        n_rows, data, indices = lhs.shape[0], lhs._values, lhs._idx

        def pure_rsp(d):
            return _rsp_dot(data, indices, n_rows, d, transpose_b)

        if isinstance(rhs, NDArray):
            return apply_op(pure_rsp, rhs)
        return NDArray(pure_rsp(_tensor(rhs, lhs.device)))
    from ..numpy import dot as _dense_dot

    a = lhs.transpose() if transpose_a else lhs
    b = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    if transpose_b:
        b = b.transpose()
    return _dense_dot(a, b)


def retain(rsp, indices):
    """The rows of ``rsp`` that ``indices`` names, the others dropped."""
    if not isinstance(rsp, RowSparseNDArray):
        raise TypeError("retain expects RowSparseNDArray")
    keep = _tensor(indices, rsp.device, torch.int64)
    mask = torch.isin(rsp._idx.long(), keep)
    return RowSparseNDArray(rsp._values[mask], rsp._idx[mask], rsp.shape,
                            rsp._dtype)


def _rsp_elemwise(op, lhs, rhs):
    """``op`` of two row-sparse arrays over the union of their rows, a
    row-sparse array."""
    li, ri = lhs._idx.long(), rhs._idx.long()
    rows = torch.unique(torch.cat([li, ri]))
    shape = (rows.shape[0],) + tuple(lhs._values.shape[1:])
    a = torch.zeros(shape, dtype=lhs._dtype, device=lhs.device)
    b = torch.zeros(shape, dtype=rhs._dtype, device=lhs.device)
    a[torch.searchsorted(rows, li)] = lhs._values
    b[torch.searchsorted(rows, ri)] = rhs._values.to(lhs.device)
    return RowSparseNDArray(op(a, b), rows, lhs.shape)


def _binary(op, name):
    def fn(lhs, rhs):
        if isinstance(lhs, RowSparseNDArray) and isinstance(
                rhs, RowSparseNDArray) and name in ("add", "subtract"):
            return _rsp_elemwise(op, lhs, rhs)
        a = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
        b = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
        from .. import numpy as mxnp

        return getattr(mxnp, name)(a, b)

    fn.__name__ = fn.__qualname__ = name
    return fn


add = _binary(torch.add, "add")
subtract = _binary(torch.sub, "subtract")
multiply = _binary(torch.mul, "multiply")
divide = _binary(torch.true_divide, "divide")


# the registry's sparse ops (the JAX package's ops/aliases.py:334-335)
register_op("cast_storage", cast_storage)
register_op("_sparse_retain", retain)
