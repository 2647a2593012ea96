"""Single-process KVStore, ``'local'``/``'device'`` (counterpart of
mxnet_tpu/kvstore/kvstore.py).

``init``/``push``/``pull``/``pushpull`` over keys: a push sums the copies
of a value, a pull writes the stored value into each out, and an optimizer
installed with ``set_optimizer`` runs on the store's side (the Gluon
Trainer's ``update_on_kvstore=True``). Values are NDArrays; the sums run on
the first copy's device. A row-sparse push merges the pushed rows
(``ndarray/sparse.py``), and ``row_sparse_pull`` gathers the requested rows
on the stored array's device, so on the card no row leaves it.

``save_optimizer_states`` writes the JAX package's pickle, ``{"states":
{key: [leaves as numpy]}}`` with bf16 leaves through ``_dtype_codec``, and
``load_optimizer_states`` reads either package's: a key whose state exists
is grafted at once, another at its first update (the state's nesting is
known only then).
"""
from __future__ import annotations

import pickle

import torch

from .._dtype_codec import pickle_leaf, pickle_load
from ..ndarray import sparse as _sparse
from ..ndarray.ndarray import NDArray
from .base import KVStoreBase, _aslist, _copy_sum

__all__ = ["KVStore", "KVStoreLocal"]


def _is_sparse(vals):
    return any(isinstance(v, _sparse.BaseSparseNDArray) for v in vals)


def _sum(vals):
    """The sum of a value's dense copies, on the first one's device."""
    return NDArray(_copy_sum([v._data for v in vals]))


def _sparse_sum(vals):
    agg = vals[0]
    for v in vals[1:]:
        agg = _sparse.add(agg, v)
    return agg


class KVStoreLocal(KVStoreBase):
    """An in-process key-value store with aggregation."""

    def __init__(self, name="local"):
        self._name = name
        self._store = {}
        self._optimizer = None
        self._updater = None
        self._loaded_states = None

    @property
    def type(self):
        return self._name

    def is_capable(self, capability):
        return capability in ("optimizer",)

    # -- the classic API ---------------------------------------------------
    def init(self, key, value):
        for k, v in zip(_aslist(key), _aslist(value)):
            self._store[str(k)] = v.copy()

    def push(self, key, value, priority=0):  # noqa: ARG002
        keys = _aslist(key)
        if len(keys) == 1:
            grouped = {keys[0]: _aslist(value)}
        else:
            grouped = dict(zip(keys, (_aslist(v) for v in value)))
        for k, vals in grouped.items():
            k = str(k)
            if _is_sparse(vals):
                self._push_sparse(k, vals)
                continue
            agg = _sum(self._compress_vals(k, vals))
            if self._updater is not None:
                w = self._store[k]
                self._updater(_key_int(k), agg._data.to(w.device), w._data)
            else:
                self._store[k] = self._store.get(k, 0) + agg

    def _push_sparse(self, k, vals):
        """Merge row-sparse pushes: only the touched rows are summed."""
        agg = _sparse_sum(vals)
        if self._updater is not None:
            w = self._store[k]
            grad = agg.todense() if isinstance(
                agg, _sparse.BaseSparseNDArray) else agg
            self._updater(_key_int(k), grad._data.to(w.device), w._data)
        else:
            stored = self._store.get(k)
            self._store[k] = agg if stored is None else _sparse.add(
                stored, agg)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):  # noqa: ARG002
        """The rows ``row_ids`` of the stored value as a RowSparseNDArray
        (unique, ascending; a row the stored row-sparse value lacks is
        zero), found and gathered on the stored value's device."""
        if row_ids is None:
            raise ValueError("row_sparse_pull requires row_ids")
        stored = self._store[str(key)]
        dev = stored.device
        ids = row_ids._data if isinstance(row_ids, NDArray) else \
            torch.as_tensor(row_ids)
        ids = torch.unique(ids.to(device=dev, dtype=torch.int64))
        if isinstance(stored, _sparse.RowSparseNDArray):
            have = stored._idx.long()
            values = stored._values
            if have.numel():
                pos = torch.searchsorted(have, ids).clamp_(
                    max=have.numel() - 1)
                found = (have[pos] == ids).reshape(
                    (-1,) + (1,) * (values.dim() - 1))
                rows = torch.where(found, values[pos],
                                   torch.zeros((), dtype=values.dtype,
                                               device=dev))
            else:
                rows = values.new_zeros((ids.numel(),) + values.shape[1:])
        elif isinstance(stored, _sparse.BaseSparseNDArray):
            rows = stored.todense()._data[ids]
        else:
            rows = stored._data[ids]
        rsp = _sparse.RowSparseNDArray(rows, ids, stored.shape)
        if out is not None:
            for dest in _aslist(out):
                dest._values, dest._idx = rsp._values, rsp._idx
        return rsp

    def pull(self, key, out=None, priority=0, ignore_sparse=True):  # noqa: ARG002
        keys = _aslist(key)
        outs = [out] if len(keys) == 1 else out
        for k, o in zip(keys, outs):
            stored = self._store[str(k)]
            for dest in _aslist(o):
                stored.copyto(dest)

    def pushpull(self, key, value, out=None, priority=0):
        """Sum the value's copies, keep the sum, and write it into each out
        where given."""
        keys = _aslist(key)
        if len(keys) != 1:
            for i, k in enumerate(keys):
                self.pushpull(k, value[i], None if out is None else out[i],
                              priority)
            return
        k = str(keys[0])
        vals = _aslist(value)
        if _is_sparse(vals):
            agg = _sparse_sum(vals)
            self._store[k] = agg
            if out is not None:
                dense = agg.todense() if isinstance(
                    agg, _sparse.BaseSparseNDArray) else agg
                for dest in _aslist(out):
                    dense.copyto(dest)
            return
        agg = _sum(self._compress_vals(k, vals))
        self._store[k] = agg
        if out is not None:
            for dest in _aslist(out):
                agg.copyto(dest)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out, priority)

    # -- the optimizer on the store's side ---------------------------------
    def set_optimizer(self, optimizer):
        from ..optimizer import get_updater

        self._optimizer = optimizer
        self._updater = get_updater(optimizer)
        if self._loaded_states:
            # load_optimizer_states ran before set_optimizer
            self._consume_loaded_states()

    @property
    def _updater_states(self):
        return self._updater.states if self._updater is not None else {}

    def save_optimizer_states(self, fname, dump_optimizer=False):
        payload = {"states": {k: [pickle_leaf(s) for s in _flatten_state(v)]
                              for k, v in self._updater_states.items()}}
        if dump_optimizer:
            payload["optimizer"] = self._optimizer
        with open(fname, "wb") as f:
            pickle.dump(payload, f)

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            payload = pickle_load(f)
        if "optimizer" in payload:
            self._optimizer = payload["optimizer"]
        self._loaded_states = payload["states"]
        if self._updater is not None:
            self._consume_loaded_states()

    def _consume_loaded_states(self):
        """Loaded states into the updater: a key whose state exists is
        grafted now, an unseen key at its first update; consumed once, so
        a later ``set_optimizer`` starts fresh."""
        from ..optimizer.optimizer import _graft_state

        for k, flat in (self._loaded_states or {}).items():
            hit = next((c for c in (k, str(k))
                        if c in self._updater.states), None)
            if hit is not None:
                self._updater.states[hit] = _graft_state(
                    self._updater.states[hit], list(flat))
            else:
                self._updater.pending_loaded[k] = flat
        self._loaded_states = None


def _key_int(k):
    try:
        return int(k)
    except ValueError:
        return hash(k) % (2 ** 31)


def _flatten_state(state):
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return [leaf for s in state for leaf in _flatten_state(s)]


KVStore = KVStoreLocal
