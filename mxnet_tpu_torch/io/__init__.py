"""The data-iterator API (counterpart of mxnet_tpu/io/__init__.py):
``DataDesc``, ``DataBatch``, ``DataIter`` and the iterators over arrays,
CSV, LibSVM and MNIST files, ``ResizeIter`` and ``PrefetchingIter``.
Batches are NDArrays on the current device (``with mx.cpu():`` on the
CPU). ``ImageRecordIter`` decodes images and is not ported; LibSVM
batches are :class:`CSRBatch` holders until the port has sparse arrays.
"""
from __future__ import annotations

import os
from collections import namedtuple

import numpy as _np
import torch

from .. import numpy as mnp
from ..ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "MNISTIter", "ResizeIter", "PrefetchingIter",
           "CSRBatch"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    """One batch: lists of data and label arrays and the pad count."""

    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        raise NotImplementedError

    def __next__(self):
        return self.next()

    def iter_next(self):
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            return False

    def getdata(self):
        return self._next_batch.data

    def getlabel(self):
        return self._next_batch.label

    def getpad(self):
        return self._next_batch.pad


class NDArrayIter(DataIter):
    """Batches of in-memory arrays: ``shuffle`` (numpy's global RNG, at
    each reset), ``last_batch_handle`` pad, discard or roll_over."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self._data = self._init_arrays(data, data_name)
        self._label = self._init_arrays(label, label_name)
        self._shuffle = shuffle
        self._last = last_batch_handle
        self._n = self._data[0][1].shape[0]
        self._order = _np.arange(self._n)
        self._cursor = 0
        self._leftover = None  # roll_over: the last epoch's remainder
        self.reset()

    @staticmethod
    def _init_arrays(arrays, default_name):
        if arrays is None:
            return []
        if isinstance(arrays, (list, tuple)):
            arrays = {f"{default_name}{i}" if i else default_name: a
                      for i, a in enumerate(arrays)}
        elif not isinstance(arrays, dict):
            arrays = {default_name: arrays}
        out = []
        for name, a in arrays.items():
            if isinstance(a, NDArray):
                a = a.asnumpy()
            out.append((name, _np.asarray(a)))
        return out

    @property
    def provide_data(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:], a.dtype)
                for n, a in self._data]

    @property
    def provide_label(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:], a.dtype)
                for n, a in self._label]

    def reset(self):
        if self._shuffle:
            _np.random.shuffle(self._order)
        self._cursor = 0

    def next(self):
        prefix = None
        if self._leftover is not None:
            prefix, self._leftover = self._leftover, None
        need = self.batch_size - (len(prefix) if prefix is not None else 0)
        if self._cursor >= self._n and prefix is None:
            raise StopIteration
        end = self._cursor + need
        idx = self._order[self._cursor : end]
        pad = 0
        if end > self._n:
            if self._last == "discard":
                self._cursor = end
                raise StopIteration
            if self._last == "pad":
                pad = end - self._n
                idx = _np.concatenate([idx, self._order[:pad]])
            elif self._last == "roll_over":
                # keep the short remainder for the next epoch (a copy:
                # reset() shuffles _order in place)
                self._cursor = end
                self._leftover = (_np.concatenate([prefix, idx])
                                  if prefix is not None else idx.copy())
                raise StopIteration
        self._cursor = end
        if prefix is not None:
            idx = _np.concatenate([prefix, idx])
        data = [mnp.array(a[idx]) for _, a in self._data]
        label = [mnp.array(a[idx]) for _, a in self._label]
        return DataBatch(data, label, pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


class CSVIter(NDArrayIter):
    """Batches of float32 rows of a CSV file."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        super().__init__(data, label, batch_size, **kwargs)


class CSRBatch:
    """A CSR matrix of one LibSVM batch: ``data`` (float32), ``indices``
    and ``indptr`` (int32) NDArrays and ``shape``, with the dense view
    (``todense``, ``tostype('default')``, ``asnumpy``) of the JAX
    package's ``CSRNDArray``."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape):
        self.data = mnp.array(_np.asarray(data, _np.float32))
        self.indices = mnp.array(_np.asarray(indices, _np.int32))
        self.indptr = mnp.array(_np.asarray(indptr, _np.int32))
        self.shape = tuple(int(s) for s in shape)
        self.dtype = _np.dtype(_np.float32)

    def todense(self):
        indptr = self.indptr._data.long()
        rows = torch.repeat_interleave(
            torch.arange(self.shape[0], device=indptr.device),
            indptr.diff())
        dense = torch.zeros(self.shape, dtype=torch.float32,
                            device=indptr.device)
        dense.index_put_((rows, self.indices._data.long()), self.data._data,
                         accumulate=True)
        return NDArray(dense)

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        raise ValueError(f"no storage type {stype!r} in the port")

    def asnumpy(self):
        return self.todense().asnumpy()


class LibSVMIter(DataIter):
    """Batches of ``label idx:val idx:val ...`` lines as CSR data; the
    last batch is padded with copies of its last row."""

    def __init__(self, data_libsvm, data_shape, label_shape=None,
                 batch_size=1, **kwargs):  # noqa: ARG002
        super().__init__(batch_size)
        self._num_features = int(data_shape[-1] if hasattr(
            data_shape, "__len__") else data_shape)
        labels, rows = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                rows.append([(int(kv.split(":")[0]),
                              float(kv.split(":")[1])) for kv in parts[1:]])
        self._labels = _np.asarray(labels, _np.float32)
        self._rows = rows
        self._cursor = 0

    def reset(self):
        self._cursor = 0

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._num_features))]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def __next__(self):
        if self._cursor >= len(self._rows):
            raise StopIteration
        stop = min(self._cursor + self.batch_size, len(self._rows))
        batch_rows = self._rows[self._cursor:stop]
        labels = self._labels[self._cursor:stop]
        pad = self.batch_size - len(batch_rows)
        data, indices, indptr = [], [], [0]
        for r in batch_rows + [batch_rows[-1]] * pad:
            for idx, val in r:
                indices.append(idx)
                data.append(val)
            indptr.append(len(data))
        if pad:
            labels = _np.concatenate([labels, [labels[-1]] * pad])
        csr = CSRBatch(data, indices, indptr,
                       (self.batch_size, self._num_features))
        self._cursor = stop
        return DataBatch(data=[csr], label=[mnp.array(labels)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    next = __next__


class MNISTIter(NDArrayIter):
    """MNIST (idx files under ``path_root`` or the image's directory, else
    the synthetic set) as float32 in [0, 1], NCHW or flat."""

    def __init__(self, image=None, label=None, batch_size=128, shuffle=True,
                 flat=False, path_root=None, train=True, **kwargs):  # noqa: ARG002
        from ..gluon.data.vision import MNIST

        root = path_root or os.path.dirname(image or "") or \
            "~/.mxnet/datasets/mnist"
        ds = MNIST(root=root, train=train)
        imgs = ds._data.astype(_np.float32) / 255.0
        imgs = imgs.reshape(len(imgs), -1) if flat else \
            imgs.transpose(0, 3, 1, 2)
        super().__init__(imgs, ds._label.astype(_np.float32), batch_size,
                         shuffle=shuffle)


class ResizeIter(DataIter):
    """An iterator cut or stretched to ``size`` batches an epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self._iter = data_iter
        self._size = size
        self._reset_internal = reset_internal
        self._count = 0

    def reset(self):
        self._count = 0
        if self._reset_internal:
            self._iter.reset()

    def next(self):
        if self._count >= self._size:
            raise StopIteration
        self._count += 1
        try:
            return self._iter.next()
        except StopIteration:
            self._iter.reset()
            return self._iter.next()


class PrefetchingIter(DataIter):
    """One thread runs the wrapped iterators ahead of the consumer (up to
    four batches). Its batches are made on the device current where the
    iterator was built (a device scope is thread-local)."""

    def __init__(self, iters, rename_data=None, rename_label=None):  # noqa: ARG002
        from ..device import current_device

        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self._iters = iters
        self._device = current_device()
        self._start_worker()

    def _start_worker(self):
        import queue
        import threading

        self._queue = queue.Queue(maxsize=4)
        self._stop = threading.Event()
        stop, q, device = self._stop, self._queue, self._device

        def worker():
            with device:
                while not stop.is_set():
                    try:
                        batches = [it.next() for it in self._iters]
                    except StopIteration:
                        q.put(None)
                        return
                    except Exception as e:  # raised at the consumer's next()
                        q.put(e)
                        return
                    q.put(batches)

        self._thread = threading.Thread(
            target=worker, name="mxtpu-io-prefetch", daemon=True)
        self._thread.start()

    def next(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if item is None:
            self._stop.set()
            raise StopIteration
        if isinstance(item, Exception):
            self._stop.set()
            raise item
        return item[0] if len(item) == 1 else item

    def reset(self):
        """Stop the producer, reset the wrapped iterators, start again."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except Exception:
                pass
            self._thread.join(timeout=0.05)
        for it in self._iters:
            it.reset()
        self._start_worker()


from . import io  # noqa: F401,E402  (the spelling mx.io.io.*)
