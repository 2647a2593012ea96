"""Datasets (counterpart of mxnet_tpu/gluon/data/dataset.py)."""
from __future__ import annotations

import os

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([s for s in self if fn(s)])

    def shard(self, num_shards, index):
        """Every ``num_shards``-th sample from ``index`` on."""
        assert 0 <= index < num_shards
        return _SubsetDataset(self, list(range(index, len(self), num_shards)))

    def take(self, count):
        """The first ``count`` samples (None: all)."""
        n = len(self) if count is None else min(count, len(self))
        return _SubsetDataset(self, list(range(n)))

    def sample(self, sampler):
        """The samples at a Sampler's indices, in its order."""
        from .sampler import Sampler

        if not isinstance(sampler, Sampler):
            raise TypeError(f"expected Sampler, got {type(sampler)}")
        return _SubsetDataset(self, list(sampler))

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        def first(*sample):
            if len(sample) == 1:
                return fn(sample[0])
            return (fn(sample[0]),) + sample[1:]

        return self.transform(_TupleSpread(first), lazy)


class _TupleSpread:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, sample):
        if isinstance(sample, tuple):
            return self._fn(*sample)
        return self._fn(sample)


class _SubsetDataset(Dataset):
    def __init__(self, dataset, indices):
        self._dataset = dataset
        self._indices = indices

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]

    def __len__(self):
        return len(self._indices)


class _LazyTransformDataset(Dataset):
    def __init__(self, dataset, fn):
        self._dataset = dataset
        self._fn = fn

    def __getitem__(self, idx):
        item = self._dataset[idx]
        if isinstance(self._fn, _TupleSpread):
            return self._fn(item)
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)

    def __len__(self):
        return len(self._dataset)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __getitem__(self, idx):
        return self._data[idx]

    def __len__(self):
        return len(self._data)


class ArrayDataset(Dataset):
    """Zip of equal-length arrays."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        for a in args:
            assert len(a) == self._length
        self._data = args

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The records of a RecordIO file, by position, through its ``.idx``
    sidecar (keys need not start at 0)."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO

        idx_path = os.path.splitext(filename)[0] + ".idx"
        if not os.path.exists(idx_path):
            raise FileNotFoundError(
                f"RecordFileDataset requires the index sidecar "
                f"{idx_path!r}")
        self._record = MXIndexedRecordIO(filename)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record)
