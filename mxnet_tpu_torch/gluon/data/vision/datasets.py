"""Vision datasets (counterpart of the file-free part of
mxnet_tpu/gluon/data/vision/datasets.py).

Nothing is downloaded: MNIST idx files and CIFAR binary batches are read
with numpy from ``root`` when a user has put them there, and otherwise
(or with ``synthetic=True``) the datasets hold deterministic data of the
real shapes, made from the JAX package's ``RandomState`` seeds, so both
packages hold the same bytes. The datasets that decode image files
(``ImageFolderDataset``, ``ImageListDataset``, ``ImageRecordDataset``)
are not ported.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as _np

from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"]


class _DownloadableDataset(Dataset):
    def __init__(self, root, train, transform=None, synthetic=False):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._synthetic = synthetic
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        x = self._data[idx]
        y = self._label[idx]
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def __len__(self):
        return len(self._label)


class MNIST(_DownloadableDataset):
    """MNIST: (28, 28, 1) uint8 images and int32 labels from
    ``root/{train,t10k}-{images-idx3,labels-idx1}-ubyte[.gz]``; 1024
    synthetic training samples (256 test) without them."""

    _IMG = ("train-images-idx3-ubyte", "t10k-images-idx3-ubyte")
    _LBL = ("train-labels-idx1-ubyte", "t10k-labels-idx1-ubyte")
    _SHAPE = (28, 28, 1)
    _CLASSES = 10
    _N_SYNTH = 1024

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None, synthetic=None):
        if synthetic is None:
            synthetic = not self._files_exist(os.path.expanduser(root), train)
        super().__init__(root, train, transform, synthetic)

    @classmethod
    def _files_exist(cls, root, train):
        img = cls._IMG[0 if train else 1]
        return any(os.path.exists(os.path.join(root, img + ext))
                   for ext in ("", ".gz"))

    @staticmethod
    def _read(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            return f.read()

    def _find(self, name):
        for ext in ("", ".gz"):
            p = os.path.join(self._root, name + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            f"{name} not found under {self._root}; pass synthetic=True "
            "or place the idx files there (nothing is downloaded)")

    def _get_data(self):
        if self._synthetic:
            rng = _np.random.RandomState(42 if self._train else 43)
            n = self._N_SYNTH if self._train else self._N_SYNTH // 4
            self._data = (rng.rand(n, *self._SHAPE) * 255).astype(_np.uint8)
            self._label = rng.randint(0, self._CLASSES, n).astype(_np.int32)
            return
        idx = 0 if self._train else 1
        raw = self._read(self._find(self._IMG[idx]))
        magic, n, rows, cols = struct.unpack(">IIII", raw[:16])
        assert magic == 2051
        self._data = _np.frombuffer(raw, _np.uint8, offset=16).reshape(
            n, rows, cols, 1)
        raw = self._read(self._find(self._LBL[idx]))
        magic, n = struct.unpack(">II", raw[:8])
        assert magic == 2049
        self._label = _np.frombuffer(raw, _np.uint8, offset=8).astype(
            _np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None, synthetic=None):
        super().__init__(root, train, transform, synthetic)


class CIFAR10(_DownloadableDataset):
    """CIFAR-10: (32, 32, 3) uint8 images and int32 labels from the binary
    batches ``root/data_batch_{1..5}.bin`` (``test_batch.bin``); 1024
    synthetic training samples (256 test) when ``root`` is no
    directory."""

    _SHAPE = (32, 32, 3)
    _CLASSES = 10
    _N_SYNTH = 1024

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None, synthetic=None):
        if synthetic is None:
            synthetic = not os.path.isdir(os.path.expanduser(root))
        super().__init__(root, train, transform, synthetic)

    def _get_data(self):
        if self._synthetic:
            rng = _np.random.RandomState(44 if self._train else 45)
            n = self._N_SYNTH if self._train else self._N_SYNTH // 4
            self._data = (rng.rand(n, *self._SHAPE) * 255).astype(_np.uint8)
            self._label = rng.randint(0, self._CLASSES, n).astype(_np.int32)
            return
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                 if self._train else ["test_batch.bin"])
        data, labels = [], []
        for fname in files:
            raw = _np.fromfile(os.path.join(self._root, fname), _np.uint8)
            raw = raw.reshape(-1, 1 + 3072)
            labels.append(raw[:, 0].astype(_np.int32))
            data.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        self._data = _np.concatenate(data)
        self._label = _np.concatenate(labels)


class CIFAR100(CIFAR10):
    _CLASSES = 100

    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=True, transform=None, synthetic=None):  # noqa: ARG002
        super().__init__(root, train, transform, synthetic)
