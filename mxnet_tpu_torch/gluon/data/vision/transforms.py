"""Vision transforms (counterpart of
mxnet_tpu/gluon/data/vision/transforms.py).

Transforms take and return host numpy HWC images, as the JAX package's do:
they run in the loader's workers, and the batched device work stays with
the training step. The random ones draw from numpy's global RNG, as there,
so the same ``np.random.seed`` gives the same crops and flips. ``Resize``
is bilinear with an antialiasing filter on a downscale, as
``jax.image.resize`` is there; here it is ``F.interpolate(...,
antialias=True)`` on the CPU, which differs from it by float rounding
(``tests/test_torch_data_transforms.py`` states the tolerance).
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from ...block import Block
from ...nn.basic_layers import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomLighting"]


def _as_np(x):
    from ....ndarray.ndarray import NDArray

    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


class Compose(Sequential):
    """Apply transforms in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t if isinstance(t, Block) else _Fn(t))


class _Fn(Block):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, x):
        return self._fn(x)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _as_np(x).astype(self._dtype)


class ToTensor(Block):
    """HWC uint8 in [0, 255] to CHW float32 in [0, 1]."""

    def forward(self, x):
        x = _as_np(x)
        if x.ndim == 2:
            x = x[:, :, None]
        return (x.astype(_np.float32) / 255.0).transpose(2, 0, 1)


class Normalize(Block):
    """``(x - mean) / std`` a channel, on CHW."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, _np.float32).reshape(-1, 1, 1)
        self._std = _np.asarray(std, _np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        return (_as_np(x) - self._mean) / self._std


def _resize_np(img, size):
    """An HWC image resized to ``size`` (an int: square; else (w, h)) as
    float32, bilinear with half-pixel centres, antialiased when it
    shrinks."""
    h, w = (size, size) if isinstance(size, int) else (size[1], size[0])
    x = torch.from_numpy(_np.ascontiguousarray(img, _np.float32))
    x = x.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                        antialias=True)
    return out[0].permute(1, 2, 0).numpy()


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):  # noqa: ARG002
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def forward(self, x):
        x = _as_np(x)
        if x.ndim == 2:
            x = x[:, :, None]
        size = self._size
        if self._keep and isinstance(size, int):
            # an int size with keep_ratio scales the short side to it,
            # the long side by floor division
            h, w = x.shape[:2]
            if h < w:
                size = (max(1, size * w // h), size)  # (w, h)
            else:
                size = (size, max(1, size * h // w))
        return _resize_np(x, size)


class CenterCrop(Block):
    def __init__(self, size):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        x = _as_np(x)
        w, h = self._size
        y0 = max((x.shape[0] - h) // 2, 0)
        x0 = max((x.shape[1] - w) // 2, 0)
        return x[y0 : y0 + h, x0 : x0 + w]


class RandomCrop(Block):
    def __init__(self, size, pad=None):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def forward(self, x):
        x = _as_np(x)
        if self._pad:
            p = self._pad
            x = _np.pad(x, ((p, p), (p, p), (0, 0)), mode="constant")
        w, h = self._size
        y0 = _np.random.randint(0, max(x.shape[0] - h, 0) + 1)
        x0 = _np.random.randint(0, max(x.shape[1] - w, 0) + 1)
        return x[y0 : y0 + h, x0 : x0 + w]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):  # noqa: ARG002
        super().__init__()
        self._size = size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        x = _as_np(x)
        area = x.shape[0] * x.shape[1]
        for _ in range(10):
            target = _np.random.uniform(*self._scale) * area
            ar = _np.random.uniform(*self._ratio)
            w = int(round((target * ar) ** 0.5))
            h = int(round((target / ar) ** 0.5))
            if w <= x.shape[1] and h <= x.shape[0]:
                y0 = _np.random.randint(0, x.shape[0] - h + 1)
                x0 = _np.random.randint(0, x.shape[1] - w + 1)
                return _resize_np(x[y0 : y0 + h, x0 : x0 + w], self._size)
        return _resize_np(x, self._size)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        x = _as_np(x)
        return x[:, ::-1] if _np.random.rand() < 0.5 else x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        x = _as_np(x)
        return x[::-1] if _np.random.rand() < 0.5 else x


class _Jitter(Block):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _factor(self):
        return 1.0 + _np.random.uniform(-self._amount, self._amount)


class RandomBrightness(_Jitter):
    def forward(self, x):
        return _np.clip(_as_np(x).astype(_np.float32) * self._factor(),
                        0, 255)


class RandomContrast(_Jitter):
    def forward(self, x):
        x = _as_np(x).astype(_np.float32)
        mean = x.mean()
        return _np.clip((x - mean) * self._factor() + mean, 0, 255)


class RandomSaturation(_Jitter):
    def forward(self, x):
        x = _as_np(x).astype(_np.float32)
        gray = x.mean(axis=-1, keepdims=True)
        return _np.clip((x - gray) * self._factor() + gray, 0, 255)


class RandomLighting(Block):
    """AlexNet's PCA lighting noise."""

    _eigval = _np.array([55.46, 4.794, 1.148], _np.float32)
    _eigvec = _np.array(
        [[-0.5675, 0.7192, 0.4009],
         [-0.5808, -0.0045, -0.814],
         [-0.5836, -0.6948, 0.4203]], _np.float32)

    def __init__(self, alpha=0.1):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        x = _as_np(x).astype(_np.float32)
        a = _np.random.normal(0, self._alpha, 3).astype(_np.float32)
        rgb = (self._eigvec @ (a * self._eigval)).reshape(1, 1, 3)
        return _np.clip(x + rgb, 0, 255)
