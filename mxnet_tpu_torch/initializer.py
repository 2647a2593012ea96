"""Weight initializers (counterpart of mxnet_tpu/initializer.py).

Each draws from an explicit ``torch.Generator``. Values are drawn on the
host in f32 (whatever device scope is active) and then cast and moved to
the parameter's device, so one seed gives the same weights on the CPU and
on the card. The streams are torch's, not JAX's: a seed gives other
numbers than the JAX package (the constant and structured initializers,
``Constant``, ``Bilinear``, ``LSTMBias``, ``Load`` and the suffix table,
give the same ones).

Dispatch follows the JAX package's protocol (``Initializer.__call__``):
a declared init carried in ``InitDesc.attrs['__init__']`` wins;
``explicit=True`` forces the initializer's own draw; otherwise names
ending in ``bias``, ``beta`` or a running or moving mean get 0, and
``gamma`` or a running or moving var 1. ``Mixed`` and ``Load`` override
``__call__`` and drive every parameter. ``gluon.Parameter`` calls the
global initializer with its declared init in an ``InitDesc`` and
``explicit`` set when it declares none. ``RNNFused`` waits for
``gluon/rnn``.
"""
from __future__ import annotations

import json
import math
import re

import numpy as _np
import torch

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "Load", "register", "create"]

_REG = {}


def register(klass, name=None):
    """Register ``klass`` under its lowercase name (or ``name``)."""
    _REG[(name or klass.__name__).lower()] = klass
    return klass


def create(init, **kwargs):
    """An :class:`Initializer` from an instance, a registered name
    (case-insensitive) or the serialized ``'["name", {kwargs}]'`` form of
    :meth:`Initializer.dumps`."""
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        if init.startswith("["):
            init, kwargs = json.loads(init)
        key = init.lower()
        if key not in _REG:
            raise KeyError(f"initializer '{init}' is not registered. "
                           f"Known: {sorted(_REG)}")
        return _REG[key](**kwargs)
    raise TypeError(f"cannot create initializer from {init!r}")


def _host(shape):
    return torch.empty(shape, dtype=torch.float32, device="cpu")


def _assign(arr, data):
    """Write ``data`` into ``arr`` (a tensor, in place, or an NDArray,
    whose handle is swapped as the JAX package's is), in ``arr``'s dtype
    and on its device."""
    t = getattr(arr, "_data", None)
    if t is None:
        with torch.no_grad():
            arr.copy_(data)
        return
    arr._data = data.to(device=t.device, dtype=t.dtype)
    arr._version += 1


class Initializer:
    """Base initializer. A subclass draws in ``_init_weight(name, shape,
    generator)``, an f32 host tensor."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``'["name", {kwargs}]'``, which :func:`create` reads back."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, name, arr=None, explicit=False, generator=None):
        """Initialize ``arr`` (a tensor or an NDArray) in place, drawing
        from ``generator``, by the dispatch protocol of the module note;
        returns ``arr``."""
        if arr is None:
            name, arr = getattr(name, "name", str(name)), name
        attrs = getattr(name, "attrs", None) or {}
        declared = attrs.get("__init__")
        name = str(name)
        shape = tuple(arr.shape)
        lname = name.lower()
        if declared is not None:
            data = create(declared)._init_weight(name, shape, generator)
        elif explicit:
            data = self._init_weight(name, shape, generator)
        elif lname.endswith(("bias", "beta", "running_mean",
                             "moving_mean")):
            data = torch.zeros(shape)
        elif lname.endswith(("gamma", "running_var", "moving_var")):
            data = torch.ones(shape)
        else:
            data = self._init_weight(name, shape, generator)
        _assign(arr, data)
        return arr

    def init_array(self, name, shape, dtype, device, generator,
                   explicit=False):
        """A new tensor of ``shape`` and ``dtype`` on ``device``,
        initialized by ``self(name, ...)``."""
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        self(name, out, explicit=explicit, generator=generator)
        return out

    def init_tensor(self, shape, dtype, device, generator):
        """This initializer's own draw as a new tensor (no dispatch)."""
        return self.init_array("", shape, dtype, device, generator,
                               explicit=True)

    def _init_weight(self, name, shape, generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


class InitDesc(str):
    """A parameter's name carrying its init attributes (``attrs``, the
    declared init under ``'__init__'``): a ``str``, so it goes wherever a
    name goes."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


@register
class Zero(Initializer):
    def _init_weight(self, name, shape, generator):  # noqa: ARG002
        return torch.zeros(shape)


@register
class One(Initializer):
    def _init_weight(self, name, shape, generator):  # noqa: ARG002
        return torch.ones(shape)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, shape, generator):  # noqa: ARG002
        return torch.full(shape, float(self.value))


@register
class Uniform(Initializer):
    """U(-scale, scale); 0.07 is the default the Gluon blocks use."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, shape, generator):  # noqa: ARG002
        return _host(shape).uniform_(-self.scale, self.scale,
                                     generator=generator)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, shape, generator):  # noqa: ARG002
        return _host(shape).normal_(0.0, self.sigma, generator=generator)


@register
class Orthogonal(Initializer):
    """A (scaled) orthogonal matrix over ``(shape[0], prod(shape[1:]))``:
    the Q of a QR of a Gaussian matrix, signs fixed by R's diagonal, as
    ``jax.nn.initializers.orthogonal`` draws it (``rand_type`` is taken and
    ignored, as in the JAX package)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale

    def _init_weight(self, name, shape, generator):  # noqa: ARG002
        rows, cols = shape[0], int(_np.prod(shape[1:]))
        a = _host((max(rows, cols), min(rows, cols))).normal_(
            generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.scale * q).reshape(shape).contiguous()


def _fans(shape, factor_type):
    """The fan the Xavier scale divides by: ``in``, ``out`` or their
    ``avg`` (initializer.py:_fans)."""
    hw = 1
    for d in shape[2:]:
        hw *= d
    fan_out = shape[0] * hw
    fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
    if factor_type == "avg":
        return (fan_in + fan_out) / 2.0
    if factor_type == "in":
        return fan_in
    return fan_out


@register
class Xavier(Initializer):
    """Xavier/Glorot: U(-s, s) or N(0, s^2) with ``s = sqrt(magnitude /
    fan)``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = magnitude

    def _init_weight(self, name, shape, generator):  # noqa: ARG002
        factor = max(_fans(shape, self.factor_type), 1.0)
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            return _host(shape).uniform_(-scale, scale, generator=generator)
        return _host(shape).normal_(0.0, scale, generator=generator)


@register
class MSRAPrelu(Xavier):
    """He initialization: Gaussian Xavier with magnitude ``2 / (1 +
    slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel (for a transposed convolution)."""

    def _init_weight(self, name, shape, generator):  # noqa: ARG002
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = _np.arange(int(_np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = (1 - _np.abs(x / f - c)) * (1 - _np.abs(y / f - c))
        return torch.from_numpy(w.astype(_np.float32).reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (the second) set to
    ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, shape, generator):  # noqa: ARG002
        b = torch.zeros(shape)
        n = shape[0] // 4
        b[n:2 * n] = self.forget_bias
        return b


class Mixed(Initializer):
    """Parameters routed to initializers by the first regex of
    ``patterns`` that matches their name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must pair up")
        self.map = [(re.compile(p), create(i))
                    for p, i in zip(patterns, initializers)]

    def __call__(self, name, arr=None, explicit=False,  # noqa: ARG002
                 generator=None):
        if arr is None:
            name, arr = getattr(name, "name", str(name)), name
        name = str(name)  # the pattern drives, not a declared init
        for prog, init in self.map:
            if prog.match(name):
                return init(name, arr, explicit=True, generator=generator)
        raise ValueError(
            f"Parameter name {name} did not match any pattern; consider "
            "adding a '.*' pattern at the end with a default initializer")


class Load(Initializer):
    """Values from a name-to-array dict or a saved file (``arg:``/``aux:``
    prefixes dropped), ``default_init`` for names it lacks."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        if isinstance(param, str):
            from .ndarray.utils import load

            param = load(param, device="cpu")
        self.param = {}
        for name, arr in dict(param).items():
            key = name[4:] if name.startswith(("arg:", "aux:")) else name
            self.param[key] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr=None, explicit=False,  # noqa: ARG002
                 generator=None):
        if arr is None:
            name, arr = getattr(name, "name", str(name)), name
        name = str(name)
        if name in self.param:
            src = self.param[name]
            src = getattr(src, "_data", src)
            src = src if isinstance(src, torch.Tensor) else \
                torch.from_numpy(_np.array(src))
            if tuple(arr.shape) != tuple(src.shape):
                raise ValueError(
                    f"Parameter {name} cannot be initialized from "
                    f"loading: shape mismatch, target {tuple(arr.shape)} "
                    f"vs loaded {tuple(src.shape)}")
            _assign(arr, src)
            return arr
        if self.default_init is None:
            raise ValueError(
                f"Cannot initialize {name}: not in the loaded params and "
                "no default initializer was provided")
        return create(self.default_init)(name, arr, explicit=True,
                                         generator=generator)


register(Zero, "zeros")
register(One, "ones")
register(Xavier, "xavier")
register(MSRAPrelu, "msra")
register(Normal, "gaussian")
