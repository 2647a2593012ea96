"""Gluon Parameter over ``torch.nn.Parameter`` (counterpart of
mxnet_tpu/gluon/parameter.py).

Keeps the JAX package's surface: ``shape``, ``dtype``, ``init``, deferred
initialization for unknown dims (``in_units=0``) completed by the layer's
first forward, ``data()`` and ``set_data()``. The value is a
``torch.nn.Parameter`` on one device. ``data()`` returns an NDArray over
that tensor, as the JAX package returns its NDArray; the port's own layers,
trainer and converters read the tensor through ``_tensor()``. Every Block
that holds the Parameter
also exposes that tensor to ``nn.Module`` under the same attribute name, so
``named_parameters()`` gives the dotted keys ``collect_params()`` gives.

Gradients follow MXNet's ``grad_req``, not torch's habit of accumulating
into ``.grad``: a hook that torch runs once per backward, after it has
summed every use of the tensor, moves ``.grad`` into the Parameter's own
buffer ('write' replaces the buffer, 'add' adds to it, 'null' has none) and
bumps a version counter. ``grad()`` returns that buffer, and the Trainer
reads the counter to tell a fresh gradient from a stale one.

Whenever a Parameter's tensor is replaced (initialization, ``cast``), the
process-wide :func:`storage_epoch` moves. A CUDA graph captured over the
weights keeps their addresses, so whoever replays one compares the epoch,
one integer, on every call, and walks the weights' addresses only when it
moved (gluon/_graph.py). ``set_data`` and the optimizer write in place and
move nothing: a graph sees those values.

A sharding plan places a Parameter (``parallel.mesh.shard_params``,
``ShardingPlan.apply``): it then also holds a :class:`~mxnet_tpu_torch.
parallel.mesh.Placed`, one contiguous allocation a mesh position holding
the position's block under the plan's spec (replicated specs: a copy a
position). The tensor the layers read stays the logical value, as
``data()`` and ``list_data()`` give it in the JAX package (where
``asnumpy()`` gathers every shard); the optimizer updates the positions'
blocks and gathers them back into it (gluon/_sharded.py), and ``set_data``,
a load, a write through ``data()`` and a re-initialization write through to
every position. ``one_device`` still holds for the logical value.
"""
from __future__ import annotations

import itertools

import torch

from .. import device as _device
from .. import initializer as init_mod
from ..base import DeferredInitializationError, normalize_dtype
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "Constant", "storage_epoch"]

_EPOCHS = itertools.count(1)
_EPOCH = [0]


def storage_epoch():
    """A number that changes whenever any Parameter's tensor is replaced."""
    return _EPOCH[0]


def _storage_replaced():
    _EPOCH[0] = next(_EPOCHS)


class _ParameterArray(NDArray):
    """The NDArray ``Parameter.data()`` returns: an in-place write copies
    into the parameter's tensor instead of swapping the handle, so the
    parameter holds what was written (and its positions, when placed)."""

    __slots__ = ("_param",)

    def _assign(self, data):
        with torch.no_grad():
            self._data.copy_(data)
        placement = self._param._placement
        if placement is not None:
            placement.write(self._data)
        self._version += 1


def _shape_known(shape):
    return shape is not None and all(
        d is not None and int(d) > 0 for d in shape)


def one_device(device, name):
    """A ``torch.device`` from ``device`` or a list of one (None: the
    current device; ``cuda`` the current card); ``name``'s parameters live
    on one device in the port, so more raise."""
    devices = device if isinstance(device, (list, tuple)) else [device]
    devices = {_device.resolve(d) for d in devices}
    devices = {_device.gpu(torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices}
    if len(devices) != 1:
        raise ValueError(f"{name}: one device a parameter in the port, got "
                         f"{sorted(map(str, devices))}")
    return devices.pop()


class Parameter:
    def __init__(self, name="weight", grad_req="write", shape=None,
                 dtype="float32", lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):  # noqa: ARG002
        if grad_req not in ("write", "add", "null"):
            raise ValueError(
                f"grad_req must be 'write', 'add' or 'null', got {grad_req!r}")
        if grad_stype not in ("default", "row_sparse"):
            raise ValueError(f"grad_stype must be 'default' or "
                             f"'row_sparse', got {grad_stype!r}")
        # row_sparse: the gradient buffer stays dense (autograd sums the
        # lookups' gradients into it), and the forward records the rows it
        # touched, so the Trainer hands the optimizer only those rows
        # (_as_row_sparse_grad) and a lazy update writes only them
        self.grad_stype = grad_stype
        self._sparse_row_hints = []   # id tensors recorded by Embedding
        self._name = name
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = normalize_dtype(dtype)
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        self._grad = None      # the gradient buffer (zeros until a backward)
        self._grad_version = 0  # bumped whenever the buffer is written
        self._var = None       # torch.nn.Parameter once initialized
        self._deferred = None  # (init, device, generator) until shape known
        self._owners = []      # (module, attribute) exposing _var
        # the collect_params() key of the Block that initialized it, which
        # Load and Mixed route by
        self._structured_name = None
        # parallel.mesh.Placed: the positions' blocks under a sharding plan
        self._placement = None

    # -- identity ----------------------------------------------------------
    @property
    def name(self):
        return self._name

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        if len(new_shape) != len(self._shape):
            raise ValueError(f"Parameter {self.name}: shape mismatch "
                             f"{self._shape} vs {tuple(new_shape)}")
        # fill unknown dims; known dims must match
        merged = []
        for old, new in zip(self._shape, new_shape):
            if old in (0, -1, None):
                merged.append(new)
            else:
                if new not in (0, -1, None) and int(old) != int(new):
                    raise ValueError(
                        f"Parameter {self.name}: shape mismatch "
                        f"{self._shape} vs {tuple(new_shape)}")
                merged.append(old)
        self._shape = tuple(merged)

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={self.dtype})")

    # -- initialization ----------------------------------------------------
    def initialize(self, init=None, device=None, default_init=None,
                   generator=None, force_reinit=False, ctx=None):
        """Draw the value on ``device`` from ``generator``, by the JAX
        package's protocol (gluon/parameter.py:_finish_init): the global
        initializer ``default_init`` (Uniform by default) is called with
        the declared ``init`` (or ``self.init``) in an ``InitDesc``, so a
        declared init wins over a standard global one, while ``Mixed`` and
        ``Load`` drive every parameter. With an unknown shape the draw
        waits for the layer's first forward. ``ctx`` is ``device``'s old
        name; without either the current device is taken, as in the JAX
        package (parameter.py:123)."""
        if self._var is not None and not force_reinit:
            return
        device = one_device(device if device is not None else ctx,
                            f"Parameter {self.name}")
        declared = init if init is not None else self.init
        inits = (declared, default_init if default_init is not None
                 else init_mod.Uniform())
        if not _shape_known(self._shape):
            if not self.allow_deferred_init:
                raise ValueError(
                    f"Cannot initialize Parameter {self.name}: unknown "
                    f"shape {self._shape} and allow_deferred_init=False")
            self._deferred = (inits, torch.device(device), generator)
            return
        self._finish_init(inits, torch.device(device), generator)

    def _finish_init(self, inits, device, generator):
        declared, global_init = inits
        desc = init_mod.InitDesc(
            self._structured_name or self.name,
            {"__init__": declared} if declared is not None else {})
        with torch.inference_mode(False):
            data = init_mod.create(global_init).init_array(
                desc, self._shape, self.dtype, device, generator,
                explicit=declared is None)
            self._set_var(data)
        self._deferred = None

    def _set_var(self, data):
        # callers make ``data`` outside inference mode: the value outlives
        # any inference_mode scope (call_cached_graph) it was made under
        # the hook can only be registered while the tensor requires a
        # gradient; a 'null' parameter (BatchNorm's running stats) turns it
        # off right after, and a later grad_req change turns it on again
        self._var = torch.nn.Parameter(data, requires_grad=True)
        _storage_replaced()
        self._var.register_post_accumulate_grad_hook(self._land_grad)
        self._var.requires_grad_(self.grad_req != "null")
        self._grad = None
        for module, attr in self._owners:
            module._parameters[attr] = self._var
        if self._placement is not None:
            self._place(self._placement.layout)

    def _finish_deferred_init(self, shape=None):
        """Complete deferred init once the full shape is known."""
        if shape is not None:
            self.shape = shape
        if self._deferred is None:
            raise DeferredInitializationError(
                f"Parameter {self.name} was not initialized "
                "(call .initialize() first)")
        if not _shape_known(self._shape):
            raise DeferredInitializationError(
                f"Parameter {self.name}: shape still unknown {self._shape}")
        self._finish_init(*self._deferred)

    @property
    def _is_deferred(self):
        return self._var is None and self._deferred is not None

    @property
    def device(self):
        """The device the value lives (or will live) on."""
        if self._var is not None:
            return self._var.device
        if self._deferred is not None:
            return self._deferred[1]
        raise RuntimeError(f"Parameter {self.name} has not been initialized")

    # -- data access -------------------------------------------------------
    def data(self, ctx=None, device=None):
        """The value as an NDArray over the parameter's own storage
        (mxnet_tpu/gluon/parameter.py:253): it reads the current value, a
        write through it (``p.data()[:] = x``) lands in the parameter, and
        a computation recorded on it sends its gradient to :meth:`grad`.
        A ``device`` (``ctx``) other than the parameter's raises."""
        t = self._tensor()
        device = device if device is not None else ctx
        if device is not None and torch.device(device) != t.device:
            raise RuntimeError(f"Parameter {self.name} not initialized on "
                               f"{device}; it lives on {t.device}")
        arr = _ParameterArray(t)
        arr._param = self
        return arr

    def data_for(self, x):  # noqa: ARG002 - one device a parameter
        """The copy co-located with ``x`` (parameter.py:273): the one
        value, a parameter lives on one device in the port."""
        return self.data()

    def logical_data(self, ctx=None, device=None):
        """The value in the parameter's logical layout (parameter.py:283):
        the port keeps no other physical layout, so :meth:`data`."""
        return self.data(ctx=ctx, device=device)

    def list_data(self):
        """``[data()]`` (parameter.py:294): one logical value, placed or
        not."""
        return [self.data()]

    # -- placement under a sharding plan -----------------------------------
    def _place(self, layout):
        """Hold the value's blocks under ``layout`` (a
        ``parallel.mesh.Layout``), one new allocation a position, copied
        from the logical value (module note)."""
        from ..parallel.mesh import Placed

        with torch.no_grad():
            self._placement = Placed.from_tensor(self._tensor().detach(),
                                                 layout)

    def _unplace(self):
        """Drop the positions' blocks; the logical value stays."""
        self._placement = None

    @property
    def placement(self):
        """The ``parallel.mesh.Placed`` of the positions' blocks, or None
        when no plan placed the parameter."""
        return self._placement

    def list_ctx(self):
        """The devices holding a copy: ``[device]``."""
        return [self._tensor().device]

    list_device = list_ctx

    def reset_device(self, device=None, ctx=None):
        """Move the value to ``device`` (``ctx``; a list of one device is
        taken too) (parameter.py:393). The tensor is replaced, so
        :func:`storage_epoch` moves, and the gradient buffer starts from
        zeros there. A parameter lives on one device in the port: two
        devices raise."""
        device = one_device(device if device is not None else ctx,
                            f"Parameter {self.name}")
        value = self._tensor()
        with torch.inference_mode(False), torch.no_grad():
            self._set_var(value.detach().to(device, copy=True))

    reset_ctx = reset_device

    def _tensor(self):
        """The value, a ``torch.nn.Parameter``: what the port's layers,
        trainer and converters read."""
        if self._var is None:
            if self._deferred is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name} deferred-init pending")
            raise RuntimeError(
                f"Parameter {self.name} has not been initialized. "
                "Call .initialize() on the Block first")
        return self._var

    def set_data(self, data):
        """Copy ``data`` in, cast to this parameter's dtype, on its device.
        A deferred-init parameter takes its shape from ``data``."""
        data = torch.as_tensor(data)
        if self._var is None:
            if self._deferred is None:
                raise RuntimeError(
                    f"Parameter {self.name} has not been initialized; call "
                    ".initialize() before set_data")
            self._load_init(data, None)
            return
        if tuple(data.shape) != tuple(self._var.shape):
            raise ValueError(
                f"Parameter {self.name}: set_data shape {tuple(data.shape)} "
                f"!= {tuple(self._var.shape)}")
        with torch.inference_mode(False), torch.no_grad():
            self._var.copy_(data)
            if self._placement is not None:
                self._placement.write(self._var)

    def _load_init(self, data, device):
        """Take ``data``, its shape and its value, into a parameter that
        holds no value yet (``set_data`` of a deferred parameter,
        ``Block.load_parameters``): a deferred parameter on the device it
        was given, another on ``device``. A known dim that differs raises
        ``ValueError``."""
        self.shape = tuple(data.shape)
        if self._deferred is not None:
            device = self._deferred[1]
        with torch.inference_mode(False):
            self._set_var(data.to(device=device, dtype=self.dtype,
                                  copy=True))
        self._deferred = None

    # -- gradients ---------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        """Live: 'add' starts accumulating into fresh zeros, 'null' drops
        the buffer, a non-differentiable parameter stays 'null'."""
        if req not in ("write", "add", "null"):
            raise ValueError(
                f"grad_req must be 'write', 'add' or 'null', got {req!r}")
        if not self._differentiable:
            req = "null"
        if req == self._grad_req:
            return
        self._grad_req = req
        self._grad = None
        if self._var is not None:
            self._var.requires_grad_(req != "null")
            self._var.grad = None

    def _land_grad(self, var):
        # runs once per backward, after torch has summed every use of var
        g, var.grad = var.grad, None
        if g is None:      # an autograd.Function's None gradient
            return
        if self._grad_req == "add" and self._grad is not None:
            with torch.no_grad():
                self._grad.add_(g)
        else:
            self._grad = g  # 'write': the new gradient replaces the buffer
        self._grad_version += 1

    def grad(self, ctx=None, device=None):
        """The gradient buffer, in the parameter's dtype and on its device
        (zeros before the first backward). A ``device`` (``ctx``) other
        than the parameter's raises ``KeyError``, as the JAX package's
        lookup does (parameter.py:298)."""
        device = device if device is not None else ctx
        if device is not None and one_device(
                device, f"Parameter {self.name}") != self.device:
            raise KeyError(device)
        if self.grad_req == "null":
            raise RuntimeError(
                f"Parameter {self.name} has grad_req='null'")
        if self._grad is None:
            self._grad = torch.zeros_like(self._tensor(),
                                          requires_grad=False)
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self.grad_req != "null" and self._var is not None:
            self.grad().zero_()
            self._grad_version += 1
        self._sparse_row_hints = []

    def _record_sparse_rows(self, ids):
        """Keep the row ids a sparse-gradient layer's forward looked up:
        only while recording, and not inside an active hybridized block,
        where the JAX package's forward is traced and sees no concrete ids
        (its update is then dense, and so is the port's)."""
        if self.grad_stype != "row_sparse" or self.grad_req == "null":
            return
        from .. import autograd as _ag
        from .block import in_hybridized_forward

        if not _ag.is_recording() or in_hybridized_forward():
            return
        self._sparse_row_hints.append(ids.detach().reshape(-1))

    def _as_row_sparse_grad(self, g):
        """The dense gradient ``g`` as a RowSparseNDArray over the unique
        rows touched since the last update, found on ``g``'s device; ``g``
        itself where no rows were recorded (a hybridized forward)."""
        if not self._sparse_row_hints:
            return g
        from ..ndarray.sparse import RowSparseNDArray

        ids = torch.cat([h.to(device=g.device, dtype=torch.int64)
                         for h in self._sparse_row_hints])
        self._sparse_row_hints = []
        rows = torch.unique(ids)
        return RowSparseNDArray(g.index_select(0, rows), rows, g.shape)

    def cast(self, dtype):
        """Change the dtype of the value and of its gradient buffer."""
        self.dtype = normalize_dtype(dtype)
        if self._var is not None:
            with torch.inference_mode(False), torch.no_grad():
                self._var.data = self._var.data.to(self.dtype)
                _storage_replaced()
                if self._grad is not None:
                    self._grad = self._grad.to(self.dtype)
                if self._placement is not None:
                    self._place(self._placement.layout)


class Constant(Parameter):
    """A parameter that holds ``value`` and takes no gradient
    (parameter.py:433): ``initialize`` copies the value to the device, the
    global initializer is not called."""

    def __init__(self, value, name="const"):
        if isinstance(value, NDArray):
            value = value._data
        if not isinstance(value, torch.Tensor):
            from ..ndarray.ndarray import _host_to_tensor

            value = _host_to_tensor(value, None, torch.device("cpu"))
        super().__init__(name=name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, differentiable=False,
                         init=init_mod.Constant(0.0))
        self._value = value.detach()

    def _finish_init(self, inits, device, generator):  # noqa: ARG002
        with torch.inference_mode(False):
            self._set_var(self._value.to(device=device, dtype=self.dtype,
                                         copy=True))
        self._deferred = None
