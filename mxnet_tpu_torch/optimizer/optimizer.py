"""Optimizer base and the five rules BERT training needs (counterpart of
mxnet_tpu/optimizer/optimizer.py).

API parity with the JAX package: ``create_state(index, weight)`` /
``update(index, weight, grad, state)``, ``lr_scheduler`` with lr/wd
multipliers, ``rescale_grad``, ``clip_gradient``, ``clip_global_norm`` and
``update_multi_precision`` (f32 master weights beside bf16 parameters).
Each rule is ``_rule(w, g, state, lr, wd, hyper) -> (new_w, new_state)``, a
function of tensors that allocates its results.

List inputs take the fused path, ``update_fused``: parameters are bucketed
by (weight dtype, multi-precision), their hyperparameters are resolved in
list order (so a schedule driven by ``num_update`` sees the per-parameter
sequence), and every member runs the ladder: rescale -> global-norm scale
-> per-element clip -> ``_rule`` -> cast of the master back. Each bucket
runs through kernels/opt.py:bucket_step, and under ``clip_global_norm``
its sum of squares first through kernels/opt.py:bucket_sqnorm: one launch
of the CUDA ladder kernel (and one of the norm kernels) per bucket for CUDA
tensors, and for CPU tensors the kernels' plain versions,
``_fused_param_step`` and ``_fused_sqnorm`` over the bucket.

Updates are IN PLACE under ``torch.no_grad()``: the weight, the master and
the state tensors keep their identity and are overwritten, which is the
port's form of the JAX package's buffer donation.

Scalars follow the JAX package's weak-typed f32 scalars: a hyperparameter
is rounded to f32 before it meets a tensor, and expressions of scalars only
(``1 - beta1``, ``beta2 ** t``, Adam's ``lr_t``) are evaluated in f32. A
weak type takes the array's dtype, so where a scalar meets a bf16 or f16
tensor (a low-precision weight without an f32 master) it is rounded on to
that dtype, and each op rounds its result to it, as in the JAX package.

Every rule of the JAX package is here: SGD, NAG, Signum and Adam/AdamW,
which the CUDA ladder kernel also runs; SGLD, DCASGD, Nadam, AdaBelief,
Adamax, FTML, RMSProp, AdaGrad, AdaDelta, Ftrl, LAMB, LANS, LARS and
GroupAdaGrad, which run as plain PyTorch on every device, as the JAX
package's XLA path runs them (its Pallas ladder takes the first five only).
A rule that reads its update count computes ``beta^t`` from ``hyper["t"]``
with libm's ``powf``, in f32. The layer-wise rules (LAMB, LANS, LARS) keep
their trust ratios on the device (``torch.where``), so a step reads no
norm on the host. Beside them: the bookkeeping a checkpoint carries
(``bookkeeping_state``) and the kvstore-side ``Updater``.

A row-sparse gradient (ndarray/sparse.py:RowSparseNDArray, what the Trainer
gives a ``grad_stype='row_sparse'`` parameter) takes the lazy update
(``_update_row_sparse``, optimizer.py:403): the stored rows of the weight
and of its states are gathered, the same ``_rule`` runs on them, and only
rows whose gradient is not all zero are written back; every other row,
and its state, keeps its bits. ``lazy_update=False``, and the rules whose
update couples rows (LAMB, LANS, LARS: ``_row_local = False``), densify the
gradient and take the dense update; SGLD densifies (its noise reaches every
row). It is plain PyTorch on every device, as the JAX package's is XLA.
"""
from __future__ import annotations

import pickle

import numpy as _np
import torch

from .. import _random
from ..kernels import opt as _kopt

__all__ = ["Optimizer", "register", "create", "SGD", "NAG", "Signum",
           "Adam", "AdamW", "SGLD", "DCASGD", "Nadam", "AdaBelief", "Adamax",
           "FTML", "RMSProp", "AdaGrad", "AdaDelta", "Ftrl", "LAMB", "LANS",
           "LARS", "GroupAdaGrad", "Updater", "get_updater",
           "place_state_like"]

_REG = {}


def register(klass):
    _REG[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An Optimizer from its registered name (case-insensitive), or ``name``
    itself when it already is one."""
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _REG:
        raise ValueError(f"unknown optimizer {name!r}; choose from "
                         f"{sorted(_REG)}")
    return _REG[key](**kwargs)


_F32 = _np.float32
_ONE = _F32(1.0)


_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _s(x, like=None):
    """A Python float holding ``x`` rounded to f32: what a weak-typed f32
    scalar of the JAX package is when it meets an f32 tensor; where it
    meets ``like``, a bf16 or f16 tensor, rounded on to that dtype."""
    v = float(_F32(x))
    if like is not None and like.dtype in _LOW_PRECISION:
        return torch.tensor(v, dtype=like.dtype).item()
    return v


def _map_state(fn, state):
    """``fn`` over every tensor of a state (None, a tensor, or tuples of
    them), in the same nesting."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return fn(state)
    return type(state)(_map_state(fn, s) for s in state)


def _write_rows(state, rows, new_rows, live):
    """Rows ``rows`` of each state tensor take ``new_rows`` where ``live``,
    as ``s.at[rows].add(where(live, new - s[rows], 0))`` does."""
    if state is None:
        return
    if isinstance(state, torch.Tensor):
        old = state.index_select(0, rows)
        mask = live.reshape((-1,) + (1,) * (old.dim() - 1))
        delta = torch.where(mask, new_rows - old, 0).to(state.dtype)
        state.index_copy_(0, rows, old + delta)
        return
    for s, ns in zip(state, new_rows):
        _write_rows(s, rows, ns, live)


def _write_state(state, new_state):
    """Copy new state values into the state tensors, in place."""
    if state is None:
        return
    if isinstance(state, torch.Tensor):
        state.copy_(new_state)
        return
    for s, ns in zip(state, new_state):
        _write_state(s, ns)


def _placement_of(weight):
    """The ``parallel.mesh.Placed`` of a weight given as a Parameter or as
    the NDArray ``Parameter.data()`` returns; None for anything else."""
    if hasattr(weight, "_placement"):
        return weight._placement
    param = getattr(weight, "_param", None)
    return param._placement if param is not None else None


def place_state_like(state, weight, plan=None, name=None):
    """Give optimizer state its weight's placement or, under a ZeRO plan,
    the sharded layout (mxnet_tpu/optimizer/optimizer.py:617).

    State leaves (momenta, variances, f32 masters) mirror the weight's
    shape, so under a sharding plan they take the weight's layout verbatim,
    each position holding its own block (a ``parallel.mesh.Placed``). With
    ``plan``/``name`` given and the plan's ZeRO axis live (MXTPU_ZERO and an
    fsdp mesh axis), same-shape leaves take ``plan.state_spec_for(name,
    shape)`` instead, so each position holds ~1/N of the state. Leaves
    whose shape differs, and every leaf of an unplaced weight without a
    ZeRO plan, stay or become plain tensors (the logical value, on the
    first position's device). ``weight`` is the Parameter or its
    ``data()``. Returns the state in the same nesting, with the placed
    leaves in it (the JAX package re-places its leaves in place; torch
    tuples are immutable, so the caller keeps the return)."""
    from ..parallel.mesh import Layout, Placed

    placement = _placement_of(weight)
    shape = tuple(weight.shape)
    if plan is not None and name is not None and plan.zero_axis() \
            is not None:
        layout = Layout(plan.mesh, plan.state_spec_for(name, shape), shape)
    elif placement is not None:
        layout = placement.layout
    else:
        layout = None

    def _place(s):
        if s is None:
            return None
        if isinstance(s, Placed):
            if layout is None:
                return s.full()
            if s.layout.mesh is layout.mesh and s.layout.spec == layout.spec:
                return s
            return Placed.from_tensor(s.full(), layout)
        if isinstance(s, torch.Tensor):
            if layout is not None and tuple(s.shape) == shape:
                return Placed.from_tensor(s.detach(), layout)
            return s
        return type(s)(_place(x) for x in s)

    return _place(state)


class Optimizer:
    """Base optimizer (optimizer.py:Optimizer)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, clip_global_norm=None,
                 learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, aggregate_num=None,
                 use_fused_step=True, lazy_update=True, **kwargs):  # noqa: ARG002
        self.lazy_update = lazy_update
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        # scale the WHOLE gradient set so its joint L2 norm stays under
        # this bound (fused path only). None = off.
        self.clip_global_norm = clip_global_norm
        self.multi_precision = multi_precision
        self.num_update = 0
        self._index_update_count = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    # -- hyperparameter plumbing -------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise ValueError("lr_scheduler is set; cannot set learning rate")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = 0
        self._index_update_count[index] += 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    # -- checkpoint bookkeeping ------------------------------------------
    def bookkeeping_state(self):
        """The schedule's state, JSON-able: ``num_update`` drives the
        lr_scheduler and each parameter's count is its ``t`` (Adam's bias
        correction). A checkpoint without them restarts both on resume."""
        return {
            "num_update": int(self.num_update),
            "index_update_count": {
                int(k): int(v) for k, v in self._index_update_count.items()},
        }

    def load_bookkeeping_state(self, state):
        """Inverse of :meth:`bookkeeping_state` (keys may arrive as str
        after a JSON round trip)."""
        self.num_update = int(state.get("num_update", 0))
        self._index_update_count = {
            int(k): int(v)
            for k, v in (state.get("index_update_count") or {}).items()}

    def _get_lr(self, index):
        lr = self.learning_rate
        param = self.param_dict.get(index)
        if param is not None:
            lr *= getattr(param, "lr_mult", 1.0)
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        param = self.param_dict.get(index)
        if param is not None:
            wd *= getattr(param, "wd_mult", 1.0)
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # -- state -------------------------------------------------------------
    def create_state(self, index, weight):  # noqa: ARG002
        return None

    def create_state_multi_precision(self, index, weight):
        low_precision = weight.dtype in (torch.float16, torch.bfloat16)
        if self.multi_precision and low_precision:
            master = weight.detach().float()  # a new f32 tensor
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def _hyper(self):
        """The rule's own hyperparameters as a dict of scalars."""
        return {}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        raise NotImplementedError

    def _supports_fused(self):
        """The fused step runs the class ``_rule`` under a shared
        rescale/clip prologue: an optimizer that overrides ``update`` or
        ``update_multi_precision``, or defines no ``_rule``, takes the
        per-parameter loop."""
        cls = type(self)
        return (cls.update is Optimizer.update
                and cls.update_multi_precision
                is Optimizer.update_multi_precision
                and cls._rule is not Optimizer._rule)

    @staticmethod
    def _fused_param_step(cls, clip, gn, mp, w, st, g, lr, wd, t, scale,
                          hyper):
        """One parameter's ladder: rescale -> global-norm scale ->
        per-element clip -> ``cls._rule`` (-> cast of the master back), in
        place. Returns ``(w, st)``, the tensors it was given.

        Plain PyTorch, and the plain version of the CUDA ladder kernel
        (kernels/opt.py:bucket_step, looped over a bucket), which computes
        the same function in one pass."""
        h = dict(hyper)
        h["t"] = t
        with torch.no_grad():
            if mp:
                # cast the low-precision gradient to f32 FIRST, then
                # rescale and clip on the f32 master's side
                master, inner = st
                g = g.float()
            g = g * _s(h["rescale_grad"], g)
            if gn:
                g = g * _s(scale, g)
            if clip is not None:
                g = g.clamp(-_s(clip, g), _s(clip, g))
            if mp:
                nm, ni = cls._rule(master, g, inner, lr, wd, h)
                master.copy_(nm)
                _write_state(inner, ni)
                w.copy_(nm)  # rounds to w's dtype
                return w, st
            nw, ns = cls._rule(w, g, st, lr, wd, h)
            w.copy_(nw)
            _write_state(st, ns)
            return w, st

    @staticmethod
    def _fused_sqnorm(gs, rescale):
        """Sum of squares of the rescaled gradients of one bucket, f32
        accumulation: the pre-pass of ``clip_global_norm``. Returns a
        0-dim tensor on the gradients' device. Plain PyTorch, and the
        plain version of the CUDA norm kernels
        (kernels/opt.py:bucket_sqnorm)."""
        total = torch.zeros((), dtype=torch.float32, device=gs[0].device)
        for g in gs:
            g32 = g.detach().float() * _s(rescale)
            total = total + torch.sum(g32 * g32)
        return total

    # -- the lazy row-sparse update ----------------------------------------
    #: False for rules whose update couples rows (layer-wise norms): they
    #: cannot run on a gathered subset of rows and densify instead
    _row_local = True

    def _update_row_sparse(self, index, weight, grad, state):
        """The lazy update of ``weight`` by the RowSparseNDArray ``grad``
        (optimizer.py:403, :358): its rows of the weight and of every state
        tensor are gathered, rescaled and clipped gradient rows go through
        the class ``_rule``, and each row whose gradient is not all zero is
        written back as ``w + (new - w)``; all other rows keep their bits.
        The rows are exactly the stored ones (no padding)."""
        if not self.lazy_update or not type(self)._row_local:
            self.update(index, weight, grad.todense()._data, state)
            return
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        hyper = dict(self._hyper())
        hyper["rescale_grad"] = self.rescale_grad
        hyper["t"] = self._index_update_count[index]
        rows = grad._idx.to(device=weight.device, dtype=torch.int64)
        with torch.no_grad():
            g = grad._values.to(device=weight.device, dtype=weight.dtype)
            g = g * _s(self.rescale_grad, g)
            if self.clip_gradient is not None:
                c = _s(self.clip_gradient, g)
                g = g.clamp(-c, c)
            w_rows = weight.index_select(0, rows)
            s_rows = _map_state(lambda t: t.index_select(0, rows), state)
            nw_rows, ns_rows = type(self)._rule(w_rows, g, s_rows, lr, wd,
                                                hyper)
            # a touched row whose gradient is exactly zero is no update (a
            # recorded forward that was never backpropagated)
            live = g.reshape(g.shape[0], -1).ne(0).any(dim=1)
            _write_rows(weight, rows, nw_rows, live)
            _write_rows(state, rows, ns_rows, live)

    # -- public update -----------------------------------------------------
    def update(self, index, weight, grad, state):
        """Single-parameter update, in place; list inputs take the fused
        bucketed step, a RowSparseNDArray gradient the lazy update."""
        if isinstance(index, (list, tuple)):
            self._update_list(index, weight, grad, state,
                              multi_precision=False)
            return
        from ..ndarray.sparse import RowSparseNDArray

        if isinstance(grad, RowSparseNDArray):
            self._update_row_sparse(index, weight, grad, state)
            return
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        hyper = dict(self._hyper())
        hyper["rescale_grad"] = self.rescale_grad
        _kopt.param_step(
            type(self), self.clip_gradient, False, False, weight, state,
            grad, lr, wd, self._index_update_count[index], 1.0, hyper)

    def _update_list(self, index, weight, grad, state, multi_precision):
        if self._supports_fused():
            self.update_fused(index, weight, grad, state,
                              multi_precision=multi_precision)
            return
        for i, w, g, s in zip(index, weight, grad, state):
            if multi_precision:
                self.update_multi_precision(i, w, g, s)
            else:
                self.update(i, w, g, s)

    @staticmethod
    def _is_mp_state(weight, state):
        return (isinstance(state, tuple) and len(state) == 2
                and isinstance(state[0], torch.Tensor)
                and state[0].dtype == torch.float32
                and weight.dtype != torch.float32)

    def _resolve(self, index):
        """``[(lr, wd, t)]`` of the parameters ``index``, in list order,
        each update count advanced first: the host part of the fused step
        (so a schedule driven by ``num_update`` sees the per-parameter
        sequence)."""
        out = []
        for i in index:
            self._update_count(i)
            out.append((self._get_lr(i), self._get_wd(i),
                        self._index_update_count[i]))
        return out

    def _bucket_keys(self, weight, state, multi_precision):
        """Each parameter's bucket, ``(weight dtype name, multi-precision)``,
        in list order."""
        return [(str(w.dtype),
                 bool(multi_precision and self._is_mp_state(w, s)))
                for w, s in zip(weight, state)]

    def _fused_hyper(self):
        hyper = dict(self._hyper())
        hyper["rescale_grad"] = self.rescale_grad
        return hyper

    def _fused_device(self, buckets, hyper, scale=1.0):
        """The device part of the fused step: one
        kernels/opt.py:bucket_step call per bucket of ``{(dtype, mp):
        [(w, st, g, lr, wd, t)]}``."""
        cls, clip = type(self), self.clip_gradient
        gn = self.clip_global_norm is not None
        for (_, use_mp), items in buckets.items():
            _kopt.bucket_step(cls, clip, gn, use_mp, items, scale, hyper)

    def _fused_device_rows(self, buckets, scalars):
        """The device part of a captured step (``gluon.TrainStep``): one
        kernels/opt.py:bucket_step_dev call per bucket of ``[(mp, [(w, st,
        g)], start, stop)]``, each member's lr, wd, update-count scalars
        and the rescale read on the device from its row of ``scalars``
        (rows ``start:stop`` the bucket's), which the host part
        (:meth:`_resolve`, kernels/opt.py:ladder_scalars) fills. No
        Python of this call runs again on a replay."""
        cls, clip, hyper = type(self), self.clip_gradient, self._fused_hyper()
        for mp, members, start, stop in buckets:
            _kopt.bucket_step_dev(cls, clip, mp, members,
                                  scalars[start:stop], hyper)

    def _global_norm_scale(self, buckets):
        """The ``clip_global_norm`` scale: one partial sum per bucket,
        combined on the host into the one global scale in float64, in
        bucket order (one device-to-host read for all buckets)."""
        first = next(iter(buckets.values()))[0][2]
        sums = torch.empty(len(buckets), dtype=torch.float32,
                           device=first.device)
        for k, items in enumerate(buckets.values()):
            _kopt.bucket_sqnorm([it[2] for it in items],
                                self.rescale_grad, out=sums[k])
        sq = 0.0
        for v in sums.tolist():
            sq += v
        gnorm = sq ** 0.5
        if gnorm > self.clip_global_norm:
            return self.clip_global_norm / gnorm
        return 1.0

    def update_fused(self, index, weight, grad, state,
                     multi_precision=False):
        """Fused multi-tensor update over the whole list: rescale ->
        global-norm clip -> per-element clip -> ``_rule``, bucketed by
        (weight dtype, multi-precision), with per-parameter lr/wd/t
        resolved in list order. The host part (:meth:`_resolve`, the
        bucketing) comes first; under ``clip_global_norm`` each bucket's
        sum of squares then comes from one kernels/opt.py:bucket_sqnorm
        call into a vector of bucket sums, read on the host once; then the
        device part (:meth:`_fused_device`) gives each bucket one
        kernels/opt.py:bucket_step call: the CUDA kernels for CUDA tensors,
        ``_fused_sqnorm`` and ``_fused_param_step`` for CPU tensors.
        Row-sparse gradients are peeled off first, each to its own update
        (optimizer.py:493)."""
        from ..ndarray.sparse import RowSparseNDArray

        if any(isinstance(g, RowSparseNDArray) for g in grad):
            dense = []
            for i, w, g, s in zip(index, weight, grad, state):
                if not isinstance(g, RowSparseNDArray):
                    dense.append((i, w, g, s))
                elif multi_precision:
                    self.update_multi_precision(i, w, g, s)
                else:
                    self.update(i, w, g, s)
            index, weight, grad, state = (
                [d[k] for d in dense] for k in range(4))
        steps = self._resolve(index)
        buckets = {}
        for key, w, g, s, step in zip(
                self._bucket_keys(weight, state, multi_precision), weight,
                grad, state, steps):
            buckets.setdefault(key, []).append((w, s, g, *step))
        if not buckets:
            return
        scale = 1.0
        if self.clip_global_norm is not None:
            scale = self._global_norm_scale(buckets)
        self._fused_device(buckets, self._fused_hyper(), scale)

    def update_multi_precision(self, index, weight, grad, state):
        if isinstance(index, (list, tuple)):
            self._update_list(index, weight, grad, state,
                              multi_precision=True)
            return
        if not self._is_mp_state(weight, state):
            self.update(index, weight, grad, state)
            return
        master, inner = state
        from ..ndarray.sparse import RowSparseNDArray

        if isinstance(grad, RowSparseNDArray):
            grad32 = RowSparseNDArray(grad._values.float(), grad._idx,
                                      grad.shape)
        else:
            grad32 = grad.detach().float()
        self.update(index, master, grad32, inner)
        with torch.no_grad():
            weight.copy_(master)

    def __repr__(self):
        return f"{type(self).__name__}(learning_rate={self.learning_rate})"


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


@register
class SGD(Optimizer):
    """SGD with momentum (optimizer.py:SGD)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=True,
                 **kwargs):
        super().__init__(learning_rate=learning_rate,
                         lazy_update=lazy_update, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight, requires_grad=False)

    def _hyper(self):
        return {"momentum": self.momentum}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        lr, wd = _s(lr, w), _s(wd, w)
        g = g + wd * w
        if state is None:
            return w - lr * g, None
        mom = _s(hyper["momentum"], w) * state - lr * g
        return w + mom, mom


@register
class NAG(SGD):
    """Nesterov accelerated SGD (optimizer.py:NAG)."""

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        lr, wd = _s(lr, w), _s(wd, w)
        g = g + wd * w
        if state is None:
            return w - lr * g, None
        momentum = _s(hyper["momentum"], w)
        mom = momentum * state - lr * g
        return w + momentum * mom - lr * g, mom


@register
class Signum(Optimizer):
    """Sign-momentum SGD (optimizer.py:Signum)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight, requires_grad=False)

    def _hyper(self):
        return {"momentum": self.momentum, "wd_lh": self.wd_lh}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        g = g + _s(wd, w) * w
        if state is None:
            return w - _s(lr, w) * torch.sign(g), None
        momentum = _F32(hyper["momentum"])
        mom = _s(momentum, w) * state - _s(_ONE - momentum, w) * g
        lr_wd_lh = _s(_F32(lr) * _F32(hyper["wd_lh"]), w)
        new_w = w + _s(lr, w) * torch.sign(mom) - lr_wd_lh * w
        return new_w, mom


def _adam_moments(g, state, hyper):
    """New (m, v) and the f32 scalars ``1 - beta1^t``, ``1 - beta2^t``:
    libm's ``powf``, as the ladder kernel's scalars take them, or the
    values ``hyper`` carries as ``b1c`` and ``b2c`` (the scalar rows of
    kernels/opt.py:bucket_step_dev_reference)."""
    m, v = state
    b1, b2 = _F32(hyper["beta1"]), _F32(hyper["beta2"])
    m = _s(b1, m) * m + _s(_ONE - b1, m) * g
    v = _s(b2, v) * v + _s(_ONE - b2, v) * g * g
    if "b1c" in hyper:
        return m, v, _F32(hyper["b1c"]), _F32(hyper["b2c"])
    t = _F32(hyper["t"])
    return m, v, _ONE - _kopt._powf(b1, t), _ONE - _kopt._powf(b2, t)


@register
class Adam(Optimizer):
    """Adam (optimizer.py:Adam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, requires_grad=False),
                torch.zeros_like(weight, requires_grad=False))

    def _hyper(self):
        return {"beta1": self.beta1, "beta2": self.beta2, "eps": self.epsilon}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        g = g + _s(wd, w) * w
        m, v, c1, c2 = _adam_moments(g, state, hyper)
        lr_t = _s(_F32(lr) * _np.sqrt(c2) / c1, w)
        return w - lr_t * m / (torch.sqrt(v) + _s(hyper["eps"], w)), (m, v)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (optimizer.py:AdamW)."""

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        m, v, c1, c2 = _adam_moments(g, state, hyper)
        mhat = m / _s(c1, m)
        vhat = v / _s(c2, v)
        upd = mhat / (torch.sqrt(vhat) + _s(hyper["eps"], w)) + _s(wd, w) * w
        return w - _s(lr, w) * upd, (m, v)


def _bias(beta, t):
    """``1 - beta^t`` in f32, with libm's ``powf``."""
    return _ONE - _kopt._powf(_F32(beta), _F32(t))


def _sq32(x):
    """``x * x`` for a sum in f32: of a bf16 or f16 ``x``, the squares of
    its f32 values, unrounded, as XLA computes ``(x * x).astype(f32)`` (it
    drops the rounding to ``x``'s dtype before the widening)."""
    return x.float().square() if x.dtype in _LOW_PRECISION else x * x


def _norm(x):
    """The L2 norm of ``x`` as a 0-dim tensor of its dtype, as
    ``jnp.linalg.norm`` computes it under XLA: the squares summed in f32
    (:func:`_sq32`), the sum rounded to ``x``'s dtype, then the root. It
    stays on the device."""
    return _sq32(x).sum().to(x.dtype).sqrt()


def _trust(num, den, lower, upper, like):
    """A layer-wise trust ratio on the device: ``num / den`` where both
    are positive, else 1; then at least ``lower`` and, where ``upper`` is
    positive, at most ``|upper|`` (LAMB and LANS, optimizer.py:1015)."""
    ratio = torch.where((num > 0) & (den > 0), num / den, 1.0)
    ratio = torch.clamp_min(ratio, _s(lower, like))
    if upper > 0:
        ratio = torch.clamp_max(ratio, _s(abs(upper), like))
    return ratio


def _sgld_normal(weight):
    """SGLD's standard normal draws for ``weight``, in f32, from the port's
    generator of the weight's device (``_random.generator``)."""
    noise = torch.empty(weight.shape, dtype=torch.float32,
                        device=weight.device)
    return noise.normal_(generator=_random.generator(weight.device))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (optimizer.py:SGLD). It
    overrides ``update``, so a list of parameters takes the per-parameter
    loop, as in the JAX package."""

    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def update(self, index, weight, grad, state):
        if isinstance(index, (list, tuple)):
            self._update_list(index, weight, grad, state,
                              multi_precision=False)
            return
        from ..ndarray.sparse import RowSparseNDArray

        if isinstance(grad, RowSparseNDArray):
            grad = grad.todense()._data   # the noise reaches every row
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            g = grad * _s(self.rescale_grad, grad)
            if self.clip_gradient is not None:
                c = _s(self.clip_gradient, g)
                g = g.clamp(-c, c)
            g = g + _s(wd, weight) * weight
            noise = _sgld_normal(weight) * _s(_np.sqrt(_F32(lr)))
            weight.copy_(weight - _s(_F32(lr) / _F32(2), weight) * g
                         + noise.to(weight.dtype))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (optimizer.py:DCASGD). The state
    is ``(momentum or None, previous weight)``."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else torch.zeros_like(
            weight, requires_grad=False)
        return (mom, weight.detach().clone())

    def _hyper(self):
        return {"momentum": self.momentum, "lamda": self.lamda}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        mom, prev_w = state
        comp = g + _s(wd, w) * w + _s(hyper["lamda"], g) * g * g * (
            w - prev_w)
        if mom is None:
            new_mom = None
            upd = _s(-_F32(lr), comp) * comp
        else:
            new_mom = _s(hyper["momentum"], mom) * mom - _s(lr, comp) * comp
            upd = new_mom
        nw = w + upd
        return nw, (new_mom, nw)


@register
class Nadam(Adam):
    """Nesterov Adam (optimizer.py:Nadam)."""

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        m, v = state
        b1, b2, t = _F32(hyper["beta1"]), _F32(hyper["beta2"]), hyper["t"]
        g = g + _s(wd, w) * w
        m = _s(b1, m) * m + _s(_ONE - b1, m) * g
        v = _s(b2, v) * v + _s(_ONE - b2, v) * g * g
        mhat = m / _s(_bias(b1, t + 1), m)
        vhat = v / _s(_bias(b2, t), v)
        m_bar = _s(b1, m) * mhat + _s(_ONE - b1, g) * g / _s(_bias(b1, t), g)
        return (w - _s(lr, w) * m_bar
                / (torch.sqrt(vhat) + _s(hyper["eps"], w))), (m, v)


@register
class AdaBelief(Adam):
    """AdaBelief (optimizer.py:AdaBelief): the variance of ``g - m`` in
    place of ``g^2``."""

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        m, s = state
        b1, b2, t = _F32(hyper["beta1"]), _F32(hyper["beta2"]), hyper["t"]
        eps = hyper["eps"]
        g = g + _s(wd, w) * w
        m = _s(b1, m) * m + _s(_ONE - b1, m) * g
        s = (_s(b2, s) * s + _s(_ONE - b2, s) * torch.square(g - m)
             + _s(eps, s))
        lr_t = _s(_F32(lr) * _np.sqrt(_bias(b2, t)) / _bias(b1, t), w)
        return w - lr_t * m / (torch.sqrt(s) + _s(eps, w)), (m, s)


@register
class Adamax(Adam):
    """Adamax, Adam with the infinity norm (optimizer.py:Adamax)."""

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        m, u = state
        b1, b2, t = _F32(hyper["beta1"]), _F32(hyper["beta2"]), hyper["t"]
        g = g + _s(wd, w) * w
        m = _s(b1, m) * m + _s(_ONE - b1, m) * g
        u = torch.maximum(_s(b2, u) * u, torch.abs(g))
        step = _s(_F32(lr) / _bias(b1, t), w)
        return w - step * m / (u + _s(hyper["eps"], u)), (m, u)


@register
class FTML(Optimizer):
    """Follow the Moving Leader (optimizer.py:FTML). The state is
    ``(d, v, z)``."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(torch.zeros_like(weight, requires_grad=False)
                     for _ in range(3))

    def _hyper(self):
        return {"beta1": self.beta1, "beta2": self.beta2, "eps": self.epsilon}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        d_prev, v, z = state
        b1, b2, t = _F32(hyper["beta1"]), _F32(hyper["beta2"]), hyper["t"]
        g = g + _s(wd, w) * w
        v = _s(b2, v) * v + _s(_ONE - b2, v) * g * g
        d = _s(_bias(b1, t) / _F32(lr), v) * (
            torch.sqrt(v / _s(_bias(b2, t), v)) + _s(hyper["eps"], v))
        sigma = d - _s(b1, d) * d_prev
        z = _s(b1, z) * z + _s(_ONE - b1, z) * g - sigma * w
        return -z / d, (d, v, z)


@register
class RMSProp(Optimizer):
    """RMSProp (optimizer.py:RMSProp). The state is ``(n,)``, or ``(n, mg,
    delta)`` when ``centered``."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered

    def create_state(self, index, weight):
        return tuple(torch.zeros_like(weight, requires_grad=False)
                     for _ in range(3 if self.centered else 1))

    def _hyper(self):
        return {"rho": self.rho, "momentum": self.momentum,
                "eps": self.epsilon}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        rho, eps = _F32(hyper["rho"]), hyper["eps"]
        g = g + _s(wd, w) * w
        if len(state) == 1:
            (n,) = state
            n = _s(rho, n) * n + _s(_ONE - rho, n) * g * g
            return (w - _s(lr, g) * g / (torch.sqrt(n) + _s(eps, n))), (n,)
        n, mg, delta = state
        n = _s(rho, n) * n + _s(_ONE - rho, n) * g * g
        mg = _s(rho, mg) * mg + _s(_ONE - rho, mg) * g
        delta = _s(hyper["momentum"], delta) * delta - _s(lr, g) * g / (
            torch.sqrt(n - mg * mg + _s(eps, n)))
        return w + delta, (n, mg, delta)


@register
class AdaGrad(Optimizer):
    """AdaGrad (optimizer.py:AdaGrad)."""

    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight, requires_grad=False)

    def _hyper(self):
        return {"eps": self.epsilon}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        g = g + _s(wd, w) * w
        hist = state + g * g
        return (w - _s(lr, g) * g
                / (torch.sqrt(hist) + _s(hyper["eps"], hist))), hist


@register
class AdaDelta(Optimizer):
    """AdaDelta (optimizer.py:AdaDelta)."""

    def __init__(self, learning_rate=1.0, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, requires_grad=False),
                torch.zeros_like(weight, requires_grad=False))

    def _hyper(self):
        return {"rho": self.rho, "eps": self.epsilon}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        acc_g, acc_d = state
        rho, eps = _F32(hyper["rho"]), hyper["eps"]
        g = g + _s(wd, w) * w
        acc_g = _s(rho, acc_g) * acc_g + _s(_ONE - rho, acc_g) * g * g
        delta = (torch.sqrt(acc_d + _s(eps, acc_d))
                 / torch.sqrt(acc_g + _s(eps, acc_g)) * g)
        acc_d = (_s(rho, acc_d) * acc_d
                 + _s(_ONE - rho, acc_d) * delta * delta)
        return w - _s(lr, delta) * delta, (acc_g, acc_d)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (optimizer.py:Ftrl). The state is ``(z, n)``."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, requires_grad=False),
                torch.zeros_like(weight, requires_grad=False))

    def _hyper(self):
        return {"lamda1": self.lamda1, "beta": self.beta}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        z, n = state
        l1 = _s(hyper["lamda1"], z)
        sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / _s(lr, n)
        z = z + g - sigma * w
        n = n + g * g
        den = (_s(hyper["beta"], n) + torch.sqrt(n)) / _s(lr, n) + _s(wd, n)
        new_w = torch.where(torch.abs(z) > l1,
                            -(z - torch.sign(z) * l1) / den,
                            torch.zeros_like(w))
        return new_w, (z, n)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments for batch training (optimizer.py:LAMB):
    Adam's step scaled per tensor by ``||w|| / ||r||``, kept on the
    device."""

    _row_local = False  # the layer-wise trust ratio needs every row

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, requires_grad=False),
                torch.zeros_like(weight, requires_grad=False))

    def _hyper(self):
        return {"beta1": self.beta1, "beta2": self.beta2, "eps": self.epsilon,
                "lower": self.lower_bound or 0.0,
                "upper": self.upper_bound or -1.0,
                "bias_corr": 1.0 if self.bias_correction else 0.0}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        m, v = state
        b1, b2, t = _F32(hyper["beta1"]), _F32(hyper["beta2"]), hyper["t"]
        m = _s(b1, m) * m + _s(_ONE - b1, m) * g
        v = _s(b2, v) * v + _s(_ONE - b2, v) * g * g
        if hyper["bias_corr"] > 0:
            mhat = m / _s(_bias(b1, t), m)
            vhat = v / _s(_bias(b2, t), v)
        else:
            mhat, vhat = m, v
        r = mhat / (torch.sqrt(vhat) + _s(hyper["eps"], w)) + _s(wd, w) * w
        ratio = _trust(_norm(w), _norm(r), hyper["lower"], hyper["upper"], w)
        return w - _s(lr, w) * ratio * r, (m, v)


@register
class LANS(LAMB):
    """LAMB with Nesterov momentum and a normalised gradient
    (optimizer.py:LANS): two trust ratios, one for the momentum part and
    one for the gradient part."""

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        m, v = state
        b1, b2, t = _F32(hyper["beta1"]), _F32(hyper["beta2"]), hyper["t"]
        g = g / torch.clamp_min(_norm(g), _s(1e-12, g))
        m = _s(b1, m) * m + _s(_ONE - b1, m) * g
        v = _s(b2, v) * v + _s(_ONE - b2, v) * g * g
        mhat = m / _s(_bias(b1, t), m)
        vhat = v / _s(_bias(b2, t), v)
        denom = torch.sqrt(vhat) + _s(hyper["eps"], vhat)
        r1 = mhat / denom + _s(wd, w) * w
        r2 = g / denom + _s(wd, w) * w
        w_norm = _norm(w)
        lo, up = hyper["lower"], hyper["upper"]
        upd = (_s(b1, w) * _trust(w_norm, _norm(r1), lo, up, w) * r1
               + _s(_ONE - b1, w) * _trust(w_norm, _norm(r2), lo, up, w)
               * r2)
        return w - _s(lr, w) * upd, (m, v)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (optimizer.py:LARS), the trust
    ratio kept on the device."""

    _row_local = False  # the layer-wise norms need every row

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight, requires_grad=False)

    def _hyper(self):
        return {"momentum": self.momentum, "eta": self.eta,
                "eps": self.epsilon}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):
        w_norm, g_norm = _norm(w), _norm(g)
        wd_s = _s(wd, w)
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            _s(hyper["eta"], w) * w_norm / (g_norm + wd_s * w_norm
                                            + _s(hyper["eps"], w)), 1.0)
        g = g + wd_s * w
        mom = _s(hyper["momentum"], state) * state + _s(lr, w) * trust * g
        return w - mom, mom


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one accumulator per row (optimizer.py:GroupAdaGrad):
    ``history += mean(g^2 over the other axes)``, a ``(rows, 1)`` state.
    Weight decay and weights of fewer than 2 dimensions are refused, as in
    the JAX package. A weight of more than 2 dimensions is taken row-wise
    too (the JAX package broadcasts its ``(rows, 1)`` history against a
    ``(rows, 1, 1)`` mean: it computes only where the first two dimensions
    are equal, with these values, its history grown to ``(rows, d1,
    1)``)."""

    def __init__(self, learning_rate=0.01, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        if self.wd != 0.0:
            raise ValueError("GroupAdaGrad does not support weight decay")
        self.epsilon = epsilon

    def create_state(self, index, weight):
        if weight.dim() < 2:
            raise ValueError(
                "GroupAdaGrad needs >= 2-d weights (row-wise history)")
        return torch.zeros((weight.shape[0], 1), dtype=weight.dtype,
                           device=weight.device)

    def _hyper(self):
        return {"eps": self.epsilon}

    @staticmethod
    def _rule(w, g, state, lr, wd, hyper):  # noqa: ARG004 - no weight decay
        axes = tuple(range(1, g.dim()))
        mean = _sq32(g).mean(dim=axes).to(g.dtype)
        hist = state + mean.reshape(state.shape)
        # each row's history against that row's elements, whatever the
        # weight's rank
        rows = hist.reshape((g.shape[0],) + (1,) * (g.dim() - 1))
        return (w - _s(lr, g) * g
                / (torch.sqrt(rows) + _s(hyper["eps"], rows))), hist


class Updater:
    """The kvstore-side updater (optimizer.py:Updater): the callable a
    server registers, which keeps one optimizer state per key and applies
    ``update_multi_precision(key, weight, grad, state)``."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        # key -> flat leaf list of a loaded checkpoint, grafted into the
        # state created at the key's first update (its nesting is known
        # only once create_state has seen a weight)
        self.pending_loaded = {}

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        for i, g, w in zip(index, grad, weight):
            if isinstance(i, bytes):
                i = i.decode()
            if i not in self.states:
                st = self.optimizer.create_state_multi_precision(i, w)
                flat = self.pending_loaded.pop(i, None)
                if flat is None:
                    flat = self.pending_loaded.pop(str(i), None)
                if flat is not None:
                    st = _graft_state(st, list(flat))
                self.states[i] = st
            self.optimizer.update_multi_precision(i, w, g, self.states[i])

    def set_states(self, states):
        """Load what :meth:`get_states` gave (with the optimizer, where it
        was dumped)."""
        payload = pickle.loads(states)
        if isinstance(payload, dict) and "optimizer" in payload:
            self.optimizer = payload["optimizer"]
            payload = payload["states"]
        self.states = payload

    def get_states(self, dump_optimizer=False):
        """The states pickled (tensors keep their device), with the
        optimizer under ``dump_optimizer``."""
        if dump_optimizer:
            return pickle.dumps({"states": self.states,
                                 "optimizer": self.optimizer})
        return pickle.dumps(self.states)


def _graft_state(state, flat):
    """``state``, freshly created, with the loaded leaf values ``flat`` (in
    flatten order) in place of its own, keeping its nesting, dtypes and
    device. A leaf count that differs (a checkpoint of another optimizer)
    raises ``ValueError``."""
    def count(s):
        if isinstance(s, torch.Tensor):
            return 1
        if isinstance(s, (list, tuple)):
            return sum(count(x) for x in s)
        return 0

    expected = count(state)
    if expected != len(flat):
        raise ValueError(
            f"optimizer state checkpoint has {len(flat)} leaves but the "
            f"current optimizer's state wants {expected}: was it saved "
            f"under a different optimizer? (load_optimizer_states)")

    def walk(s):
        if isinstance(s, torch.Tensor):
            leaf = torch.as_tensor(flat.pop(0))
            return leaf.to(device=s.device, dtype=s.dtype, copy=True)
        if isinstance(s, (list, tuple)):
            return type(s)(walk(x) for x in s)
        return s

    return walk(state)


def get_updater(optimizer):
    """An :class:`Updater` over ``optimizer`` (optimizer.py:get_updater)."""
    return Updater(optimizer)
