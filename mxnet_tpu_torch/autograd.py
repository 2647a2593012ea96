"""Train/predict and recording flags, ``backward`` and ``grad``
(counterpart of mxnet_tpu/autograd.py).

The flags are thread-local, like the JAX package's: ``Dropout`` and
``MultiHeadAttention`` read :func:`is_training`, and ``Block.__call__`` lets
torch autograd record only inside :func:`record`. The default is predict
mode, not recording. The tape is torch autograd's: :func:`backward` and
:func:`grad` run it with MXNet's rules (a head without a head gradient gets
ones, whatever its shape; several heads are summed in one pass), and
gradients land in the buffers that ``gluon.Parameter`` or
:func:`mark_variables` attached, by their ``grad_req``. Heads, head
gradients and variables may be tensors or NDArrays. :class:`Function`
(a custom differentiable function written as ``forward`` and
``backward``) rides on ``torch.autograd.Function``.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "record", "pause", "train_mode", "predict_mode", "backward",
           "grad", "mark_variables", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_state = _State()


def is_recording():
    """True iff inside a ``record()`` scope."""
    return _state.recording


def is_training():
    """True iff in train mode."""
    return _state.training


def set_recording(is_rec):
    """Turn recording on or off; returns the previous state."""
    prev = _state.recording
    _state.recording = bool(is_rec)
    return prev


def set_training(train):
    """Turn train mode on or off; returns the previous state."""
    prev = _state.training
    _state.training = bool(train)
    return prev


@contextmanager
def _scope(recording=None, training=None):
    prev_r = _state.recording
    prev_t = _state.training
    if recording is not None:
        _state.recording = recording
    if training is not None:
        _state.training = training
    try:
        yield
    finally:
        _state.recording = prev_r
        _state.training = prev_t


def record(train_mode=True):
    """Scope in which executed ops are recorded for backward."""
    return _scope(recording=True, training=train_mode)


def pause(train_mode=False):
    """Scope in which recording (and by default training mode) is off."""
    return _scope(recording=False, training=train_mode)


def train_mode():
    """Scope forcing train-mode behavior (dropout active)."""
    return _scope(training=True)


def predict_mode():
    """Scope forcing inference-mode behavior."""
    return _scope(training=False)


def _tensors(xs):
    """A list of tensors from a tensor, an NDArray or a list of either."""
    from .ndarray.ndarray import NDArray

    if isinstance(xs, (torch.Tensor, NDArray)):
        xs = [xs]
    return [x._data if isinstance(x, NDArray) else x for x in xs]


def _heads_and_grads(heads, head_grads):
    heads = _tensors(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    else:
        head_grads = _tensors(head_grads)
    if len(head_grads) != len(heads):
        raise ValueError(f"{len(heads)} heads but {len(head_grads)} "
                         "head gradients")
    for h in heads:
        if not h.requires_grad:
            raise ValueError(
                "one of the backward heads was not computed inside a "
                "record() scope and has no attached grad")
    # MXNet's rule: the default head gradient is ones, for any shape
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    return heads, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):  # noqa: ARG001
    """Run backward from ``heads`` (a tensor or a list), landing gradients
    in the attached buffers (autograd.py:backward).

    A head without a head gradient gets ones, so a per-sample loss vector
    needs no reduction first (``tensor.backward()`` would raise); a list of
    heads is summed in one pass over the tape. ``grad_req`` 'write'
    replaces a parameter's gradient, 'add' accumulates across calls."""
    heads, grads = _heads_and_grads(heads, head_grads)
    torch.autograd.backward(heads, grads, retain_graph=bool(retain_graph))


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):  # noqa: ARG001
    """Gradients of ``heads`` with respect to ``variables``, returned as a
    list instead of written to the attached buffers (autograd.py:grad). A
    variable the heads do not depend on gets zeros. With
    ``create_graph=True`` the gradients are themselves recorded."""
    from .ndarray.ndarray import NDArray

    nd = isinstance(variables, NDArray) or (
        isinstance(variables, (list, tuple))
        and any(isinstance(v, NDArray) for v in variables))
    variables = _tensors(variables)
    heads, grads = _heads_and_grads(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    out = torch.autograd.grad(heads, variables, grads,
                              retain_graph=bool(retain_graph),
                              create_graph=bool(create_graph),
                              allow_unused=True)
    out = [torch.zeros_like(v) if g is None else g
           for v, g in zip(variables, out)]
    return [NDArray(g) for g in out] if nd else out


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to leaf tensors (autograd.py:mark_variables):
    after this, :func:`backward` writes into ``gradients`` by ``grad_req``
    ('write' replaces the buffer's value, 'add' accumulates, 'null' records
    nothing), and ``variable.grad`` stays empty. NDArrays are taken for
    their tensors."""
    variables, gradients = _tensors(variables), _tensors(gradients)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, buf, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise ValueError(
                f"grad_req must be 'write', 'add' or 'null', got {req!r}")
        old = getattr(var, "_mxtpu_grad_hook", None)
        if old is not None:
            old.remove()
        var.requires_grad_(req != "null")
        if req == "null":
            var._mxtpu_grad_hook = None
            continue

        def land(v, buf=buf, req=req):
            if v.grad is None:    # a Function's None gradient: untouched
                return
            with torch.no_grad():
                if req == "add":
                    buf.add_(v.grad)
                else:
                    buf.copy_(v.grad)
            v.grad = None

        var._mxtpu_grad_hook = var.register_post_accumulate_grad_hook(land)


class _Bridge(torch.autograd.Function):
    """Runs a :class:`Function`'s ``forward`` and ``backward`` as a node of
    torch's tape; the arguments after ``func`` are the call's inputs as
    given (tensors, NDArrays' tensors, other values)."""

    @staticmethod
    def forward(ctx, func, kinds, *args):
        from .ndarray.ndarray import NDArray

        ctx.func, ctx.kinds = func, kinds
        inputs = [NDArray(a) if k == "nd" else a for a, k in zip(args, kinds)]
        with pause():
            out = func.forward(*inputs)
        multi = isinstance(out, (tuple, list))
        outs = list(out) if multi else [out]
        ctx.out_nd = [isinstance(o, NDArray) for o in outs]
        func._out_form = (multi, ctx.out_nd)   # for Function.__call__
        return tuple(_tensors(outs))

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray

        cts = [NDArray(g) if nd else g for g, nd in zip(grads, ctx.out_nd)]
        with pause():
            got = ctx.func.backward(*cts)
        if not isinstance(got, (tuple, list)):
            got = (got,)
        got = [None if g is None else getattr(g, "_data", g) for g in got]
        if len(got) != len(ctx.kinds):
            raise ValueError(
                f"{type(ctx.func).__name__}.backward returned {len(got)} "
                f"gradients for {len(ctx.kinds)} inputs")
        return (None, None, *[g if k != "other" else None
                              for g, k in zip(got, ctx.kinds)])


class Function:
    """A custom differentiable function (autograd.py:Function): subclass it
    with ``forward(self, *inputs)`` and ``backward(self, *output_grads)``,
    which returns one gradient (or None) per input. Inputs and outputs are
    NDArrays or tensors; ``backward`` gets its output gradients as what
    ``forward`` returned (NDArrays for NDArrays). ``forward`` runs
    unrecorded and ``backward`` under :func:`pause`, as in the JAX package;
    ``save_for_backward`` keeps what ``backward`` needs in
    ``saved_tensors``. Inside :func:`record`, with an input that needs a
    gradient, the call is one node of torch's tape."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        kinds = tuple("nd" if isinstance(a, NDArray) else "tensor"
                      if isinstance(a, torch.Tensor) else "other"
                      for a in inputs)
        args = [a._data if k == "nd" else a for a, k in zip(inputs, kinds)]
        if not (is_recording() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args)):
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _Bridge.apply(self, kinds, *args)
        multi, out_nd = self._out_form
        wrapped = [NDArray(o) if nd else o for o, nd in zip(outs, out_nd)]
        return tuple(wrapped) if multi else wrapped[0]
