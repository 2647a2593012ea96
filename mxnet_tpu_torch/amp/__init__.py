"""Mixed precision (counterpart of mxnet_tpu/amp/__init__.py).

bf16 is the low precision, as in the JAX package: ``float16`` maps to it.
``convert_hybrid_block`` casts the parameters offline (norm scale/shift
and running statistics stay f32) and casts floating-point inputs on entry;
with ``Trainer(..., {'multi_precision': True})`` the optimizer keeps f32
masters beside the bf16 weights. The op lists (``lists/``, the ``list_*``
functions) are the JAX package's tables; ``convert_hybrid_block`` takes
the op-list arguments and ignores them, as the JAX package does.

The loss-scaling loop is MXNet's::

    amp.init()
    net = amp.convert_hybrid_block(net)
    amp.init_trainer(trainer)
    with autograd.record():
        loss = ...
        with amp.scale_loss(loss, trainer) as scaled:
            autograd.backward(scaled)
    amp.unscale(trainer)
    overflow = trainer._amp_loss_scaler.has_overflow(params)
    if not overflow:
        trainer.step(batch)
    trainer._amp_loss_scaler.update_scale(overflow)

Under bf16 the scale stays 1: ``scale_loss`` yields the loss itself and
``unscale`` does nothing. Another target keeps ``init_scale``,
``scale_loss`` multiplies the loss by it and ``unscale`` the gradients by
its inverse. ``LossScaler.has_overflow`` reduces every gradient on its
device and reads one flag on the host, once a step.

``graph_pass=True`` (the JAX package's jaxpr rewrite under the cast lists,
``amp/graph_pass.py``) waits for the port's ``passes/``, and
``convert_symbol`` for its ``symbol/``; both raise ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib

import torch

from ..base import normalize_dtype
from . import lists

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "convert_model", "convert_symbol",
           "LossScaler", "lists", "warn_if_model_exists",
           "list_lp16_ops", "list_fp32_ops", "list_lp16_fp32_ops",
           "list_conditional_fp32_ops", "list_widest_type_cast",
           "list_loss_output_functions", "list_lp16_use_fp32_params"]

_state = {"target_dtype": "bfloat16"}   # what init() set


def _target(target_dtype):
    """The dtype name a target stands for: bf16 for every 16-bit float."""
    if target_dtype in ("float16", "fp16", "bfloat16", "bf16"):
        return "bfloat16"
    return str(target_dtype)


def list_lp16_ops(target_dtype="bfloat16"):  # noqa: ARG001
    """Ops forced to the low precision (fp16 and bf16 alike answer the
    bf16 table)."""
    return list(lists.symbol_bf16.BF16_FUNCS)


def list_fp32_ops(target_dtype="bfloat16"):  # noqa: ARG001
    return list(lists.symbol_bf16.FP32_FUNCS)


def list_lp16_fp32_ops(target_dtype="bfloat16"):  # noqa: ARG001
    """Ops that run in either precision."""
    return list(lists.symbol_bf16.BF16_FP32_FUNCS)


def list_conditional_fp32_ops(target_dtype="bfloat16"):  # noqa: ARG001
    return list(lists.symbol_bf16.CONDITIONAL_FP32_FUNCS)


def list_widest_type_cast(target_dtype="bfloat16"):  # noqa: ARG001
    return list(lists.symbol_bf16.WIDEST_TYPE_CASTS)


def list_loss_output_functions(target_dtype="bfloat16"):  # noqa: ARG001
    return list(lists.symbol_bf16.LOSS_OUTPUT_FUNCTIONS)


def list_lp16_use_fp32_params(target_dtype="bfloat16"):
    """None for fp16; for bf16 the ops whose parameters stay f32."""
    if target_dtype in ("float16", "fp16"):
        return None
    return dict(lists.symbol_bf16.BF16_USE_FP32_PARAMS)


def warn_if_model_exists():
    """Warn about a Block created before ``amp.init`` (the first one found
    among the callers' locals)."""
    import inspect
    import logging

    from ..gluon.block import Block

    for f in inspect.stack():
        for k, v in f.frame.f_locals.items():
            if isinstance(v, Block):
                logging.warning("Block %s created in [%s:%d] before "
                                "AMP init.", k, f.filename, f.lineno)
                return


def convert_symbol(sym, *args, **kwargs):  # noqa: ARG001
    raise NotImplementedError(
        "amp.convert_symbol is not ported yet: it waits for the port's "
        "symbol/ (ROADMAP queue 1 item 11)")


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):  # noqa: ARG001
    """Enable AMP with ``target_dtype`` (float16 means bf16) for the loss
    scalers :func:`init_trainer` attaches. The op-list arguments are taken
    and ignored, as in the JAX package."""
    _state["target_dtype"] = _target(target_dtype)


def init_trainer(trainer):
    """Attach a :class:`LossScaler` to ``trainer`` (``_amp_loss_scaler``)
    and return it."""
    trainer._amp_loss_scaler = LossScaler()
    return trainer


def scale_loss(loss, trainer):
    """A context yielding the loss to backpropagate: ``loss`` itself under
    bf16 or without a scaler, else ``loss`` times the scale."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)

    @contextlib.contextmanager
    def ctx():
        if scaler is None or _state["target_dtype"] == "bfloat16":
            yield loss
        else:
            yield loss * scaler.loss_scale

    return ctx()


def unscale(trainer):
    """Multiply every gradient of ``trainer`` by 1/scale, in place (nothing
    at a scale of 1). The scalar is rounded as a weak scalar of the JAX
    package meets the gradient's dtype."""
    from ..optimizer.optimizer import _s

    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or scaler.loss_scale == 1.0:
        return
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for p in trainer._params:
            if p.grad_req != "null":
                for g in p.list_grad():
                    g.mul_(_s(inv, g))


def _cast_param(p, dtype):
    name = p.name.lower()
    # norms' scale/shift and running statistics stay f32
    # (lists.symbol_bf16.BF16_USE_FP32_PARAMS)
    if any(k in name for k in ("gamma", "beta", "running", "moving")):
        return
    p.cast(dtype)


def convert_hybrid_block(net, target_dtype="bfloat16", target_dtype_ops=None,
                         fp32_ops=None, conditional_fp32_ops=None,
                         excluded_sym_names=None, device=None,
                         cast_params_offline=True, graph_pass=False,
                         example_inputs=None):  # noqa: ARG001
    """Convert a HybridBlock to mixed precision
    (amp/__init__.py:convert_hybrid_block): each parameter that has a shape
    or a value is cast to bf16 except norm scale/shift and running
    statistics, and floating-point inputs are cast on entry. The op-list
    arguments are ignored, as in the JAX package. Returns ``net``,
    converted in place."""
    if graph_pass:
        raise NotImplementedError(
            "convert_hybrid_block(graph_pass=True) is not ported yet: it is "
            "the JAX package's jaxpr rewrite under the cast lists "
            "(amp/graph_pass.py), which waits for the port's passes/ "
            "(ROADMAP queue 1 item 11)")
    dtype = normalize_dtype(_target(target_dtype))
    for p in net.collect_params().values():
        if p._var is not None or p.shape is not None:
            _cast_param(p, dtype)
    orig_forward = net.forward

    def forward(*args):
        # Block.__call__ hands NDArray arguments over as their tensors
        return orig_forward(*[
            a.to(dtype) if isinstance(a, torch.Tensor)
            and a.is_floating_point() else a for a in args])

    net.forward = forward
    return net


convert_model = convert_hybrid_block


class LossScaler:
    """Dynamic loss scaler (the JAX package's amp.LossScaler): 1 under
    bf16, ``init_scale`` otherwise; halved on an overflow (not below 1),
    doubled after ``scale_window`` clean steps."""

    def __init__(self, init_scale=2 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = 1.0 if _state["target_dtype"] == "bfloat16" \
            else init_scale
        self._factor = scale_factor
        self._window = scale_window
        self._unskipped = 0

    def has_overflow(self, params):
        """True when a gradient of ``params`` (Parameters; those with
        ``grad_req='null'`` skipped) holds a non-finite value: one
        reduction over the gradients on their device
        (ops/optimizer_ops.py:multi_all_finite) and one host read."""
        from ..ops.optimizer_ops import multi_all_finite

        grads = [p.grad() for p in params if p.grad_req != "null"]
        if not grads:
            return False
        return not bool(multi_all_finite(*grads)[0].item())

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._window:
                self.loss_scale *= self._factor
                self._unskipped = 0
