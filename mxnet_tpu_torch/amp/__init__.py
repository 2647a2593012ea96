"""Mixed precision (counterpart of mxnet_tpu/amp/__init__.py).

Ported now: ``convert_hybrid_block`` with offline parameter casting
(the ``cast_params_offline`` branch): parameters go to bf16 except norm
scale/shift and running statistics, and float inputs are cast on entry.
With ``Trainer(..., {'multi_precision': True})`` the optimizer then keeps
f32 masters beside the bf16 weights. bf16 needs no loss scaling, so the
``LossScaler``, the graph-level cast pass and the op lists are not ported
yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from ..base import normalize_dtype

__all__ = ["convert_hybrid_block", "convert_model", "LossScaler"]

_LATER = ("is not ported yet: it comes with the training slice that needs "
          "float16 loss scaling and the graph-level cast lists")


def _cast_param(p, dtype, keep_fp32=False):
    name = p.name.lower()
    # norms' scale/shift and running stats stay f32
    if keep_fp32 or any(k in name for k in ("gamma", "beta", "running",
                                            "moving")):
        return
    p.cast(dtype)


def convert_hybrid_block(net, target_dtype="bfloat16", target_dtype_ops=None,
                         fp32_ops=None, conditional_fp32_ops=None,
                         excluded_sym_names=None, device=None,
                         cast_params_offline=True, graph_pass=False,
                         example_inputs=None):  # noqa: ARG001
    """Convert a HybridBlock to mixed precision
    (amp/__init__.py:convert_hybrid_block): parameters cast to bf16 except
    norm/scale parameters, floating-point inputs cast on entry. Returns
    ``net``, converted in place."""
    if graph_pass:
        raise NotImplementedError(f"convert_hybrid_block(graph_pass=True) "
                                  f"{_LATER}")
    if any(x is not None for x in (target_dtype_ops, fp32_ops,
                                   conditional_fp32_ops,
                                   excluded_sym_names)):
        raise NotImplementedError(f"the amp op lists: this {_LATER}")
    dtype = normalize_dtype("bfloat16" if target_dtype in (
        "float16", "fp16", "bfloat16", "bf16") else target_dtype)
    for p in net.collect_params().values():
        _cast_param(p, dtype)
    orig_forward = net.forward

    def forward(*args):
        cast_args = [
            a.to(dtype) if isinstance(a, torch.Tensor)
            and a.is_floating_point() else a for a in args]
        return orig_forward(*cast_args)

    net.forward = forward
    return net


convert_model = convert_hybrid_block


class LossScaler:
    def __init__(self, *args, **kwargs):  # noqa: ARG002
        raise NotImplementedError(f"amp.LossScaler {_LATER}")
