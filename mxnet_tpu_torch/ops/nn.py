"""Neural-net ops of the port's layers, as plain tensor functions
(counterpart of mxnet_tpu/ops/nn.py).

Each mirrors the JAX op's arithmetic: dtypes promote as ``jnp`` promotes
them, LayerNorm takes its statistics in f32 and casts back, ``gelu`` is the
exact erf form. Convolution and pooling keep the JAX package's layouts
(NCHW family, or NHWC family with weights ``(O, *k, I/g)``) and are left to
PyTorch's own CUDA paths (cuDNN), as the JAX package left them to XLA.
BatchNorm training goes through kernels/norm.py:bn_train, whose plain
versions are ``_bn_train_impl`` and ``_bn_train_bwd`` here.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .. import env as _env

__all__ = ["fully_connected", "conv", "conv_transpose", "pool", "flatten",
           "batch_norm", "layer_norm", "group_norm", "instance_norm",
           "activation", "leaky_relu", "softmax", "log_softmax",
           "softmax_cross_entropy", "embedding", "dropout"]


def fully_connected(x, weight, bias=None, flatten=True):
    """``y = x @ W^T + b`` with weight (units, in_units) (ops/nn.py:26).
    With ``flatten`` the input is reshaped to (N, -1) first. Mixed dtypes
    promote (bf16 activations into an f32 head give f32), as in JAX."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
        bias = bias.to(dt)
    return F.linear(x.to(dt), weight.to(dt), bias)


def _tup(v, nd):
    return (v,) * nd if isinstance(v, int) else tuple(v)


def _channels_last(layout):
    return layout is not None and layout[-1] == "C"


def conv(x, weight, bias=None, stride=None, pad=None, dilate=None, groups=1,
         layout=None):
    """N-d convolution (ops/nn.py:71) in the NCHW family (default) or the
    NHWC family. Weights are ``(O, I/g, *k)`` channels-first and
    ``(O, *k, I/g)`` channels-last, the JAX package's shapes, so checkpoints
    map 1:1.

    Channels-last tensors go to ``F.conv*d`` as ``movedim`` views, which
    are channels_last in memory: cuDNN takes them as they are, and its
    channels_last output moved back is a contiguous NHWC tensor, with no
    copy on either side."""
    nd = x.dim() - 2
    stride, pad = _tup(stride or 1, nd), _tup(pad or 0, nd)
    dilate = _tup(dilate or 1, nd)
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
        bias = bias.to(dt)
    x, weight = x.to(dt), weight.to(dt)
    last = _channels_last(layout)
    if last:
        x, weight = x.movedim(-1, 1), weight.movedim(-1, 1)
    fn = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    y = fn(x, weight, bias, stride, pad, dilate, groups)
    return y.movedim(1, -1) if last else y


def conv_transpose(x, weight, bias=None, stride=None, pad=None, dilate=None,
                   output_padding=None, groups=1, layout=None):
    """Transposed convolution (ops/nn.py:123), weight ``(I, O/g, *k)``
    channels-first or ``(I, *k, O/g)`` channels-last, the JAX package's
    shapes and PyTorch's own. Its padding is the JAX package's: the
    dilated kernel extent less ``pad`` on each side, ``output_padding``
    more on the high side, so an output dim is
    ``(n - 1) * stride - 2 * pad + dilate * (k - 1) + output_padding + 1``,
    which is ``F.conv_transpose*d``'s."""
    nd = x.dim() - 2
    stride, pad = _tup(stride or 1, nd), _tup(pad or 0, nd)
    dilate = _tup(dilate or 1, nd)
    output_padding = _tup(output_padding or 0, nd)
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
        bias = bias.to(dt)
    x, weight = x.to(dt), weight.to(dt)
    last = _channels_last(layout)
    if last:
        x, weight = x.movedim(-1, 1), weight.movedim(-1, 1)
    fn = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[nd - 1]
    y = fn(x, weight, bias, stride, pad, output_padding, groups, dilate)
    return y.movedim(1, -1) if last else y


def _pool_pads(spatial, kernel, stride, pad, ceil_mode, same_mode):
    """(low, high) padding of each spatial dim, as ops/nn.py:pool computes
    it for the ``valid``, ``full`` (ceil) and ``same`` conventions."""
    pairs = [(p, p) for p in pad]
    for i, (n, k, st, p) in enumerate(zip(spatial, kernel, stride, pad)):
        if same_mode:
            total = max((-(-n // st) - 1) * st + k - n, 0)
            pairs[i] = (total // 2, total - total // 2)
        elif ceil_mode:
            out_full = -(-(n + 2 * p - k) // st) + 1
            pairs[i] = (p, p + max(0, (out_full - 1) * st + k - (n + 2 * p)))
    return pairs


def _window_sum(x, kernel, stride, nd):
    """Sum over each window of a channels-first tensor, no padding."""
    if nd == 1:  # avg_pool1d has no divisor_override
        return F.avg_pool2d(x.unsqueeze(-2), (1, kernel[0]), (1, stride[0]),
                            divisor_override=1).squeeze(-2)
    fn = F.avg_pool2d if nd == 2 else F.avg_pool3d
    return fn(x, kernel, stride, divisor_override=1)


def pool(x, kernel, pool_type="max", stride=None, pad=None, global_pool=False,
         count_include_pad=True, layout=None, ceil_mode=False,
         pooling_convention=None):
    """Max, avg, sum and lp (p = 2) pooling (ops/nn.py:188), with the JAX
    package's padding conventions: ``pooling_convention`` valid, full (=
    ``ceil_mode``, extra rows on the high side) or same; avg with
    ``count_include_pad`` divides by the window size, without it by the
    number of input elements in the window; ``global_pool`` pools the whole
    spatial extent. Channels-last layouts pool ``x[1:-1]``.

    A symmetric padding of at most half the window in the valid
    convention is PyTorch's own padding for max and avg (the same
    function); any other padding is applied explicitly first (-inf for max,
    0 for the sums)."""
    same_mode = False
    if pooling_convention is not None:
        if pooling_convention == "full":
            ceil_mode = True
        elif pooling_convention == "same":
            same_mode = True
        elif pooling_convention != "valid":
            raise ValueError(
                f"unknown pooling_convention {pooling_convention!r}; "
                "expected valid/full/same")
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError(f"unknown pool_type {pool_type}")
    nd = x.dim() - 2
    last = _channels_last(layout)
    if last:
        x = x.movedim(-1, 1)
    spatial = tuple(x.shape[2:])
    dims = tuple(range(2, 2 + nd))
    if global_pool:
        if pool_type == "max":
            y = x.amax(dim=dims, keepdim=True)
        elif pool_type == "avg":
            y = x.mean(dim=dims, keepdim=True)
        elif pool_type == "sum":
            y = x.sum(dim=dims, keepdim=True)
        else:
            y = (x.abs() ** 2).sum(dim=dims, keepdim=True) ** 0.5
        return y.movedim(1, -1) if last else y
    kernel = _tup(kernel, nd)
    stride = _tup(stride or kernel, nd)
    pad = _tup(pad or 0, nd)
    pairs = _pool_pads(spatial, kernel, stride, pad, ceil_mode, same_mode)
    native = all(lo == hi == p and 2 * p <= k
                 for (lo, hi), p, k in zip(pairs, pad, kernel))
    if native and pool_type == "max":
        y = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1](
            x, kernel, stride, pad)
    elif native and pool_type == "avg":
        y = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[nd - 1](
            x, kernel, stride, pad, count_include_pad=count_include_pad)
    else:
        flat = [v for lo_hi in reversed(pairs) for v in lo_hi]
        if pool_type == "max":
            fill = (float("-inf") if x.is_floating_point()
                    else torch.iinfo(x.dtype).min)
            xp = F.pad(x, flat, value=fill)
            y = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1](
                xp, kernel, stride)
        elif pool_type == "lp":
            y = _window_sum(F.pad(x.abs() ** 2, flat), kernel, stride,
                            nd) ** 0.5
        else:
            y = _window_sum(F.pad(x, flat), kernel, stride, nd)
            if pool_type == "avg" and count_include_pad:
                y = y / math.prod(kernel)
            elif pool_type == "avg":
                ones = F.pad(torch.ones((1, 1) + spatial, dtype=x.dtype,
                                        device=x.device), flat)
                y = y / _window_sum(ones, kernel, stride, nd)
    return y.movedim(1, -1) if last else y


def flatten(x):
    """(N, ...) -> (N, -1)."""
    return x.reshape(x.shape[0], -1)


def _bn_shapes(x, axis):
    """(reduced dims, the broadcast shape of a per-channel vector, the
    number of elements per channel) (ops/nn.py:277)."""
    reduce_dims = tuple(i for i in range(x.dim()) if i != axis)
    bshape = [1] * x.dim()
    bshape[axis] = x.shape[axis]
    return reduce_dims, tuple(bshape), x.numel() // x.shape[axis]


def _bn_ew_dtype(x):
    """The elementwise dtype of the BatchNorm tensors (ops/nn.py:285): f32,
    or x's own under ``MXTPU_BN_COMPUTE=bf16``. The reductions accumulate
    in f32 either way."""
    if _env.get("MXTPU_BN_COMPUTE") == "bf16":
        return x.dtype
    return torch.float32


def _n_in(n, dtype):
    """``n`` as the JAX package divides by it: a weak-typed scalar, rounded
    to the dtype of the tensor it meets."""
    return float(torch.tensor(float(n), dtype=dtype))


def _bn_train_impl(x, gamma, beta, shift, eps, axis):
    """BatchNorm-training forward (ops/nn.py:300), the plain version of the
    K1 kernel: ``(out, mean, var, inv)``.

    The sums are taken over ``x - shift``, with the shift the moving mean
    and no gradient through it, which removes the cancellation of the
    E[x^2] - E[x]^2 form. Statistics in f32, the normalize in the
    elementwise dtype of :func:`_bn_ew_dtype`, cast back to x's dtype."""
    reduce_dims, bshape, n = _bn_shapes(x, axis)
    ew = _bn_ew_dtype(x)
    s = shift.detach().to(ew).reshape(bshape)
    xf = x.to(ew) - s
    s1 = xf.sum(reduce_dims, dtype=torch.float32)
    xf32 = xf.float()
    s2 = (xf32 * xf32).sum(reduce_dims)
    mean_c = s1 / n
    var = (s2 / n - mean_c * mean_c).clamp_min(0.0)
    mean = mean_c + s.float().reshape(s1.shape)
    inv = torch.rsqrt(var + eps)
    g32 = gamma.float()
    scale = (g32 * inv).reshape(bshape)
    offset = (beta.float() - mean_c * g32 * inv).reshape(bshape)
    out = (xf * scale.to(ew) + offset.to(ew)).to(x.dtype)
    return out, mean, var, inv


def _bn_train_bwd(eps, axis, res, cts):  # noqa: ARG001 - reference signature
    """BatchNorm-training backward (ops/nn.py:340), the plain version of the
    K2 kernel. ``res`` = (x, gamma, beta, shift, mean, inv) as the forward
    saved them; ``cts`` = (dy, dmean, dvar), the cotangents of the three
    outputs. Returns (dx, dgamma, dbeta, dshift = 0).

    dbeta = sum(dy), dgamma = sum(dy * xhat) in f32, then
    dx = gamma*inv * (dy - (dbeta + xhat*dgamma)/n) + dmean/n
    + 2*dvar*(x - mean)/n in the elementwise dtype. x is centred on the
    shift before anything is subtracted in low precision, as in the
    forward."""
    dy, dmean, dvar = cts
    x, gamma, beta, shift, mean, inv = res
    reduce_dims, bshape, n = _bn_shapes(x, axis)
    ew = _bn_ew_dtype(x)
    n_ew = _n_in(n, ew)
    dyf = dy.to(ew)
    s = shift.detach().float().reshape(bshape)
    xf = x.to(ew) - s.to(ew)
    mean_c = (mean.reshape(bshape) - s).to(ew)
    xhat = (xf - mean_c) * inv.to(ew).reshape(bshape)
    dbeta = dyf.sum(reduce_dims, dtype=torch.float32)
    dgamma = (dyf * xhat).sum(reduce_dims, dtype=torch.float32)
    g32 = gamma.float()
    dx = (g32 * inv).to(ew).reshape(bshape) * (
        dyf - (dbeta.to(ew).reshape(bshape)
               + xhat * dgamma.to(ew).reshape(bshape)) / n_ew)
    dx = dx + (dmean.to(ew).reshape(bshape) / n_ew
               + dvar.to(ew).reshape(bshape) * 2.0 * (xf - mean_c) / n_ew)
    return (dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            torch.zeros_like(shift))


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, training=True, use_global_stats=False, axis=1):
    """Batch normalization (ops/nn.py:379): ``(out, new_mean, new_var)``.

    Training takes the batch statistics through kernels/norm.py:bn_train
    (the K1/K2 kernels for CUDA tensors, their plain versions for CPU
    tensors) and returns the moving statistics blended as
    ``moving * momentum + batch * (1 - momentum)``, with the biased batch
    variance; updating them is the caller's job. Otherwise the moving
    statistics normalize, in f32."""
    axis = axis % x.dim()
    if training and not use_global_stats:
        from ..kernels import norm as _knorm
        out, mean, var = _knorm.bn_train(x, gamma, beta, moving_mean,
                                         float(eps), axis)
        new_mean = (moving_mean * momentum
                    + mean.to(moving_mean.dtype) * (1 - momentum))
        new_var = (moving_var * momentum
                   + var.to(moving_var.dtype) * (1 - momentum))
        return out, new_mean, new_var
    _, bshape, _ = _bn_shapes(x, axis)
    inv = torch.rsqrt(moving_var.float() + eps)
    g32 = gamma.float()
    scale = (g32 * inv).reshape(bshape)
    shift = (beta.float() - moving_mean.float() * g32 * inv).reshape(bshape)
    out = (x.float() * scale + shift).to(x.dtype)
    return out, moving_mean, moving_var


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization forward (ops/nn.py:478, ``_ln_impl``).

    Single-pass f32 statistics shifted by the row's first element (which
    removes the cancellation of the raw E[x^2] - E[x]^2 form), then the
    affine in f32, cast back to x's dtype."""
    axis = axis % x.dim()
    xf = x.float()
    n = x.shape[axis]
    x0 = xf.narrow(axis, 0, 1)
    xc = xf - x0
    s1 = xc.sum(dim=axis, keepdim=True)
    s2 = (xc * xc).sum(dim=axis, keepdim=True)
    mean_c = s1 / n
    var = (s2 / n - mean_c * mean_c).clamp_min(0.0)
    mean = mean_c + x0
    out = (xf - mean) * torch.rsqrt(var + eps)
    bshape = [1] * x.dim()
    bshape[axis] = n
    if gamma is not None:
        out = out * gamma.float().reshape(bshape)
    if beta is not None:
        out = out + beta.float().reshape(bshape)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sqrt_half(dtype):
    """sqrt(1/2) rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(math.sqrt(0.5), dtype=dtype))


def gelu_exact(x):
    """The exact GELU as ``jax.nn.gelu(x, approximate=False)`` computes it
    (ops/nn.py:579 of the JAX package): ``0.5 * x * erfc(-x * sqrt_half)``
    with ``sqrt_half`` rounded to x's dtype, op by op, so that bfloat16
    rounds where JAX rounds (``x * -sqrt_half`` is ``-x * sqrt_half`` bit
    for bit, one launch fewer). The erf form ``x/2 * (1 + erf(x/sqrt 2))``
    cancels for x < -2; erfc does not. The gradient is autograd's through
    these ops, as ``jax.vjp`` goes through them."""
    return 0.5 * x * torch.special.erfc(x * -_sqrt_half(x.dtype))


def _hard_sigmoid(x):
    """``jax.nn.hard_sigmoid``: relu6(x + 3) / 6."""
    return F.relu6(x + 3.0) / 6.0


_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    # the reference gelu is the exact erf form; the tanh approximation is
    # opt-in under its own name
    "gelu": gelu_exact,
    "erf_gelu": gelu_exact,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "hard_sigmoid": _hard_sigmoid,
    "hard_swish": lambda x: x * _hard_sigmoid(x),
    # jnp.clip: min(max(x, 0), 6), whose gradient is split at the ties
    "relu6": lambda x: torch.minimum(torch.maximum(x, x.new_zeros(())),
                                     x.new_full((), 6.0)),
    "identity": lambda x: x,
}


def activation(x, act_type="relu"):
    """Activation dispatch (ops/nn.py:592), over the JAX package's table
    (ops/nn.py:569): ``softmax`` and ``log_softmax`` over the last axis,
    ``softrelu`` softplus, ``hard_sigmoid`` relu6(x + 3) / 6."""
    try:
        return _ACTS[act_type](x)
    except KeyError:
        raise ValueError(f"unknown act_type '{act_type}'") from None


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def leaky_relu(x, gamma=None, act_type="leaky", slope=0.25):
    """The LeakyReLU family (ops/nn.py:602): leaky, prelu (``gamma`` per
    channel of axis 1), elu, selu, gelu and rrelu (its predict-mode form,
    a leaky ReLU). Each branch is a ``where``, so the gradient at 0 is the
    positive side's, as in the JAX package."""
    if act_type in ("leaky", "rrelu"):
        return torch.where(x >= 0, x, slope * x)
    if act_type == "prelu":
        if gamma.dim() == 1 and x.dim() > 2:
            gamma = gamma.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, gamma * x)
    if act_type == "elu":
        return torch.where(x >= 0, x, slope * torch.expm1(x))
    if act_type == "selu":    # jax.nn.selu: expm1 of the negative side only
        neg = torch.where(x > 0, torch.zeros_like(x), x)
        return _SELU_SCALE * torch.where(x > 0, x,
                                         _SELU_ALPHA * torch.expm1(neg))
    if act_type == "gelu":
        return gelu_exact(x)
    raise ValueError(f"unknown act_type '{act_type}'")


def group_norm(x, gamma, beta, num_groups, eps=1e-5):
    """Group normalization over (N, C, *spatial) (ops/nn.py:487): the
    statistics of each of ``num_groups`` channel groups of a sample, the
    variance biased, in x's dtype."""
    n, c = x.shape[:2]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=axes, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    if gamma is not None:
        out = out * gamma.reshape(bshape)
    if beta is not None:
        out = out + beta.reshape(bshape)
    return out


def instance_norm(x, gamma, beta, eps=1e-5):
    """Instance normalization: a group a channel (ops/nn.py:506)."""
    return group_norm(x, gamma, beta, num_groups=x.shape[1], eps=eps)


def softmax(x, axis=-1, length=None, temperature=None):
    """Softmax with optional sequence-length masking (ops/nn.py:540)."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if length is not None:
        axis = axis % x.dim()
        mask = (torch.arange(x.shape[axis], device=x.device)
                < length.unsqueeze(-1))
        shape = [1] * x.dim()
        shape[0] = x.shape[0]
        shape[axis] = x.shape[axis]
        x = x.masked_fill(~mask.reshape(shape), float("-inf"))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, temperature=None):
    """Log-softmax (ops/nn.py:554). The row's maximum, sum and logarithm
    are taken in f32 whatever x's dtype, and the result is cast back."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.log_softmax(x.float(), dim=axis).to(x.dtype)


def softmax_cross_entropy(data, label):
    """Scalar cross entropy summed over the batch
    (ops/tensor.py:softmax_cross_entropy): ``-sum(log_softmax(data)[i,
    label[i]])``."""
    logp = log_softmax(data, axis=-1)
    picked = torch.take_along_dim(logp, label.long()[:, None], dim=-1)
    return -picked.sum()


def embedding(indices, weight):
    """Embedding lookup (ops/nn.py:650): rows of ``weight`` by int32 or
    int64 ids."""
    return F.embedding(indices, weight)


def dropout(x, p=0.5, training=True, axes=None, generator=None):
    """Inverted dropout (ops/nn.py:628). The keep mask is drawn from
    ``generator`` (a ``torch.Generator`` on x's device; None draws from the
    device's default generator). ``axes`` are the axes the mask is shared
    along."""
    if not training or p <= 0.0:
        return x
    shape = list(x.shape)
    for ax in axes or ():
        shape[ax] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, device=x.device).bernoulli_(
        keep, generator=generator).bool()
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
