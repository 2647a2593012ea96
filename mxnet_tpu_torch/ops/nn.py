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
from ..base import normalize_dtype
from .registry import register_op

__all__ = ["fully_connected", "conv", "conv_transpose", "pool", "flatten",
           "batch_norm", "layer_norm", "group_norm", "instance_norm",
           "rms_norm", "lrn", "activation", "leaky_relu", "softmax",
           "log_softmax", "softmin", "softmax_cross_entropy", "embedding",
           "dropout", "one_hot", "pick", "topk", "sequence_mask",
           "sequence_last", "sequence_reverse", "l2_normalization",
           "upsample", "moments"]


def fully_connected(x, weight, bias=None, flatten=True, num_hidden=None,
                    no_bias=None):  # noqa: ARG001 - the op's signature
    """``y = x @ W^T + b`` with weight (units, in_units) (ops/nn.py:26).
    With ``flatten`` the input is reshaped to (N, -1) first. Mixed dtypes
    promote (bf16 activations into an f32 head give f32), as in JAX.
    ``num_hidden`` is the reference's shape hint (the weight decides);
    ``no_bias`` drops a bias that was passed."""
    if no_bias:
        bias = None
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


def _to_kernel_spec(weight, kernel_layout, layout, nd):
    """``weight``, whose axes ``kernel_layout`` names (``O``, ``I`` and the
    layout's spatial letters), permuted to the layout's own weight spec:
    ``OI`` + spatial channels-first, ``O`` + spatial + ``I`` channels-last
    (ops/nn.py:_layout_spec)."""
    sp = ("DHW"[-nd:] if layout is None
          else layout.replace("N", "").replace("C", ""))
    want = "O" + sp + "I" if _channels_last(layout) else "OI" + sp
    if sorted(kernel_layout) != sorted(want):
        raise ValueError(f"kernel_layout {kernel_layout!r} does not name the "
                         f"axes of {want!r}")
    return weight.permute(*[kernel_layout.index(a) for a in want])


def conv(x, weight, bias=None, stride=None, pad=None, dilate=None, groups=1,
         layout=None, kernel_layout=None):
    """N-d convolution (ops/nn.py:71) in the NCHW family (default) or the
    NHWC family. Weights are ``(O, I/g, *k)`` channels-first and
    ``(O, *k, I/g)`` channels-last, the JAX package's shapes, so checkpoints
    map 1:1. ``kernel_layout`` (e.g. ``"HWIO"``) names the weight's own
    axes instead; the weight is permuted to the layout's spec first.

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
    if kernel_layout is not None:
        weight = _to_kernel_spec(weight, kernel_layout, layout, nd)
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


def embedding(indices, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):  # noqa: ARG001 - the op's signature
    """Embedding lookup (ops/nn.py:650): rows of ``weight`` by ids of any
    dtype (floats truncate, as the JAX package's int32 cast does).
    ``input_dim``/``output_dim`` are checked against the weight, ``dtype``
    casts the rows."""
    if input_dim is not None and weight.shape[0] != input_dim:
        raise ValueError(f"embedding input_dim {input_dim} != weight rows "
                         f"{weight.shape[0]}")
    if output_dim is not None and weight.shape[-1] != output_dim:
        raise ValueError(f"embedding output_dim {output_dim} != weight "
                         f"cols {weight.shape[-1]}")
    if indices.dtype not in (torch.int32, torch.int64):
        indices = indices.to(torch.int32)
    out = F.embedding(indices, weight)
    return out if dtype is None else out.to(normalize_dtype(dtype))


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


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """RMSNorm (ops/nn.py:512): the mean square in f32, the normalized
    value cast back to x's dtype, then times ``gamma``."""
    ms = x.float().square().mean(dim=axis, keepdim=True)
    out = (x.float() * torch.rsqrt(ms + eps)).to(x.dtype)
    return out * gamma if gamma is not None else out


def lrn(x, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across channels (ops/nn.py:522):
    ``x / (knorm + alpha / nsize * sum of squares over the window) **
    beta``, the window zero-padded at the channel edges."""
    half = nsize // 2
    sq = F.pad(x.square(), (0, 0) * (x.dim() - 2) + (half, half))
    acc = sum(sq.narrow(1, i, x.shape[1]) for i in range(nsize))
    return x / (knorm + alpha / nsize * acc) ** beta


def softmin(x, axis=-1):
    """Softmax of ``-x`` (ops/nn.py:561)."""
    return torch.softmax(-x, dim=axis)


def one_hot(indices, depth, on_value=1.0, off_value=0.0,
            dtype=torch.float32):
    """One-hot rows of ``depth`` (ops/nn.py:677); an index outside
    [0, depth) gives a row of ``off_value``, as ``jax.nn.one_hot``."""
    idx = indices.to(torch.int64).unsqueeze(-1)
    oh = (idx == torch.arange(depth, device=idx.device)).to(
        normalize_dtype(dtype))
    if on_value != 1.0 or off_value != 0.0:
        oh = oh * (on_value - off_value) + off_value
    return oh


def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """Elements of ``x`` along ``axis`` by ``index`` (ops/nn.py:685);
    out-of-range indices clip or wrap."""
    n = x.shape[axis]
    index = index.to(torch.int64)
    index = index.clamp(0, n - 1) if mode == "clip" else index % n
    picked = torch.take_along_dim(x, index.unsqueeze(axis), dim=axis)
    return picked if keepdims else picked.squeeze(axis)


def topk(x, k=1, axis=-1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (or smallest) along ``axis`` (ops/nn.py:697).
    ``lax.top_k`` keeps the lower index first among ties; a stable sort
    does the same. ``dtype`` is the returned indices' (None: int32);
    ``ret_typ`` is indices, value, both or mask."""
    axis = axis % x.dim()
    vals, idx = torch.sort(x, dim=axis, descending=not is_ascend,
                           stable=True)
    vals, idx = vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)
    cast = (lambda i: i.to(torch.int32)) if dtype is None else (
        lambda i: i.to(normalize_dtype(dtype)))
    if ret_typ == "indices":
        return cast(idx)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, cast(idx)
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(axis, idx, 1.0)
    raise ValueError(f"unknown ret_typ {ret_typ}")


def _steps_mask(x, sequence_length, axis):
    """(T, N) or (N, T) mask of the steps inside each sequence,
    broadcastable against ``x``."""
    steps = torch.arange(x.shape[axis], device=x.device)
    if axis == 0:
        mask = steps[:, None] < sequence_length[None, :]
    else:
        mask = steps[None, :] < sequence_length[:, None]
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))


def sequence_mask(x, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """``value`` past each sequence's length (ops/nn.py:734); ``x`` is
    (T, N, ...) for axis 0, else (N, T, ...)."""
    if not use_sequence_length or sequence_length is None:
        return x
    return torch.where(_steps_mask(x, sequence_length, axis), x,
                       torch.full((), value, dtype=x.dtype,
                                  device=x.device))


def sequence_last(x, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """The last step of each sequence (ops/nn.py:750)."""
    if not use_sequence_length or sequence_length is None:
        return x.select(axis, -1)
    idx = (sequence_length - 1).to(torch.int64)
    shape = (1, -1) if axis == 0 else (-1, 1)
    idx = idx.reshape(shape + (1,) * (x.dim() - 2))
    return torch.take_along_dim(x, idx, dim=axis).squeeze(axis)


def sequence_reverse(x, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence reversed within its length, the steps past it left
    in place (ops/nn.py:764); (T, N, ...) only, as there."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(x, (axis,))
    if axis != 0:
        raise NotImplementedError(
            "sequence_reverse supports axis=0 (T,N,...)")
    steps = torch.arange(x.shape[0], device=x.device)[:, None]
    lengths = sequence_length.to(torch.int64)[None, :]
    rev = torch.where(steps < lengths, lengths - 1 - steps, steps)
    return torch.take_along_dim(
        x, rev.reshape(tuple(rev.shape) + (1,) * (x.dim() - 2)), dim=0)


def l2_normalization(x, eps=1e-10, mode="instance"):
    """``x`` over its L2 norm per instance, channel or spatial position
    (ops/nn.py:781)."""
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, x.dim()))
    return x / torch.sqrt(x.square().sum(dim=axes, keepdim=True) + eps)


def upsample(x, scale=2, sample_type="nearest"):
    """(N, C, H, W) upsampled by ``scale`` (ops/nn.py:793): nearest
    repeats each pixel, bilinear interpolates at half-pixel centres, as
    ``jax.image.resize`` does when it enlarges."""
    if sample_type == "nearest":
        return F.interpolate(x, scale_factor=scale, mode="nearest")
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


def moments(x, axes=None, keepdims=False):
    """``(mean, biased variance)`` over ``axes`` (ops/nn.py:802)."""
    dims = None if axes is None else tuple(axes)
    mean = x.mean(dim=dims, keepdim=keepdims)
    var = (x - x.mean(dim=dims, keepdim=True)).square().mean(
        dim=dims, keepdim=keepdims)
    return mean, var


def _dropout_op(x, key=None, p=0.5, training=True, axes=None):
    """The registry's ``dropout`` (ops/nn.py:628): the JAX package's key is
    a ``torch.Generator`` here, on x's device; None draws from the
    device's generator (``_random.generator``)."""
    if key is None:
        from .. import _random

        key = _random.generator(x.device)
    return dropout(x, p=p, training=training, axes=axes, generator=key)


# The op names of ops/nn.py's registrations (and the two aliases.py gives
# nn functions, and tensor.py's softmax_cross_entropy), with the
# reference's call signatures.
for _name, _fn in (
        ("fully_connected", fully_connected), ("convolution", conv),
        ("deconvolution", conv_transpose), ("pooling", pool),
        ("batch_norm", batch_norm), ("_contrib_SyncBatchNorm", batch_norm),
        ("layer_norm", layer_norm), ("group_norm", group_norm),
        ("GroupNorm", group_norm), ("instance_norm", instance_norm),
        ("rms_norm", rms_norm), ("lrn", lrn), ("softmax", softmax),
        ("log_softmax", log_softmax), ("softmin", softmin),
        ("softmax_cross_entropy", softmax_cross_entropy),
        ("activation", activation), ("leaky_relu", leaky_relu),
        ("dropout", _dropout_op), ("embedding", embedding),
        ("one_hot", one_hot), ("pick", pick), ("topk", topk),
        ("sequence_mask", sequence_mask), ("sequence_last", sequence_last),
        ("sequence_reverse", sequence_reverse),
        ("l2_normalization", l2_normalization), ("upsampling", upsample),
        ("moments", moments)):
    register_op(_name, _fn)
del _name, _fn
