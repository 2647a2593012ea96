"""Neural-net ops BERT needs, as plain tensor functions (counterpart of
mxnet_tpu/ops/nn.py).

Each mirrors the JAX op's arithmetic: dtypes promote as ``jnp`` promotes
them, LayerNorm takes its statistics in f32 and casts back, ``gelu`` is the
exact erf form. These ops are left to PyTorch's own CUDA paths, as the JAX
package left them to XLA; none of them reaches a Pallas kernel there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fully_connected", "layer_norm", "activation", "softmax",
           "log_softmax", "softmax_cross_entropy", "embedding", "dropout"]


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


_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # the reference gelu is the exact erf form; the tanh approximation is
    # opt-in under its own name
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "erf_gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "identity": lambda x: x,
}


def activation(x, act_type="relu"):
    """Activation dispatch (ops/nn.py:592)."""
    try:
        return _ACTS[act_type](x)
    except KeyError:
        raise ValueError(f"unknown act_type '{act_type}'") from None


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
