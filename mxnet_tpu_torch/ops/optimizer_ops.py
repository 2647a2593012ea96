"""The optimizer update ops of the legacy API (counterpart of
mxnet_tpu/ops/optimizer_ops.py): ``sgd_update`` to ``lans_update_phase1``,
``all_finite``, ``multi_all_finite`` and ``multi_sum_sq``.

Plain PyTorch on either device, as the JAX package leaves them to XLA
(they are not the fused ladder K3, which the Trainer runs). Each update
is pure: it returns the new weight (or update) and the new states, and
``mx.nd`` writes them in place (``ndarray/__init__.py``). Python scalars
stay weak, so f32 tensors compute in f32 as in the JAX package. The
reductions run where the arrays lie, and nothing is read on the host.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ["multi_all_finite", "multi_sum_sq"]


def _tensor(a):
    return getattr(a, "_data", a)


def _prep(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register_op("sgd_update")
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=False):  # noqa: ARG001
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


@register_op("sgd_mom_update")
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0,
                   lazy_update=False):  # noqa: ARG001
    """``mom' = momentum * mom - lr * (g + wd * w)``, ``w' = w + mom'``."""
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom


@register_op("nag_mom_update")
def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@register_op("signsgd_update")
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register_op("signum_update")
def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1.0 - momentum) * (g + wd * weight)
    return weight * (1 - lr * wd_lh) + lr * torch.sign(new_mom), new_mom


@register_op("adam_update")
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=False):  # noqa: ARG001
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return w, new_mean, new_var


@register_op("adamw_update")
def adamw_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """Decoupled weight decay (contrib adamw.cc)."""
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - eta * (lr * new_mean / (torch.sqrt(new_var) + epsilon)
                        + wd * weight)
    return w, new_mean, new_var


register_op("_adamw_update", adamw_update)


@register_op("lamb_update_phase1")
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """``(update, mean', var')``; phase 2 scales the update by the trust
    ratio."""
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    m, v = new_mean, new_var
    if bias_correction:
        m = m / (1 - beta1 ** t)
        v = v / (1 - beta2 ** t)
    return m / (torch.sqrt(v) + epsilon) + wd * weight, new_mean, new_var


@register_op("lamb_update_phase2")
def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """``w - lr * r1 / r2 * g``, the ratio 1 unless both norms are
    positive; ``r1`` clipped to the bounds that are positive."""
    if lower_bound > 0:
        r1 = torch.clamp_min(r1, lower_bound)
    if upper_bound > 0:
        r1 = torch.clamp_max(r1, upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                        torch.ones((), dtype=r1.dtype, device=r1.device))
    return weight - lr * ratio * g


register_op("mp_lamb_update_phase2", lamb_update_phase2)


@register_op("rmsprop_update")
def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    w = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, new_n


@register_op("rmspropalex_update")
def rmspropalex_update(weight, grad, n, g_avg, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Graves' RMSProp."""
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_g = gamma1 * g_avg + (1 - gamma1) * g
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    w = weight + new_delta
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, new_n, new_g, new_delta


@register_op("ftrl_update")
def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(new_z),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return w, new_z, new_n


@register_op("adagrad_update")
def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_hist = history + torch.square(g)
    w = weight - lr * (g / torch.sqrt(new_hist + epsilon) + wd * weight)
    return w, new_hist


register_op("_sparse_adagrad_update", adagrad_update)


@register_op("adadelta_update")
def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(
        new_acc_g + epsilon) * g
    new_acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    return weight - delta - wd * weight, new_acc_g, new_acc_delta


@register_op("all_finite")
def all_finite(data, init_output=True):  # noqa: ARG001
    """A ``(1,)`` f32 tensor: 1 when every element is finite, else 0."""
    return torch.isfinite(data).all().to(torch.float32).reshape(1)


@register_op("multi_all_finite")
def multi_all_finite(*arrays, num_arrays=None,
                     init_output=True):  # noqa: ARG001 - the op's signature
    """A ``(1,)`` f32 tensor: 1 when every element of every array is
    finite, else 0."""
    if not arrays:
        return torch.ones(1, dtype=torch.float32)
    flags = torch.stack([torch.isfinite(_tensor(a)).all() for a in arrays])
    return flags.all().to(torch.float32).reshape(1)


@register_op("multi_sum_sq")
def multi_sum_sq(*arrays, num_arrays=None):  # noqa: ARG001
    """The sum of squares of each array, in f32, as a tuple of 0-dim
    tensors."""
    return tuple(torch.sum(torch.square(_tensor(a).float())) for a in arrays)


@register_op("adabelief_update")
def adabelief_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                     epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                     clip_gradient=-1.0):
    """AdaBelief: the variance of the prediction error ``(g - m)^2``."""
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    m = beta1 * mean + (1 - beta1) * g
    s = beta2 * var + (1 - beta2) * torch.square(g - m) + epsilon
    return weight - lr * m / (torch.sqrt(s) + epsilon), m, s


register_op("_adabelief_update", adabelief_update)


@register_op("ftml_update")
def ftml_update(weight, grad, d, v, z, lr, t, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    g = _prep(grad, rescale_grad, clip_grad) + wd * weight
    v_new = beta2 * v + (1 - beta2) * torch.square(g)
    d_new = (1 - beta1 ** t) / lr * (
        torch.sqrt(v_new / (1 - beta2 ** t)) + epsilon)
    sigma = d_new - beta1 * d
    z_new = beta1 * z + (1 - beta1) * g - sigma * weight
    return -z_new / d_new, d_new, v_new, z_new


@register_op("group_adagrad_update")
def group_adagrad_update(weight, grad, history, lr, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """Row-wise AdaGrad: one accumulator per row of the weight."""
    g = _prep(grad, rescale_grad, clip_gradient)
    if g.dim() > 1:
        h = history + torch.square(g).mean(dim=tuple(range(1, g.dim())))
        scale = h.reshape((-1,) + (1,) * (g.dim() - 1))
    else:
        h = scale = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(scale) + epsilon), h


register_op("_contrib_group_adagrad_update", group_adagrad_update)


@register_op("lans_update_phase1")
def lans_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    """LANS phase 1: LAMB's moments of the L2-normalized gradient;
    ``(update_m, update_g, mean', var')``."""
    g = _prep(grad, rescale_grad, clip_gradient)
    g = g / torch.clamp_min(torch.sqrt(torch.sum(torch.square(g))), 1e-12)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    denom = torch.sqrt(v / (1 - beta2 ** t)) + epsilon
    return (m / (1 - beta1 ** t) / denom + wd * weight,
            g / denom + wd * weight, m, v)


for _name in ("_multi_lans_update", "_multi_mp_lans_update"):
    register_op(_name, lans_update_phase1)
