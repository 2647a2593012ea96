"""Deformable convolution as plain tensor functions (counterpart of
mxnet_tpu/ops/vision.py:_bilinear_gather :25 and
deformable_convolution :201).

The JAX package expresses the op as one bilinear gather per kernel tap
and one contraction, which XLA fuses; no Pallas kernel lies behind it.
Here the same gathers are ``take_along_dim`` calls and the contraction an
``einsum``; gradients reach the input, the offsets, the mask and the
weight through torch autograd.
"""
from __future__ import annotations

import torch

__all__ = ["deformable_convolution"]


def _bilinear_gather(data, x_real, y_real):
    """Sample ``data`` (N, C, H, W) at the real pixel coordinates
    ``x_real``/``y_real`` (N, *spatial); a corner outside the image
    contributes 0. Returns (N, C, *spatial)."""
    n, c, h, w = data.shape
    sp = tuple(x_real.shape[1:])
    x0 = torch.floor(x_real).to(torch.int64)
    y0 = torch.floor(y_real).to(torch.int64)
    wx1 = x_real - x0
    wy1 = y_real - y0
    flat_data = data.reshape(n, c, h * w)

    def corner(yc, xc, wgt):
        valid = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        flat = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).reshape(n, 1, -1)
        g = torch.take_along_dim(flat_data, flat.expand(n, c, flat.shape[-1]),
                                 dim=2).reshape((n, c) + sp)
        wgt = torch.where(valid, wgt, torch.zeros((), dtype=wgt.dtype,
                                                  device=wgt.device))
        return g * wgt[:, None].to(data.dtype)

    out = corner(y0, x0, (1 - wy1) * (1 - wx1))
    out = out + corner(y0, x0 + 1, (1 - wy1) * wx1)
    out = out + corner(y0 + 1, x0, wy1 * (1 - wx1))
    return out + corner(y0 + 1, x0 + 1, wy1 * wx1)


def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                           num_deformable_group=1, groups=1, mask=None):
    """DCNv1, and with ``mask`` (N, k*k*G, Ho, Wo) the modulated DCNv2
    (ops/vision.py:201). ``offset`` (N, 2*k*k*G, Ho, Wo) holds each
    output position's (dy, dx) for each kernel tap of each deformable
    group; every tap is one bilinear gather, then one contraction with the
    weight (O, C/groups, kh, kw)."""
    n, c, h, w = data.shape
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    dh, dw = dilate
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    g = num_deformable_group
    cg = c // g
    dev = data.device
    ys = torch.arange(ho, device=dev) * sh - ph
    xs = torch.arange(wo, device=dev) * sw - pw
    base_y, base_x = torch.meshgrid(ys, xs, indexing="ij")
    cols = []
    for ki in range(kh):
        for kj in range(kw):
            tap = ki * kw + kj
            dy = offset[:, 2 * tap::2 * kh * kw]
            dx = offset[:, 2 * tap + 1::2 * kh * kw]
            m = mask[:, tap::kh * kw] if mask is not None else None
            samples = []
            for gi in range(g):
                y_real = base_y[None] + ki * dh + dy[:, gi]
                x_real = base_x[None] + kj * dw + dx[:, gi]
                samp = _bilinear_gather(data[:, gi * cg:(gi + 1) * cg],
                                        x_real.float(), y_real.float())
                if m is not None:
                    samp = samp * m[:, gi:gi + 1]
                samples.append(samp)
            cols.append(torch.cat(samples, dim=1))
    col = torch.stack(cols, dim=2)   # (N, C, k*k, Ho, Wo)
    wmat = weight.reshape(weight.shape[0], weight.shape[1], kh * kw)
    if groups == 1:
        out = torch.einsum("nckhw,ock->nohw", col, wmat)
    else:
        og, cpg = weight.shape[0] // groups, c // groups
        out = torch.cat([torch.einsum(
            "nckhw,ock->nohw", col[:, gi * cpg:(gi + 1) * cpg],
            wmat[gi * og:(gi + 1) * og]) for gi in range(groups)], dim=1)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out
