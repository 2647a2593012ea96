"""The legacy standalone vision ops as plain tensor functions (counterpart
of mxnet_tpu/ops/vision.py): BilinearSampler, GridGenerator,
SpatialTransformer, ROIPooling, Correlation, DeformableConvolution and
Crop, registered under those names.

The JAX package expresses each as gathers with static loops, which XLA
fuses; no Pallas kernel lies behind any of them. Here the gathers are
``take_along_dim`` calls and the contractions ``einsum``s; gradients come
from torch autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op

__all__ = ["deformable_convolution", "bilinear_sampler", "grid_generator",
           "spatial_transformer", "roi_pooling", "correlation", "crop"]


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


@register_op("DeformableConvolution")
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


@register_op("BilinearSampler")
def bilinear_sampler(data, grid, cudnn_off=None):  # noqa: ARG001
    """``data`` (N, C, H, W) sampled at ``grid`` (N, 2, Ho, Wo) in [-1, 1],
    channel 0 x and 1 y, at pixel ``(g + 1) * (size - 1) / 2``
    (vision.py:60)."""
    _, _, h, w = data.shape
    x_real = (grid[:, 0] + 1) * (w - 1) / 2
    y_real = (grid[:, 1] + 1) * (h - 1) / 2
    return _bilinear_gather(data, x_real, y_real)


@register_op("GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=None):
    """A sampling grid (N, 2, H, W) in [-1, 1] (vision.py:70): ``affine``
    from (N, 6) matrices over the target grid, ``warp`` from a flow
    (N, 2, H, W) added to the pixel grid."""
    if transform_type == "affine":
        h, w = target_shape
        theta = data.reshape(-1, 2, 3)
        ys, xs = torch.meshgrid(
            torch.linspace(-1.0, 1.0, h, dtype=data.dtype,
                           device=data.device),
            torch.linspace(-1.0, 1.0, w, dtype=data.dtype,
                           device=data.device), indexing="ij")
        coords = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
        return torch.einsum("nij,jk->nik", theta, coords).reshape(-1, 2, h,
                                                                  w)
    _, _, h, w = data.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=data.device),
                            torch.arange(w, device=data.device),
                            indexing="ij")
    gx = 2 * (data[:, 0] + xs.to(data.dtype)) / (w - 1) - 1
    gy = 2 * (data[:, 1] + ys.to(data.dtype)) / (h - 1) - 1
    return torch.stack([gx, gy], dim=1)


@register_op("SpatialTransformer")
def spatial_transformer(data, loc, target_shape=None,
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=None):  # noqa: ARG001
    """An affine grid from ``loc`` (N, 6), then bilinear sampling
    (vision.py:101)."""
    return bilinear_sampler(data, grid_generator(loc, "affine",
                                                 target_shape))


@register_op("ROIPooling")
def roi_pooling(data, rois, pooled_size, spatial_scale):
    """Max over each of ``pooled_size`` bins of each ROI (vision.py:112):
    ``rois`` (R, 5) = [batch index, x1, y1, x2, y2] in image coordinates,
    rounded after scaling; bin p spans [floor(p * bin), ceil((p + 1) *
    bin)) clipped to the map; an empty bin gives 0."""
    _, c, h, w = data.shape
    ph, pw = pooled_size
    dev = data.device
    corner = torch.round(rois[:, 1:5] * spatial_scale).to(torch.int64)
    sw, sh, ew, eh = corner.unbind(1)
    roi_h = (eh - sh + 1).clamp_min(1).to(torch.float32)
    roi_w = (ew - sw + 1).clamp_min(1).to(torch.float32)

    def edges(n_bins, size, start, extent):
        p = torch.arange(n_bins, dtype=torch.float32, device=dev)[None]
        per = (extent / n_bins)[:, None]
        lo = torch.floor(p * per).to(torch.int64) + start[:, None]
        hi = torch.ceil((p + 1) * per).to(torch.int64) + start[:, None]
        return lo.clamp(0, size), hi.clamp(0, size)

    hs, he = edges(ph, h, sh, roi_h)
    ws, we = edges(pw, w, sw, roi_w)
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    mask_h = (rows >= hs[..., None]) & (rows < he[..., None])  # (R, PH, H)
    mask_w = (cols >= ws[..., None]) & (cols < we[..., None])  # (R, PW, W)
    g = data[rois[:, 0].to(torch.int64)].float()               # (R, C, H, W)
    neg = torch.tensor(float("-inf"), device=dev)
    tw = torch.where(mask_w[:, None, None], g[:, :, :, None, :],
                     neg).amax(-1)                             # (R, C, H, PW)
    out = torch.where(mask_h[:, None, :, :, None], tw[:, :, None],
                      neg).amax(-2)                            # (R, C, PH, PW)
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out.to(data.dtype)


@register_op("Correlation")
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's patch correlation (vision.py:170): one output channel per
    displacement of a (2r + 1)^2 grid, r = max_displacement // stride2,
    each value the mean over the kernel window and the channels of the
    product (or absolute difference)."""
    n, c, h, w = data1.shape
    k = kernel_size
    kr = (k - 1) // 2
    border = max_displacement + kr
    ph_, pw_ = h + 2 * pad_size, w + 2 * pad_size
    top_h = -(-(ph_ - 2 * border) // stride1)
    top_w = -(-(pw_ - 2 * border) // stride1)
    r = max_displacement // stride2
    pads = (pad_size,) * 4
    p1, p2 = F.pad(data1, pads), F.pad(data2, pads)
    oh, ow = ph_ - 2 * border, pw_ - 2 * border
    outs = []
    for di in range(-r, r + 1):
        for dj in range(-r, r + 1):
            acc = 0.0
            for hh in range(-kr, kr + 1):
                for ww in range(-kr, kr + 1):
                    y0 = max_displacement + hh + kr
                    x0 = max_displacement + ww + kr
                    a = p1[:, :, y0:y0 + oh, x0:x0 + ow]
                    b = p2[:, :, y0 + di * stride2:y0 + di * stride2 + oh,
                           x0 + dj * stride2:x0 + dj * stride2 + ow]
                    acc = acc + (a * b if is_multiply else (a - b).abs())
            acc = acc.sum(dim=1) / (k * k * c)
            outs.append(acc[:, ::stride1, ::stride1][:, :top_h, :top_w])
    return torch.stack(outs, dim=1)


@register_op("Crop")
def crop(data, crop_like=None, offset=(0, 0), h_w=(0, 0), center_crop=False):
    """H and W cut to ``h_w`` or to ``crop_like``'s, from ``offset`` or
    the centre (vision.py:265)."""
    _, _, h, w = data.shape
    th, tw = ((crop_like.shape[2], crop_like.shape[3])
              if crop_like is not None else h_w)
    oy, ox = ((h - th) // 2, (w - tw) // 2) if center_crop else offset
    return data[:, :, oy:oy + th, ox:ox + tw]
