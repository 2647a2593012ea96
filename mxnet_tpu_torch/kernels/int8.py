"""INT8 inference: the Q1 and Q2 CUDA kernels' wrappers and their plain
versions (the kernels behind mxnet_tpu_torch/contrib/quantization.py).

Neither replaces a Pallas kernel: the JAX package computes both with XLA
(mxnet_tpu/contrib/quantization.py), and PyTorch has no int8 convolution on
the card, so both are written by hand for Hopper.

- Q1, :func:`quantize` (``csrc/int8_quant.cu``): the reference's ``_q``
  (:40) in one elementwise pass: an optional clip of x to [lo, hi], scale
  ``127 / max(|lo|, |hi|, 1e-20)``, codes ``round_half_even(x * scale)``
  saturated to [-127, 127], and ``(-amax, amax, scale)`` beside them, with
  ``amax = 127 / scale``. lo and hi come as a 2-element f32 tensor on the
  tensors' device (a dynamic range from ``torch.aminmax`` on the card: no
  host read). With ``channels_last`` the codes of a 4-D x keep its shape
  and values but are stored NHWC (``torch.channels_last``), as Q2's wgmma
  variant reads them.
- Q2, :func:`conv`: int8 x int8 -> int32 convolution with stride, zero
  padding, dilation and groups (a Dense layer as a 1x1 convolution over a
  1x1 plane), returning the int32 sums, or with ``xscale`` the f32
  ``acc / (xscale * wscale[o]) + bias[o]`` and ReLU, as QuantizedConv2D and
  QuantizedDense compute them. Two variants, chosen by :func:`plan_conv`
  from the shapes alone: ``wgmma`` (``csrc/int8_conv_wgmma.cu``, every site
  whose C/groups is a multiple of 16: an implicit GEMM on wgmma over
  channels-last codes and weights, with a tile and a split of K per site)
  and ``gather`` (``csrc/int8_conv.cu``, the rest: NCHW codes gathered byte
  by byte into mma.sync).

The device alone decides: CPU tensors take the plain versions
(:func:`quantize_reference`, :func:`conv_reference`: the sums as a float64
convolution of the codes, exact because every partial sum is an integer
below 2^53), CUDA tensors launch the kernel or raise. Each wrapper counts
its launches (``build.counter``): Q1, each Q2 variant, and the split-K
epilogue launch of the wgmma variant apart.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build as _build

__all__ = ["quantize", "quantize_reference", "conv", "conv_reference",
           "conv_out_shape", "ConvPlan", "plan_conv", "wgmma_site",
           "conv_launches", "KERNEL_QUANT", "KERNEL_CONV_WGMMA",
           "KERNEL_CONV_GATHER", "KERNEL_CONV_SPLITK", "LAUNCHES_QUANT",
           "LAUNCHES_CONV_WGMMA", "LAUNCHES_CONV_GATHER",
           "LAUNCHES_CONV_SPLITK"]

KERNEL_QUANT = "int8_quantize"
KERNEL_CONV_WGMMA = "int8_conv_wgmma"
KERNEL_CONV_GATHER = "int8_conv_gather"
#: the wgmma variant's second launch where it splits K (sum and epilogue)
KERNEL_CONV_SPLITK = "int8_conv_splitk"
#: launches of the CUDA kernels (plain-version calls are not counted)
LAUNCHES_QUANT = _build.counter(KERNEL_QUANT)
LAUNCHES_CONV_WGMMA = _build.counter(KERNEL_CONV_WGMMA)
LAUNCHES_CONV_GATHER = _build.counter(KERNEL_CONV_GATHER)
LAUNCHES_CONV_SPLITK = _build.counter(KERNEL_CONV_SPLITK)

_INT8_MAX = 127.0


def _bind(lib, fn, argtypes):
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
    return fn


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"int8 {what} kernel launch failed: "
                           + lib.mxtpu_cuda_error_string(err).decode())


def _on_card(*tensors):
    """True for CUDA tensors (the kernels), False for CPU ones (the plain
    versions); a mix raises."""
    cuda = [t.is_cuda for t in tensors if t is not None]
    if all(cuda):
        return True
    if any(cuda):
        raise ValueError("int8 kernels: tensors on the card and off it")
    return False


# -- Q1 -------------------------------------------------------------------

def _check_lohi(x, lohi):
    if lohi.numel() != 2 or lohi.dtype != torch.float32:
        raise ValueError("int8 quantize: lohi must be 2 float32 values "
                         f"(lo, hi), got {lohi.dtype} {tuple(lohi.shape)}")
    if lohi.device != x.device:
        raise ValueError(f"int8 quantize: lohi on {lohi.device}, x on "
                         f"{x.device}")


def quantize_reference(x, lohi, clip=False):
    """Q1's plain version: ``(codes, info)`` as :func:`quantize`."""
    x = x.to(torch.float32)
    lo, hi = lohi.reshape(2)
    if clip:
        x = torch.minimum(torch.maximum(x, lo), hi)
    # a tensor over a tensor: torch's ``float / tensor`` multiplies by the
    # reciprocal, which is not the f32 quotient
    c127 = torch.tensor(_INT8_MAX, dtype=torch.float32, device=x.device)
    scale = c127 / torch.clamp_min(torch.maximum(lo.abs(), hi.abs()), 1e-20)
    codes = torch.round(x * scale).clamp_(-127, 127).to(torch.int8)
    amax = c127 / scale
    return codes, torch.stack([-amax, amax, scale])


def quantize(x, lohi, clip=False, channels_last=False):
    """Q1: int8 codes of x (its shape) and ``info``, 3 f32 on x's device:
    ``(-amax, amax, scale)``. ``lohi``: (lo, hi) as 2 f32 on x's device;
    ``clip`` clips x to [lo, hi] first. x is read as f32. With
    ``channels_last`` (a 4-D x only) the codes are stored NHWC."""
    _check_lohi(x, lohi)
    if channels_last and x.dim() != 4:
        raise ValueError(f"int8 quantize: channels_last takes a 4-D x, got "
                         f"{tuple(x.shape)}")
    if not _on_card(x, lohi):
        codes, info = quantize_reference(x, lohi, clip)
        if channels_last:
            codes = codes.contiguous(memory_format=torch.channels_last)
        return codes, info
    x = x.to(torch.float32)
    lohi = lohi.reshape(2).contiguous()
    info = torch.empty(3, dtype=torch.float32, device=x.device)
    lib = _build.load("int8_quant")
    # an NCHW x to NHWC codes: the transposing kernel; any other request is
    # the flat pass over x's own memory order
    transpose = channels_last and not x.is_contiguous(
        memory_format=torch.channels_last)
    if transpose:
        x = x.contiguous()
        codes = torch.empty(x.shape, dtype=torch.int8, device=x.device,
                            memory_format=torch.channels_last)
        fn = _bind(lib, lib.mxtpu_int8_quantize_nhwc,
                   [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
        args = (x.shape[0], x.shape[1], x.shape[2] * x.shape[3])
    else:
        fmt = torch.channels_last if channels_last else \
            torch.contiguous_format
        x = x.contiguous(memory_format=fmt)
        codes = torch.empty(x.shape, dtype=torch.int8, device=x.device,
                            memory_format=fmt)
        fn = _bind(lib, lib.mxtpu_int8_quantize,
                   [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p])
        args = (x.numel(),)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), codes.data_ptr(), lohi.data_ptr(),
                 info.data_ptr(), *args, int(bool(clip)), stream)
    _raise_on(lib, err, "quantize")
    LAUNCHES_QUANT.add()
    return codes, info


# -- Q2 -------------------------------------------------------------------

def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a)
                                                               for a in v)


def conv_out_shape(x_shape, w_shape, stride, pad, dilate):
    """(N, O, OH, OW) of the convolution."""
    n, _, h, w = x_shape
    o, _, kh, kw = w_shape
    (sh, sw), (ph, pw), (dh, dw) = stride, pad, dilate
    return (n, o, (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1,
            (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1)


def _epilogue(acc, xscale, wscale, bias, relu):
    """f32(acc) / (xscale * wscale[o]) + bias[o], ReLU: the reference's f32
    rescale (QuantizedConv2D.forward :316)."""
    shape = (1, -1) + (1,) * (acc.dim() - 2)
    y = acc.to(torch.float32) / (xscale.reshape(()) * wscale.reshape(shape))
    if bias is not None:
        y = y + bias.reshape(shape)
    return torch.relu(y) if relu else y


def conv_reference(xq, wq, stride=1, pad=0, dilate=1, groups=1, xscale=None,
                   wscale=None, bias=None, relu=False):
    """Q2's plain version, :func:`conv`'s contract: the sums as a float64
    convolution of the codes (exact), then the f32 epilogue."""
    acc = F.conv2d(xq.to(torch.float64), wq.to(torch.float64), None,
                   _pair(stride), _pair(pad), _pair(dilate),
                   int(groups)).to(torch.int32).contiguous()
    if xscale is None:
        return acc
    return _epilogue(acc, xscale, wscale, bias, relu)


class ConvPlan(NamedTuple):
    """How Q2 runs one site: the variant (``"wgmma"`` or ``"gather"``), the
    tile's output pixels (``bm``; its output channels are 64), and how many
    ranges K is cut into (``split``; 1 for the gather variant)."""
    variant: str
    bm: int
    split: int


#: streaming multiprocessors of the H100 SXM, the card the plan fills
SMS = 132
_BK = 128          # codes of K a stage of the wgmma variant
_BN = 64           # output channels of the wgmma variant's tile
_MAX_SPLIT = 16


def wgmma_site(w_shape):
    """True where the wgmma variant takes a convolution of weight
    ``w_shape`` (O, C/groups, KH, KW): C/groups a multiple of 16, so that
    every 16-byte run of an operand row is 16 channels of one tap."""
    return w_shape[1] % 16 == 0


def plan_conv(x_shape, w_shape, stride=1, pad=0, dilate=1, groups=1):
    """Q2's plan for one site, from the shapes alone: the gather variant
    where C/groups is not a multiple of 16, else the wgmma variant.

    Its rule follows ``chip_smoke.py --int8-plans``, which timed every
    tile and split at ResNet-50 v1's sites at batch 1, 8 and 32 on the
    H100. A tile is 64 output channels (a wide one of 128, timed the same
    way, was faster at 4 sites by at most 12 % and within 2 % summed over
    the sites at each batch); BM 128 output pixels only where the tiles are many (at least 400 of
    them, or 132 with 1024 channels or more a group) and K takes more than
    two steps of 128 codes (at one or two the kernel's ring of 2 stages
    fits four CTAs of BM 64 an SM); K split only where the tiles are few
    (under 64) and K long (12 steps or more), into ranges of 3 steps or
    more, up to two CTAs an SM: elsewhere the splits' int32 sums cost more
    traffic than the split saves."""
    if not wgmma_site(w_shape):
        return ConvPlan("gather", 64, 1)
    n, _, oh, ow = conv_out_shape(x_shape, w_shape, _pair(stride),
                                  _pair(pad), _pair(dilate))
    o, cg, kh, kw = w_shape
    m, og = n * oh * ow, o // groups
    steps = -(-cg * kh * kw // _BK)

    def ctas(bm):
        return -(-m // bm) * -(-og // _BN) * groups

    many = ctas(128) >= 400 or (og >= 1024 and ctas(128) >= SMS)
    bm = 128 if many and steps > 2 else 64
    split = 1
    if ctas(bm) < 64 and steps >= 12:
        want = max(1, min(steps // 3, 2 * SMS // ctas(bm), _MAX_SPLIT))
        per = -(-steps // want)
        split = -(-steps // per)
    return ConvPlan("wgmma", bm, split)


def conv_launches():
    """Q2's launches so far, both variants (the split-K epilogue launches
    are the wgmma variant's second kernel and count apart)."""
    return LAUNCHES_CONV_WGMMA.value + LAUNCHES_CONV_GATHER.value


def conv(xq, wq, stride=1, pad=0, dilate=1, groups=1, xscale=None,
         wscale=None, bias=None, relu=False, plan=None):
    """Q2: the int8 convolution of xq (N, C, H, W) by wq (O, C/groups, KH,
    KW). Without ``xscale``: the int32 sums (N, O, OH, OW). With it (1 f32,
    the input's scale; ``wscale`` O f32; ``bias`` O f32 or None): the f32
    ``acc / (xscale * wscale[o]) + bias[o]``, ReLU'd where ``relu``. The
    output is NCHW contiguous. On the card :func:`plan_conv` picks the
    variant, tile and split unless ``plan`` names them; the wgmma variant
    takes its operands stored channels-last (an NCHW xq or OIHW wq is
    copied so first), the gather variant NCHW and OIHW."""
    stride, pad, dilate = _pair(stride), _pair(pad), _pair(dilate)
    groups = int(groups)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 conv takes int8 codes, got {xq.dtype} and "
                        f"{wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4:
        raise ValueError("int8 conv takes NCHW data and OIHW weights")
    n, c, h, w = xq.shape
    o, cg, kh, kw = wq.shape
    if groups < 1 or c != cg * groups or o % groups:
        raise ValueError(f"int8 conv: {c} input channels, weight "
                         f"{tuple(wq.shape)} and {groups} groups disagree")
    shape = conv_out_shape(xq.shape, wq.shape, stride, pad, dilate)
    if min(shape) < 1 or cg * kh * kw < 1:
        raise ValueError(f"int8 conv: empty output {shape}")
    f32 = xscale is not None
    if f32 and (wscale is None or wscale.numel() != o
                or (bias is not None and bias.numel() != o)):
        raise ValueError(f"int8 conv: the epilogue needs {o} weight scales "
                         "(and biases)")
    if not _on_card(xq, wq, xscale, wscale, bias):
        return conv_reference(xq, wq, stride, pad, dilate, groups, xscale,
                              wscale, bias, relu)
    if plan is None:
        plan = plan_conv(xq.shape, wq.shape, stride, pad, dilate, groups)
    elif plan.variant == "wgmma" and not wgmma_site(wq.shape):
        raise ValueError(f"int8 conv: the wgmma variant takes C/groups a "
                         f"multiple of 16, not {cg}")
    elif plan.variant not in ("wgmma", "gather"):
        raise ValueError(f"int8 conv: no variant {plan.variant!r}")
    vecs = [None if v is None else v.to(torch.float32).contiguous()
            for v in (xscale, wscale, bias)]
    out = torch.empty(shape, dtype=torch.float32 if f32 else torch.int32,
                      device=xq.device)
    geometry = (n, c, h, w, o, kh, kw, shape[2], shape[3], *stride, *pad,
                *dilate, groups)
    if plan.variant == "gather":
        xq, wq = xq.contiguous(), wq.contiguous()
        lib = _build.load("int8_conv")
        fn = _bind(lib, lib.mxtpu_int8_conv,
                   [ctypes.c_void_p] * 6 + [ctypes.c_int] * 18
                   + [ctypes.c_void_p])
        with torch.cuda.device(xq.device):
            stream = torch.cuda.current_stream(xq.device).cuda_stream
            err = fn(xq.data_ptr(), wq.data_ptr(), out.data_ptr(),
                     *(None if v is None else v.data_ptr() for v in vecs),
                     *geometry, int(f32), int(bool(relu)), stream)
        _raise_on(lib, err, "conv")
        LAUNCHES_CONV_GATHER.add()
        return out
    xq = xq.contiguous(memory_format=torch.channels_last)
    wq = wq.contiguous(memory_format=torch.channels_last)
    ws = (torch.empty((plan.split,) + tuple(shape), dtype=torch.int32,
                      device=xq.device) if plan.split > 1 else None)
    lib = _build.load("int8_conv_wgmma")
    fn = _bind(lib, lib.mxtpu_int8_conv_wgmma,
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 20
               + [ctypes.c_void_p])
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = fn(xq.data_ptr(), wq.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 *(None if v is None else v.data_ptr() for v in vecs),
                 *geometry, plan.bm, plan.split, int(f32),
                 int(bool(relu)), stream)
    _raise_on(lib, err, "conv")
    LAUNCHES_CONV_WGMMA.add()
    if plan.split > 1:
        LAUNCHES_CONV_SPLITK.add()
    return out
