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
  host read).
- Q2, :func:`conv` (``csrc/int8_conv.cu``): int8 x int8 -> int32 NCHW/OIHW
  convolution with stride, zero padding, dilation and groups (a Dense
  layer as a 1x1 convolution over a 1x1 plane), returning the int32 sums,
  or with ``xscale`` the f32 ``acc / (xscale * wscale[o]) + bias[o]`` and
  ReLU, as QuantizedConv2D and QuantizedDense compute them.

The device alone decides: CPU tensors take the plain versions
(:func:`quantize_reference`, :func:`conv_reference`: the sums as a float64
convolution of the codes, exact because every partial sum is an integer
below 2^53), CUDA tensors launch the kernel or raise. Each wrapper counts
its launches (``build.counter``).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build as _build

__all__ = ["quantize", "quantize_reference", "conv", "conv_reference",
           "conv_out_shape", "KERNEL_QUANT", "KERNEL_CONV", "LAUNCHES_QUANT",
           "LAUNCHES_CONV"]

KERNEL_QUANT = "int8_quantize"
KERNEL_CONV = "int8_conv"
#: launches of the CUDA kernels (plain-version calls are not counted)
LAUNCHES_QUANT = _build.counter(KERNEL_QUANT)
LAUNCHES_CONV = _build.counter(KERNEL_CONV)

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


def quantize(x, lohi, clip=False):
    """Q1: int8 codes of x (its shape) and ``info``, 3 f32 on x's device:
    ``(-amax, amax, scale)``. ``lohi``: (lo, hi) as 2 f32 on x's device;
    ``clip`` clips x to [lo, hi] first. x is read as f32."""
    _check_lohi(x, lohi)
    if not _on_card(x, lohi):
        return quantize_reference(x, lohi, clip)
    x = x.to(torch.float32).contiguous()
    lohi = lohi.reshape(2).contiguous()
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    info = torch.empty(3, dtype=torch.float32, device=x.device)
    lib = _build.load("int8_quant")
    fn = _bind(lib, lib.mxtpu_int8_quantize,
               [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), codes.data_ptr(), lohi.data_ptr(),
                 info.data_ptr(), x.numel(), int(bool(clip)), stream)
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
                   int(groups)).to(torch.int32)
    if xscale is None:
        return acc
    return _epilogue(acc, xscale, wscale, bias, relu)


def conv(xq, wq, stride=1, pad=0, dilate=1, groups=1, xscale=None,
         wscale=None, bias=None, relu=False):
    """Q2: the int8 convolution of xq (N, C, H, W) by wq (O, C/groups, KH,
    KW). Without ``xscale``: the int32 sums (N, O, OH, OW). With it (1 f32,
    the input's scale; ``wscale`` O f32; ``bias`` O f32 or None): the f32
    ``acc / (xscale * wscale[o]) + bias[o]``, ReLU'd where ``relu``."""
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
    xq, wq = xq.contiguous(), wq.contiguous()
    vecs = [None if v is None else v.to(torch.float32).contiguous()
            for v in (xscale, wscale, bias)]
    out = torch.empty(shape, dtype=torch.float32 if f32 else torch.int32,
                      device=xq.device)
    lib = _build.load("int8_conv")
    fn = _bind(lib, lib.mxtpu_int8_conv,
               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 18
               + [ctypes.c_void_p])
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = fn(xq.data_ptr(), wq.data_ptr(), out.data_ptr(),
                 *(None if v is None else v.data_ptr() for v in vecs),
                 n, c, h, w, o, kh, kw, shape[2], shape[3], *stride, *pad,
                 *dilate, groups, int(f32), int(bool(relu)), stream)
    _raise_on(lib, err, "conv")
    LAUNCHES_CONV.add()
    return out
