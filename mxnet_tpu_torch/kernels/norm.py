"""BatchNorm training: the K1/K2 CUDA kernels' wrappers and the
``torch.autograd.Function`` around them (counterpart of
mxnet_tpu/kernels/norm.py).

The TPU kernels ``_fwd_kernel`` (launched by ``_fwd_pallas``) and
``_bwd_kernel`` (``_bwd_pallas``) become the hand-written CUDA kernels of
``csrc/bn_train.cu``, in one of four regimes that :func:`launch_geometry`
chooses from the shape (the C launchers refuse one that cannot run):
channels last, per-CTA f32 partial sums over a fixed row chunk, a combine
pass that adds them in a fixed order and a normalize (forward) or dx
(backward) pass that visits the chunks in reverse, where the L2 is warm
(``last``; ``vector`` with 16-byte loads where every row starts on 16
bytes); channels not last, the planes walked as 16-byte slots, either
partials and one apply pass that adds its channel's partials itself
(``planes``) or, where a channel's x (and dy) fits the shared memory of one
CTA or of a cluster of up to 8, one launch that reads them once
(``resident``). No atomics: the bits repeat from run to run. Their plain
versions are ops/nn.py:``_bn_train_impl`` and ``_bn_train_bwd``, here with
the wrappers' signatures as ``bn_train_fwd_reference`` and
``bn_train_bwd_reference``.

:func:`bn_train` has the JAX package's contract: ``(out, mean, var)`` from
``(x, gamma, beta, shift, eps, axis)``, residuals (x, gamma, beta, shift,
mean, inv), and a backward that takes the cotangents of out, mean and var
and gives (dx, dgamma, dbeta, 0 for the shift). The device alone decides:
CPU tensors take the plain versions (outcome ``platform``), CUDA tensors
launch the kernels (outcome ``kernel``) or raise, for a dtype the kernels do
not take (float16, float64) or an empty tensor. The TPU kernels' gates (C a
multiple of 128, C <= 8192, M a multiple of 8, channels last) were lane
rules: here any C >= 1 and M >= 1 run, with the channel axis anywhere; the
tensor is read as (outer, C, inner), so NHWC (inner = 1) and NCHW (inner =
H*W) are both one kernel. Decisions are counted in kernels/dispatch.py
under ``bn_fwd`` and ``bn_bwd``.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from ..ops import nn as _nn
from . import build as _build
from . import dispatch as _dispatch

__all__ = ["bn_train", "bn_train_fwd", "bn_train_bwd",
           "bn_train_fwd_reference", "bn_train_bwd_reference",
           "launch_geometry", "Geometry", "REGIMES", "plane_slots",
           "cuda_launches", "sm_count", "smem_per_block",
           "KERNEL_FWD", "KERNEL_BWD", "LAUNCHES_FWD", "LAUNCHES_BWD"]

SOURCE = "bn_train"
KERNEL_FWD = "bn_train_fwd"
KERNEL_BWD = "bn_train_bwd"
#: launches of the CUDA kernels (plain-version calls are not counted)
LAUNCHES_FWD = _build.counter(KERNEL_FWD)
LAUNCHES_BWD = _build.counter(KERNEL_BWD)

_DTYPES = (torch.float32, torch.bfloat16)
# the kernels' geometry (csrc/bn_train.cu): 256 threads a CTA, about 8 CTAs
# an SM. Vector path: 16-byte lanes, slabs of at most 32 lanes a CTA, K1's
# 8 loads in flight a thread; a chunk of at least 128 rows, so that its
# partials are at most 1/32 of its bytes. Scalar path: 32 channels a CTA.
# Channels not last: 16-byte slots of the planes, a planes chunk of at
# least 8 slots a thread; a resident channel in the shared memory of a
# cluster of 1, 2, 4 or 8 CTAs (H100: 227 KB a block, 228 an SM, 1 KB of
# it the system's for each block; 1 KB for the kernels' own).
_THREADS = 256
_CTAS_PER_SM = 8
_SLAB_LANES = 32
_VEC_UNROLL = 8
_MIN_ROWS_VEC = 128
_TILE_C = 32
_MIN_ROWS_LAST = 64
_MIN_ITEMS = _THREADS * _VEC_UNROLL
_MAX_CHUNKS = 65535
_CLUSTERS = (1, 2, 4, 8)
_SMEM_BLOCK = 232448
_SMEM_RESERVED = 1024
_SMEM_STATIC = 1024

#: the regimes, in the order of csrc/bn_train.cu's codes
REGIMES = ("last", "vector", "planes", "resident")

Geometry = collections.namedtuple("Geometry", "outer c inner chunks regime")


def plane_slots(inner, itemsize):
    """The 16-byte slots a plane of ``inner`` elements spans at most: its
    bytes / 16 when they are a multiple of 16 (every plane then starts on
    16 bytes), else room for the largest head offset a plane can have,
    16 - gcd(bytes, 16)."""
    pb = inner * itemsize
    if pb % 16 == 0:
        return pb // 16
    return -(-(pb + 16 - (pb & -pb)) // 16)


def _resident_cluster(items, c, nin, sms, smem_block):
    """The CTAs (1, 2, 4 or 8: one cluster) that hold a channel of
    ``items`` 16-byte slots of each of ``nin`` inputs in shared memory, or 0
    where 8 cannot: the smallest that gives the grid the card's SM count
    and two CTAs an SM, else the smallest that gives it the SM count, else
    the largest. A split leaves a CTA at least one slot a thread."""
    fits = []
    for cs in _CLUSTERS:
        per = -(-items // cs)
        data = per * 16 * nin
        if (cs == 1 or per >= _THREADS) and data + _SMEM_STATIC <= smem_block:
            fits.append((cs, data))
    if not fits:
        return 0
    per_sm = smem_block + _SMEM_RESERVED
    for two in (True, False):
        for cs, data in fits:
            if c * cs >= sms and (not two or 2 * (
                    data + _SMEM_STATIC + _SMEM_RESERVED) <= per_sm):
                return cs
    return fits[-1][0]


def launch_geometry(shape, axis, itemsize, sm_count, aligned=True,
                    backward=False, smem_block=_SMEM_BLOCK):
    """:class:`Geometry` of a K1 (or, ``backward``, K2) launch: the tensor
    read as (outer, C, inner) around the channel axis, the regime
    (``REGIMES``), and ``chunks``: the CTAs a channel's sums are split
    into (``resident``: the cluster's). Channels last (inner = 1): row
    chunks, one CTA per chunk and channel tile, the 16-byte ``vector``
    regime where ``C * itemsize`` is a multiple of 16 and, ``aligned``,
    every tensor's base is on 16 bytes, else ``last``. Channels not last:
    ``resident`` where a channel's x (K1) or x and dy (K2) fits the shared
    memory of a cluster of at most 8 CTAs (``smem_block`` bytes a block),
    else ``planes``, chunks of a channel's 16-byte slots (the wrappers copy
    a tensor whose base is not on 16 bytes first, so ``aligned`` does not
    matter there). A function of its arguments alone, so one shape sums in
    one order on one card."""
    outer = math.prod(shape[:axis])
    c = shape[axis]
    inner = math.prod(shape[axis + 1:])
    target = sm_count * _CTAS_PER_SM
    if inner > 1:
        items = outer * plane_slots(inner, itemsize)
        cs = _resident_cluster(items, c, 2 if backward else 1, sm_count,
                               smem_block)
        if cs:
            return Geometry(outer, c, inner, cs, "resident")
        least = -(-items // (1 << 30))  # int items in a chunk
        chunks = max(least, min(-(-target // c), -(-items // _MIN_ITEMS)), 1)
        return Geometry(outer, c, inner, min(chunks, _MAX_CHUNKS), "planes")
    rows = outer
    vector = (c * itemsize) % 16 == 0 and bool(aligned)
    least = 1
    if vector:
        lanes = c * itemsize // 16
        slab = min(lanes, _SLAB_LANES)
        tiles = -(-lanes // slab)
        min_rows = max(_MIN_ROWS_VEC, _THREADS // slab * _VEC_UNROLL)
        least = -(-(rows * lanes) // (1 << 30))  # int offsets in a chunk
    else:
        tiles, min_rows = -(-c // _TILE_C), _MIN_ROWS_LAST
    chunks = max(least, min(-(-target // tiles), -(-rows // min_rows)), 1)
    return Geometry(outer, c, inner, min(chunks, _MAX_CHUNKS),
                    "vector" if vector else "last")


def cuda_launches(geometry):
    """CUDA launches of one call in this geometry: partials, combine and
    apply (channels last); partials and apply (planes); one (resident)."""
    return {"last": 3, "vector": 3, "planes": 2, "resident": 1}[
        geometry.regime]


_SM_COUNT = {}
_SMEM = {}


def _device_index(device):
    idx = torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


def sm_count(device):
    """The card's number of SMs (cached per device)."""
    idx = _device_index(device)
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def smem_per_block(device):
    """The shared memory one block may take on the card, opted in (cached
    per device): the property where torch has it, else the SM's less the
    system's share of a block."""
    idx = _device_index(device)
    if idx not in _SMEM:
        props = torch.cuda.get_device_properties(idx)
        optin = getattr(props, "shared_memory_per_block_optin", None)
        _SMEM[idx] = int(optin if optin else
                         props.shared_memory_per_multiprocessor
                         - _SMEM_RESERVED)
    return _SMEM[idx]


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _on16(t):
    """``t``, or a copy of it whose base is on 16 bytes (the NCHW regimes
    need it; the model's activations are already)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _geometry(x, axis, aligned, backward):
    return launch_geometry(x.shape, axis, x.element_size(),
                           sm_count(x.device), aligned, backward,
                           smem_per_block(x.device))


def _lib():
    return _bind(_build.load(SOURCE))


def _bind(lib):
    """``lib`` (bn_train's library, or a copy with its C interface) with
    its functions' argument and result types set."""
    if lib.mxtpu_bn_train_fwd.argtypes is None:
        lib.mxtpu_bn_train_fwd.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong]
            + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.mxtpu_bn_train_bwd.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong]
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        for fn in (lib.mxtpu_bn_train_fwd, lib.mxtpu_bn_train_bwd):
            fn.restype = ctypes.c_int
        lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, axis, what, *vectors):
    if x.dtype not in _DTYPES:
        raise TypeError(f"the BatchNorm {what} kernel takes float32 or "
                        f"bfloat16 tensors, not {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"the BatchNorm {what} kernel takes no empty tensor")
    for v in vectors:
        if v is not None and (v.device != x.device
                              or v.numel() != x.shape[axis]):
            raise ValueError(
                f"the BatchNorm {what} kernel needs per-channel vectors of "
                f"{x.shape[axis]} elements on {x.device}")


def _f32(v):
    return v.detach().float().contiguous()


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"BatchNorm {what} kernel launch failed: "
                           + lib.mxtpu_cuda_error_string(err).decode())


def bn_train_fwd(x, gamma, beta, shift, eps, axis):
    """K1 on CUDA tensors: ``(out, mean, var, inv)``, the contract of
    ``_bn_train_impl``. x is read as (outer, C, inner) in its contiguous
    layout (a non-contiguous x is copied first; the model's activations are
    contiguous)."""
    _check(x, axis, "forward", gamma, beta, shift)
    x = x.contiguous()
    ew_low = _nn._bn_ew_dtype(x) != torch.float32
    out = torch.empty_like(x)
    geom = _geometry(x, axis, _aligned(x, out), False)
    outer, c, inner, chunks, regime = geom
    if regime in ("planes", "resident"):
        x = _on16(x)
    # separate tensors, not views of one: mean and var are outputs of the
    # autograd Function
    mean, var, inv = (torch.empty(c, dtype=torch.float32, device=x.device)
                      for _ in range(3))
    work = torch.empty((2 * chunks + 4) * c, dtype=torch.float32,
                       device=x.device)
    g, b, s = _f32(gamma), _f32(beta), _f32(shift)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mxtpu_bn_train_fwd(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), s.data_ptr(),
            out.data_ptr(), mean.data_ptr(), var.data_ptr(), inv.data_ptr(),
            work.data_ptr(), outer, c, inner, chunks, REGIMES.index(regime),
            int(x.dtype == torch.bfloat16), int(ew_low),
            float(x.numel() // c), float(eps), stream)
    _raise_on(lib, err, "forward")
    LAUNCHES_FWD.add()
    return out, mean, var, inv


def bn_train_bwd(x, gamma, shift, mean, inv, dy, dmean, dvar, axis):
    """K2 on CUDA tensors: ``(dx, dgamma, dbeta)`` with dgamma and dbeta in
    f32, the contract of ``_bn_train_bwd``. ``dmean`` and ``dvar`` are the
    cotangents of the batch statistics; None stands for zeros."""
    _check(x, axis, "backward", gamma, shift, mean, inv, dmean, dvar)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    x, dy = x.contiguous(), dy.contiguous()
    ew = _nn._bn_ew_dtype(x)
    dx = torch.empty_like(x)
    geom = _geometry(x, axis, _aligned(x, dy, dx), True)
    outer, c, inner, chunks, regime = geom
    if regime in ("planes", "resident"):
        x, dy = _on16(x), _on16(dy)
    dgamma, dbeta = (torch.empty(c, dtype=torch.float32, device=x.device)
                     for _ in range(2))
    work = torch.empty((2 * chunks + 4) * c, dtype=torch.float32,
                       device=x.device)
    vecs = [_f32(v) for v in (gamma, mean, inv, shift)]
    dm, dv = (None if v is None else _f32(v) for v in (dmean, dvar))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mxtpu_bn_train_bwd(
            x.data_ptr(), dy.data_ptr(), *(v.data_ptr() for v in vecs),
            dm.data_ptr() if dm is not None else None,
            dv.data_ptr() if dv is not None else None,
            dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            work.data_ptr(), outer, c, inner, chunks, REGIMES.index(regime),
            int(x.dtype == torch.bfloat16), int(ew != torch.float32),
            _nn._n_in(x.numel() // c, ew), stream)
    _raise_on(lib, err, "backward")
    LAUNCHES_BWD.add()
    return dx, dgamma, dbeta


def bn_train_fwd_reference(x, gamma, beta, shift, eps, axis):
    """K1's plain version, with the wrapper's signature:
    ops/nn.py:_bn_train_impl."""
    return _nn._bn_train_impl(x, gamma, beta, shift, eps, axis)


def bn_train_bwd_reference(x, gamma, shift, mean, inv, dy, dmean, dvar,
                           axis):
    """K2's plain version, with the wrapper's signature:
    ops/nn.py:_bn_train_bwd, dgamma and dbeta in f32 (None cotangents are
    zeros)."""
    zeros = torch.zeros_like(mean)
    dx, dgamma, dbeta, _ = _nn._bn_train_bwd(
        0.0, axis, (x, gamma.float(), gamma.float(), shift, mean, inv),
        (dy, zeros if dmean is None else dmean,
         zeros if dvar is None else dvar))
    return dx, dgamma, dbeta


def _on_card(x, *others):
    """True for CUDA tensors (the kernels), False for CPU ones (the plain
    versions); a mix raises."""
    if not _dispatch.platform_ok(x):
        return False
    if not _dispatch.platform_ok(*others):
        raise ValueError("bn_train: x is on the card but a per-channel "
                         "vector is not")
    return True


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, shift, eps, axis):
        # the shift is the moving mean, which the BatchNorm layer updates in
        # place right after this forward: the backward needs its value of
        # now, so a copy of its C floats is what is saved
        ctx.shift_dtype = shift.dtype
        shift = shift.detach().to(torch.float32, copy=True)
        if _on_card(x, gamma, beta, shift):
            _dispatch.record("bn_fwd", "kernel")
            out, mean, var, inv = bn_train_fwd(x, gamma, beta, shift, eps,
                                               axis)
        else:
            _dispatch.record("bn_fwd", "platform")
            out, mean, var, inv = bn_train_fwd_reference(x, gamma, beta,
                                                         shift, eps, axis)
        ctx.save_for_backward(x, gamma, beta, shift, mean, inv)
        ctx.axis = axis
        return out, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dmean, dvar):
        x, gamma, beta, shift, mean, inv = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        on_card = _on_card(x)
        _dispatch.record("bn_bwd", "kernel" if on_card else "platform")
        dx, dgamma, dbeta = (bn_train_bwd if on_card else
                             bn_train_bwd_reference)(
            x, gamma, shift, mean, inv, dy, dmean, dvar, ctx.axis)
        dgamma, dbeta = dgamma.to(gamma.dtype), dbeta.to(beta.dtype)
        dshift = (torch.zeros_like(shift, dtype=ctx.shift_dtype)
                  if ctx.needs_input_grad[3] else None)
        return dx, dgamma, dbeta, dshift, None, None


def bn_train(x, gamma, beta, shift, eps, axis):
    """Kernel-backed twin of the JAX package's ``_bn_train``:
    ``(out, mean, var)`` of a BatchNorm training step over every axis but
    ``axis``, differentiable in x, gamma and beta (and in the mean and var
    outputs, whose cotangents reach dx). The shift (the moving mean) gets a
    zero gradient."""
    return _BNTrain.apply(x, gamma, beta, shift, float(eps), int(axis))
