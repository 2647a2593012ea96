"""One hop of the flash ring (K6), forward and backward: the Hopper kernels
and their plain PyTorch versions.

Counterpart of the hop inside mxnet_tpu/parallel/ring_attention.py: its
``_ring_flash_fwd_impl`` (:119) runs ``ops/pallas_attention.py:_flash_fwd``
(:179) on each hop and merges the partials by their logsumexp in XLA; its
``_ring_flash_vjp_bwd`` (:210) runs ``_flash_bwd`` (:361) on each hop and
adds the gradients. Here each hop is one kernel that does the whole step:

* ``csrc/ring_flash_fwd.cu`` attends the position's local Q shard to the
  visiting K/V block and merges the result into the position's running
  float32 state (out, lse) in its epilogue; on the position's last live
  hop it writes the output in q's dtype and the final lse instead. The
  hop's partial is never rounded to bfloat16.
* ``csrc/ring_flash_bwd.cu`` recomputes P from the global lse, adds dK and
  dV into the travelling float32 sums of the visiting block and dQ into the
  position's float32 sum (TMA reduce-adds in the L2: the order of dQ's
  sums, and so its last bits, vary from run to run; dK and dV do not).

Both run on ``wgmma`` with their tiles brought by TMA; ``ring_delta``, the
backward's rowsum(dO * O), is computed once per position per backward in
plain PyTorch (a reduction over D), not once per hop.

:func:`ring_hop_fwd` and :func:`ring_hop_bwd` take CUDA bfloat16 tensors
with a head dim of 64 or 128 (:func:`kernel_takes`) and launch the kernels,
or raise; CPU tensors take :func:`ring_hop_fwd_reference` and
:func:`ring_hop_bwd_reference`, which keep the same in-place contract. The
ring (parallel/ring_attention.py) decides its route once per call.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import build as _build
from .flash_attention import (_empty_bshd, attention_bwd_reference_f32,
                              attention_reference_f32)

__all__ = ["ring_hop_fwd", "ring_hop_bwd", "ring_hop_fwd_reference",
           "ring_hop_bwd_reference", "ring_delta", "merge", "kernel_takes",
           "HEAD_DIMS", "LAUNCHES_FWD", "LAUNCHES_BWD"]

KERNEL_FWD = "ring_flash_fwd"
KERNEL_BWD = "ring_flash_bwd"
#: launches of each hop kernel (plain-version calls are not counted)
LAUNCHES_FWD = _build.counter(KERNEL_FWD)
LAUNCHES_BWD = _build.counter(KERNEL_BWD)
#: the head dims the kernels are built for
HEAD_DIMS = (64, 128)


def kernel_takes(dtype, device_type, head_dim):
    """True when a ring over tensors of this dtype, device type and head dim
    runs the hop kernels: CUDA bfloat16 at a head dim of :data:`HEAD_DIMS`."""
    return (device_type == "cuda" and dtype == torch.bfloat16
            and head_dim in HEAD_DIMS)


def merge(out_a, lse_a, out_b, lse_b):
    """Exact merge of two normalized partials by their logsumexp."""
    lse_new = torch.logaddexp(lse_a, lse_b)
    safe = torch.where(torch.isneginf(lse_new), 0.0, lse_new)
    w_a = torch.where(torch.isneginf(lse_a), 0.0,
                      torch.exp(lse_a - safe))[..., None]
    w_b = torch.where(torch.isneginf(lse_b), 0.0,
                      torch.exp(lse_b - safe))[..., None]
    return w_a * out_a + w_b * out_b, lse_new


def ring_delta(out, dout):
    """rowsum(dO * O) in float32, (B, H, S): the backward's delta of one
    position, from the ring's global out and its gradient."""
    return (dout.float() * out.float()).sum(dim=-1)


def ring_hop_fwd_reference(q, k, v, acc, lse, causal, scale, last, out=None,
                           first=False):
    """Plain version of one forward hop. ``acc`` (float32, q's shape) and
    ``lse`` (float32, (B, H, S)) hold the position's running normalized
    output and logsumexp; ``first`` says they are empty (not read). The
    hop's attention of q to k, v (its partial in float32) merges into them
    exactly; on the ``last`` hop the merged output goes to ``out`` (q's
    dtype, q's shape) and ``acc`` is not written. ``lse`` always takes the
    merged logsumexp. Returns ``(out if last else acc, lse)``."""
    blk_out, blk_lse = attention_reference_f32(q, k, v, causal, scale)
    if not first:
        blk_out, blk_lse = merge(acc, lse, blk_out, blk_lse)
    lse.copy_(blk_lse)
    dst = out if last else acc
    dst.copy_(blk_out)
    return dst, lse


def ring_hop_bwd_reference(q, k, v, dout, lse, delta, dq, dk, dv, causal,
                           scale):
    """Plain version of one backward hop: the attention backward of q to
    k, v with the position's global ``lse`` and ``delta``
    (:func:`ring_delta`), added in place into the float32 sums ``dq`` (the
    position's) and ``dk``, ``dv`` (the visiting block's)."""
    gq, gk, gv = attention_bwd_reference_f32(q, k, v, lse, delta, dout,
                                             causal, scale)
    dq.add_(gq)
    dk.add_(gk)
    dv.add_(gv)


#: each C entry point's arguments after its pointers and (b, h, s, d, the
#: strides): scale, causal[, first, last], the stream
_ARGTYPES = {
    KERNEL_FWD: (6, [ctypes.c_float] + [ctypes.c_int] * 3),
    KERNEL_BWD: (9, [ctypes.c_float, ctypes.c_int]),
}


def _lib(name):
    lib = _build.load(name)
    fn = getattr(lib, f"mxtpu_{name}")
    if fn.argtypes is None:
        n_ptr, tail = _ARGTYPES[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong)] + tail
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mxtpu_ring_hop_error_string.argtypes = [ctypes.c_int]
        lib.mxtpu_ring_hop_error_string.restype = ctypes.c_char_p
    return lib


def _check_tiles(**tensors):
    """The bf16 operands that TMA reads: one (B, H, S, D) shape, CUDA
    bfloat16 on one device, D in HEAD_DIMS, unit stride in D, base and
    (batch, head, seq) strides on 16 bytes; B * H within a grid row."""
    (name0, t0), *_ = tensors.items()
    b, h, _, d = t0.shape
    if not kernel_takes(t0.dtype, t0.device.type, d):
        raise ValueError(
            f"the ring hop kernels take CUDA bfloat16 tensors with head dim "
            f"in {HEAD_DIMS}; got {name0} {t0.dtype} on {t0.device}, head "
            f"dim {d} (CPU tensors take the plain versions)")
    if b * h > 65535:
        raise ValueError(f"the ring hop kernels take B*H <= 65535, got "
                         f"{b * h}")
    for name, t in tensors.items():
        if t.dim() != 4 or t.shape != t0.shape:
            raise ValueError(f"{name} must have {name0}'s shape "
                             f"{tuple(t0.shape)}, got {tuple(t.shape)}")
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"{name} must be {t0.dtype} on {t0.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its head dim")
        if t.data_ptr() % 16 or any(st * 2 % 16 for st in t.stride()[:3]):
            raise ValueError(
                f"TMA needs {name}'s base and (batch, head, seq) strides on "
                f"16 bytes: base {t.data_ptr() % 16} bytes off, strides "
                f"{t.stride()[:3]} elements")


def _check_f32(t, shape, device, name):
    if (t is None or t.dtype != torch.float32 or t.device != device
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous float32 {tuple(shape)} tensor on "
            f"{device}, got "
            + ("None" if t is None else
               f"{t.dtype} {tuple(t.shape)} on {t.device}"))


def _raise_if(err, lib, what):
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.mxtpu_ring_hop_error_string(err).decode())


def ring_hop_fwd(q, k, v, acc, lse, causal, scale, last, out=None,
                 first=False):
    """One forward hop (:func:`ring_hop_fwd_reference`'s contract): the
    kernel for CUDA tensors, the plain version for CPU tensors. With
    ``last`` and no ``out``, the output goes into new (B, S, H, D) memory
    seen as (B, H, S, D)."""
    if last and out is None:
        out = _empty_bshd(*q.shape, q)
    if q.device.type == "cpu":
        return ring_hop_fwd_reference(q, k, v, acc, lse, causal, scale, last,
                                      out, first)
    _check_tiles(q=q, k=k, v=v)
    b, h, s, d = q.shape
    _check_f32(lse, (b, h, s), q.device, "lse")
    if not (first and last):
        _check_f32(acc, q.shape, q.device, "acc")
    if last and (out.shape != q.shape or out.dtype != q.dtype
                 or out.device != q.device or out.stride(3) != 1
                 or out.data_ptr() % 4
                 or any(st % 2 for st in out.stride()[:3])):
        raise ValueError("out must have q's shape and dtype, unit stride in "
                         "D and 4-byte aligned rows")
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *(out.stride()[:3] if last else (0, 0, 0)))
    lib = _lib(KERNEL_FWD)
    with torch.cuda.device(q.device):
        err = lib.mxtpu_ring_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if acc is None else acc.data_ptr(), lse.data_ptr(),
            out.data_ptr() if last else 0, b, h, s, d, strides, float(scale),
            int(bool(causal)), int(bool(first)), int(bool(last)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, lib, "ring_flash_fwd")
    LAUNCHES_FWD.add()
    return (out if last else acc), lse


def ring_hop_bwd(q, k, v, dout, lse, delta, dq, dk, dv, causal, scale):
    """One backward hop (:func:`ring_hop_bwd_reference`'s contract): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return ring_hop_bwd_reference(q, k, v, dout, lse, delta, dq, dk, dv,
                                      causal, scale)
    _check_tiles(q=q, k=k, v=v, dout=dout)
    b, h, s, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        _check_f32(t, (b, h, s), q.device, name)
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        _check_f32(t, q.shape, q.device, name)
    if dq.data_ptr() % 16:
        raise ValueError("TMA adds into dq: its base must be on 16 bytes")
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3])
    lib = _lib(KERNEL_BWD)
    with torch.cuda.device(q.device):
        err = lib.mxtpu_ring_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, s, d, strides, float(scale),
            int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, lib, "ring_flash_bwd")
    LAUNCHES_BWD.add()

