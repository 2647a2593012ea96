"""Flash attention, forward and backward: the CUDA kernels and their plain
PyTorch versions.

Counterpart of mxnet_tpu/ops/pallas_attention.py. The TPU kernel
``_fwd_kernel`` (launched by ``_flash_fwd``) becomes the hand-written CUDA
kernel ``csrc/flash_attention_fwd.cu``; ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (launched by ``_flash_bwd``) become the two kernels of
``csrc/flash_attention_bwd.cu``. :func:`flash_attention_reference` is the
plain twin of ``attention_reference`` and
:func:`flash_attention_bwd_reference` that of ``_flash_bwd``: each repeats
its kernels' arithmetic with one tile spanning the whole row.
:func:`flash_attention` joins forward and backward in a
``torch.autograd.Function``, as ``_flash`` does with ``jax.custom_vjp``.

Which one runs is decided by the tensors' device and dtype alone
(:func:`kernel_route`), in the backward as in the forward: CPU tensors take
the plain version; CUDA bfloat16 tensors launch the tensor-core kernels
(``mma``: mma.sync, ldmatrix, cp.async) or raise; CUDA float32 tensors
launch the FP32 kernels (``fp32``: FP32 FMAs, since TF32 would keep about
three digits, above the float32 tolerance). Both variants live in the same
sources behind the same C entry points, which choose them by the dtype
argument. There is no fallback from a kernel to its plain version or from
one variant to the other, and no option that selects one. The tensor-core
kernels stage their tiles with 16-byte or 2-byte copies by a rule of the C
launchers; :func:`tensor_route` asks the library which a call takes.

The dropout seed is an int or a one-element int32 tensor holding the seed's
32 bits. The kernels read it from device memory when they start, so a
launch captured in a CUDA graph takes the value the seed tensor holds at
each replay (``MultiHeadAttention`` draws it on the card with one captured
op, :func:`next_dropout_seed`); an int seed is copied to the card first.
The forward keeps a one-element copy of the seed tensor it used for the
backward. The plain versions read the same tensor.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..kernels import build as _build
from .registry import register_op

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_reference", "flash_attention_bwd_reference",
           "attention_reference_f32", "attention_bwd_reference_f32",
           "launch_bwd_dq", "launch_bwd_dkv", "kernel_route", "tensor_route",
           "next_dropout_seed",
           "VARIANTS", "LAUNCHES", "LAUNCHES_BWD_DQ", "LAUNCHES_BWD_DKV",
           "VARIANT_LAUNCHES"]

KERNEL = "flash_attention_fwd"
#: launches of the CUDA kernel, both variants (plain-version calls are not
#: counted)
LAUNCHES = _build.counter(KERNEL)
#: the backward's source, and one launch counter per kernel in it
KERNEL_BWD = "flash_attention_bwd"
KERNEL_BWD_DQ = "flash_attention_bwd_dq"
KERNEL_BWD_DKV = "flash_attention_bwd_dkv"
LAUNCHES_BWD_DQ = _build.counter(KERNEL_BWD_DQ)
LAUNCHES_BWD_DKV = _build.counter(KERNEL_BWD_DKV)
#: the kernel variant a CUDA tensor of each dtype launches
VARIANTS = {torch.bfloat16: "mma", torch.float32: "fp32"}
#: {kernel: {variant: counter}}: each launch also counts under its variant,
#: as "<kernel>_mma" or "<kernel>_fp32"
VARIANT_LAUNCHES = {
    k: {v: _build.counter(f"{k}_{v}") for v in VARIANTS.values()}
    for k in (KERNEL, KERNEL_BWD_DQ, KERNEL_BWD_DKV)}
_TOTALS = {KERNEL: LAUNCHES, KERNEL_BWD_DQ: LAUNCHES_BWD_DQ,
           KERNEL_BWD_DKV: LAUNCHES_BWD_DKV}
MAX_HEAD_DIM = 128

_H1 = 0x9E3779B1
_H2 = 0x85EBCA6B
_H3 = 0xC2B2AE35
_M32 = 0xFFFFFFFF


def _mul32(a, c):
    """``a * c mod 2**32`` for an int64 tensor ``a`` in [0, 2**32) and a
    constant ``c`` < 2**32. Torch has no full uint32 multiply, so ``c`` is
    split into 16-bit halves; no partial product exceeds 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _dropout_keep(seed, bh, q_pos, k_pos, dropout_p):
    """Bit-exact twin of pallas_attention.py:_dropout_keep: the
    murmur3-finalizer counter hash of (seed, batch*head, q position,
    k position), in int64 arithmetic masked to 32 bits after each step.
    Integer tensor (or int) arguments broadcast; returns a bool tensor."""
    def u32(x):
        return torch.as_tensor(x, dtype=torch.int64) & _M32

    h = (_mul32(u32(q_pos), _H1) + _mul32(u32(k_pos), _H2) + u32(seed)
         + _mul32(u32(bh), _H3)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, _H2)
    h = h ^ (h >> 13)
    h = _mul32(h, _H3)
    h = h ^ (h >> 16)
    return h <= _threshold(dropout_p)


def _threshold(dropout_p):
    return max(int((1.0 - dropout_p) * 4294967296.0) - 1, 0)


def next_dropout_seed(generator):
    """The next dropout seed: a one-element int32 tensor in [0, 2^31 - 1)
    on ``generator``'s device, drawn from it in one op. On the card that
    is Philox, a counter-based generator: its counter (the offset) moves
    by one draw a call, and a CUDA graph that captured the draw and
    registered the generator moves it on every replay, so each replay
    draws a new seed and a new mask."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)


def _seed_value(seed):
    """An int seed as it is; a seed tensor as a 0-dim int64 tensor of its
    32 bits, for the plain versions' hash."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(torch.int64) & _M32
    return int(seed)


def _check_args(q, k, v, dropout_p, dropout_seed):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (B, H, S, D) shape, got {tuple(q.shape)}"
            f", {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 requires dropout_seed")
    if isinstance(dropout_seed, torch.Tensor) and (
            dropout_seed.numel() != 1 or dropout_seed.dtype != torch.int32
            or dropout_seed.device != q.device):
        raise ValueError(
            f"a dropout seed tensor holds one int32 on q's device "
            f"({q.device}); got {tuple(dropout_seed.shape)} "
            f"{dropout_seed.dtype} on {dropout_seed.device}")


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              dropout_p=0.0, dropout_seed=None):
    """Plain PyTorch flash-attention forward: ``(out, lse)``.

    q/k/v: (B, H, S, D). Scores in f32, the softmax state (m, l) of the
    whole row, dropout on the numerator only with inverted scaling in the
    output division, P cast to v's dtype before the PV product, f32
    accumulation, out in q's dtype, lse f32 (-inf for a fully masked
    row)."""
    _check_args(q, k, v, dropout_p, dropout_seed)
    out, lse = attention_reference_f32(q, k, v, causal, scale, dropout_p,
                                       dropout_seed)
    return out.to(q.dtype), lse


def attention_reference_f32(q, k, v, causal=False, scale=None,
                            dropout_p=0.0, dropout_seed=None):
    """:func:`flash_attention_reference` with out left in float32 (the ring's
    hop partial, which is never rounded to q's dtype)."""
    b, h, s, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    m = scores.amax(dim=-1, keepdim=True)
    live = torch.isfinite(m)
    m_safe = torch.where(live, m, torch.zeros_like(m))
    p = torch.where(live, torch.exp(scores - m_safe), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    lse = torch.where(live, m + torch.log(denom),
                      torch.full_like(m, -math.inf))[..., 0]
    o_denom = denom
    if dropout_p > 0.0:
        dev = q.device
        bh = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
        q_pos = torch.arange(s, device=dev).reshape(1, 1, s, 1)
        k_pos = torch.arange(s, device=dev).reshape(1, 1, 1, s)
        keep = _dropout_keep(_seed_value(dropout_seed), bh, q_pos, k_pos,
                             dropout_p)
        p = torch.where(keep, p, torch.zeros_like(p))
        o_denom = denom * (1.0 - dropout_p)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return acc / o_denom, lse


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.mxtpu_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
        lib.mxtpu_flash_attention_tiles_aligned.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int]
        lib.mxtpu_flash_attention_tiles_aligned.restype = ctypes.c_int
    return lib


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_route(dtype, device_type):
    """Which version of the attention kernels a call takes, from its
    operands' dtype and device type; :func:`flash_attention_fwd` and
    :func:`flash_attention_bwd` dispatch on its answer.

    ``"plain"`` for CPU tensors (the plain version), ``"mma"`` for CUDA
    bfloat16 (the tensor-core kernels), ``"fp32"`` for CUDA float32 (the
    FP32 kernels); another device type or CUDA dtype raises. A pure
    function of its arguments."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, "
                         f"got {device_type}")
    variant = VARIANTS.get(dtype)
    if variant is None:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    return variant


def tensor_route(*tensors):
    """``(variant, aligned)`` of a call's operands (None entries skipped):
    :func:`kernel_route` of the first one's dtype and device, and for the
    tensor-core variant how its launcher stages their tiles (True: 16-byte
    cp.async copies; False: 2-byte loads in the same kernel; None for the
    other variants). ``aligned`` is the launchers' own rule
    (``tiles_aligned`` in csrc/flash_attention_common.cuh), asked of the
    built library with every operand's address and (batch, head, seq)
    strides; the outputs the wrapper allocates never change its answer."""
    ts = [t for t in tensors if t is not None]
    variant = kernel_route(ts[0].dtype, ts[0].device.type)
    if variant != "mma":
        return variant, None
    ptrs = (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
    strides = (ctypes.c_longlong * (3 * len(ts)))(
        *(n for t in ts for n in t.stride()[:3]))
    return variant, bool(_lib().mxtpu_flash_attention_tiles_aligned(
        ptrs, strides, len(ts), ts[0].shape[-1]))


def _count(kernel, variant):
    _TOTALS[kernel].add()
    VARIANT_LAUNCHES[kernel][variant].add()


def _check_kernel_takes(q, k, v):
    """The variant (:func:`kernel_route`) that q, k, v launch. Raises for
    inputs the kernels (forward and backward alike) do not take, so that a
    recorded forward never fails later, in backward."""
    variant = kernel_route(q.dtype, q.device.type)
    if variant == "plain":
        raise ValueError("the attention kernels take CUDA tensors; CPU "
                         "tensors take the plain version")
    b, h, _, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    if b * h > 65535:
        raise ValueError(f"flash_attention kernel takes B*H <= 65535, "
                         f"got {b * h}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its head dim")
    return variant


def _empty_bshd(b, h, s, d, like):
    """An uninitialized (B, H, S, D) view of (B, S, H, D) memory: the
    caller's transpose back to (B, S, H*D) is then free."""
    return torch.empty((b, s, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _seed_on_card(dropout_p, dropout_seed, device):
    """The seed tensor the kernels read (None without dropout): the one
    given, or an int seed's 32 bits copied to ``device``."""
    if dropout_p <= 0.0:
        return None
    if isinstance(dropout_seed, torch.Tensor):
        return dropout_seed
    bits = int(dropout_seed) & _M32
    return torch.tensor([bits - (1 << 32) if bits >> 31 else bits],
                        dtype=torch.int32, device=device)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch(q, k, v, causal, scale, dropout_p, dropout_seed):
    b, h, s, d = q.shape
    variant = _check_kernel_takes(q, k, v)
    out = _empty_bshd(b, h, s, d, q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    seed = _seed_on_card(dropout_p, dropout_seed, q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtpu_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _KERNEL_DTYPES[q.dtype], b, h, s, d, strides,
            scale, int(bool(causal)), int(dropout_p > 0.0),
            1.0 - dropout_p, _ptr(seed), _threshold(dropout_p), stream)
    if err:
        raise RuntimeError(
            "flash_attention kernel launch failed: "
            + lib.mxtpu_cuda_error_string(err).decode())
    _count(KERNEL, variant)
    return out, lse


def flash_attention_fwd(q, k, v, causal=False, scale=None, dropout_p=0.0,
                        dropout_seed=None):
    """``(out, lse)`` of fused attention over (B, H, S, D) (the
    ``_flash_fwd`` contract): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    dropout_p = float(dropout_p)
    _check_args(q, k, v, dropout_p, dropout_seed)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if kernel_route(q.dtype, q.device.type) == "plain":
        return flash_attention_reference(q, k, v, causal, scale, dropout_p,
                                         dropout_seed)
    return _launch(q, k, v, causal, scale, dropout_p, dropout_seed)


def flash_attention_bwd_reference(q, k, v, out, lse, dout, causal=False,
                                  scale=None, dropout_p=0.0,
                                  dropout_seed=None):
    """Plain PyTorch flash-attention backward: ``(dq, dk, dv)``.

    The arithmetic of ``_flash_bwd`` with one tile spanning the row, in
    explicit formulas (no ``torch.autograd``): delta = rowsum(dO * O) in
    f32; P = exp(q k^T * scale - lse), 0 where masked or lse is -inf;
    dP = dO v^T, kept pairs divided by 1 - p under dropout; dS =
    P * (dP - delta) * scale cast to the inputs' dtype before dS k and
    dS^T q; P_d (kept P / (1 - p)) cast to dO's dtype before P_d^T dO; f32
    accumulation; dq, dk, dv in the inputs' dtypes."""
    _check_args(q, k, v, dropout_p, dropout_seed)
    delta = (dout.float() * out.float()).sum(dim=-1)
    dq, dk, dv = attention_bwd_reference_f32(q, k, v, lse, delta, dout,
                                             causal, scale, dropout_p,
                                             dropout_seed)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_reference_f32(q, k, v, lse, delta, dout, causal=False,
                                scale=None, dropout_p=0.0,
                                dropout_seed=None):
    """:func:`flash_attention_bwd_reference` from a given ``delta`` (B, H, S)
    f32, with dq, dk, dv left in float32 (the ring's hop, which adds them
    into float32 sums)."""
    b, h, s, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    lse_col = lse[..., None]
    live = torch.isfinite(lse_col)
    lse_safe = torch.where(live, lse_col, torch.zeros_like(lse_col))
    p = torch.where(live, torch.exp(scores - lse_safe),
                    torch.zeros_like(scores))
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    p_d = p
    if dropout_p > 0.0:
        dev = q.device
        bh = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
        q_pos = torch.arange(s, device=dev).reshape(1, 1, s, 1)
        k_pos = torch.arange(s, device=dev).reshape(1, 1, 1, s)
        keep = _dropout_keep(_seed_value(dropout_seed), bh, q_pos, k_pos,
                             dropout_p)
        zero = torch.zeros_like(p)
        p_d = torch.where(keep, p, zero) / (1.0 - dropout_p)
        dp = torch.where(keep, dp, zero) / (1.0 - dropout_p)
    dv = torch.einsum("bhqk,bhqd->bhkd", p_d.to(dout.dtype).float(),
                      dout.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq, dk, dv


def _lib_bwd():
    lib = _build.load(KERNEL_BWD)
    dq_fn = lib.mxtpu_flash_attention_bwd_dq
    if dq_fn.argtypes is None:
        tail = ([ctypes.c_int] * 5
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p])
        for fn in (dq_fn, lib.mxtpu_flash_attention_bwd_dkv):
            fn.argtypes = [ctypes.c_void_p] * 8 + tail
            fn.restype = ctypes.c_int
        lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_tail(q, tensors, causal, scale, dropout_p, seed):
    """The arguments both backward kernels share after their pointers;
    ``tensors``: q, k, v, out, dout, dq, dk, dv (or None), whose strides
    the kernels take in that order; ``seed``: the seed tensor on the card
    (None without dropout)."""
    b, h, s, d = q.shape
    strides = (ctypes.c_longlong * 24)(*(
        n for t in tensors
        for n in (t.stride()[:3] if t is not None else (0, 0, 0))))
    return (_KERNEL_DTYPES[q.dtype], b, h, s, d, strides, scale,
            int(bool(causal)), int(dropout_p > 0.0), 1.0 - dropout_p,
            _ptr(seed), _threshold(dropout_p))


def _check_bwd_takes(q, k, v, out, lse, dout):
    variant = _check_kernel_takes(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t is not None and t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its head dim")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous float32 (B, H, S) tensor")
    return variant


def launch_bwd_dq(q, k, v, out, lse, dout, causal, scale, dropout_p,
                  dropout_seed):
    """Launch the dQ kernel on CUDA tensors: ``(dq, delta)``. It also
    computes delta = rowsum(dO * O), which the dK/dV kernel reads."""
    b, h, s, d = q.shape
    variant = _check_bwd_takes(q, k, v, out, lse, dout)
    delta = torch.empty_like(lse)
    dq = _empty_bshd(b, h, s, d, q)
    seed = _seed_on_card(dropout_p, dropout_seed, q.device)
    tail = _bwd_tail(q, (q, k, v, out, dout, dq, None, None), causal, scale,
                     dropout_p, seed)
    lib = _lib_bwd()
    with torch.cuda.device(q.device):
        err = lib.mxtpu_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *tail,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention dq kernel launch failed: "
                           + lib.mxtpu_cuda_error_string(err).decode())
    _count(KERNEL_BWD_DQ, variant)
    return dq, delta


def launch_bwd_dkv(q, k, v, lse, delta, dout, causal, scale, dropout_p,
                   dropout_seed):
    """Launch the dK/dV kernel on CUDA tensors: ``(dk, dv)``. ``delta`` is
    what :func:`launch_bwd_dq` returned for the same inputs."""
    b, h, s, d = q.shape
    variant = _check_bwd_takes(q, k, v, None, lse, dout)
    dk = _empty_bshd(b, h, s, d, q)
    dv = _empty_bshd(b, h, s, d, q)
    seed = _seed_on_card(dropout_p, dropout_seed, q.device)
    tail = _bwd_tail(q, (q, k, v, None, dout, None, dk, dv), causal, scale,
                     dropout_p, seed)
    lib = _lib_bwd()
    with torch.cuda.device(q.device):
        err = lib.mxtpu_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *tail, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention dk/dv kernel launch failed: "
                           + lib.mxtpu_cuda_error_string(err).decode())
    _count(KERNEL_BWD_DKV, variant)
    return dk, dv


def _launch_bwd(q, k, v, out, lse, dout, causal, scale, dropout_p,
                dropout_seed):
    if dout.stride(3) != 1:
        # the kernels read rows of the head dim; a gradient that arrives
        # strided there is copied once, here
        dout = dout.contiguous()
    lse = lse.contiguous()
    # dq first: it also writes delta, which the dk/dv kernel reads
    dq, delta = launch_bwd_dq(q, k, v, out, lse, dout, causal, scale,
                              dropout_p, dropout_seed)
    dk, dv = launch_bwd_dkv(q, k, v, lse, delta, dout, causal, scale,
                            dropout_p, dropout_seed)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, causal=False, scale=None,
                        dropout_p=0.0, dropout_seed=None):
    """``(dq, dk, dv)`` from the forward's inputs, its ``out`` and ``lse``
    and the output gradient ``dout`` (the ``_flash_bwd`` contract): the two
    CUDA kernels for CUDA tensors, the plain version for CPU tensors."""
    dropout_p = float(dropout_p)
    _check_args(q, k, v, dropout_p, dropout_seed)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if kernel_route(q.dtype, q.device.type) == "plain":
        return flash_attention_bwd_reference(
            q, k, v, out, lse, dout, causal, scale, dropout_p, dropout_seed)
    return _launch_bwd(q, k, v, out, lse, dout, causal, scale, dropout_p,
                       dropout_seed)


class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse) and the seed, what
    ``_flash_vjp_fwd`` saves; backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_p, dropout_seed):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, dropout_p,
                                       dropout_seed)
        ctx.save_for_backward(q, k, v, out, lse)
        if isinstance(dropout_seed, torch.Tensor):
            # the backward draws the same mask even if the caller's seed
            # tensor moves on before it runs
            dropout_seed = dropout_seed.clone()
        ctx.attn_args = (causal, scale, dropout_p, dropout_seed)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         *ctx.attn_args)
        return dq, dk, dv, None, None, None, None


@register_op("flash_attention")
def flash_attention(q, k, v, causal=False, scale=None, block_q=128,
                    block_k=128, interpret=None, dropout_p=0.0,
                    dropout_seed=None):
    """Fused multi-head attention ``softmax(q k^T * scale) v`` over
    (B, H, S, D), the ``flash_attention`` op of the JAX package with its
    whole signature (ops/pallas_attention.py:466).

    ``dropout_p > 0`` with a ``dropout_seed`` (an int, or a one-element
    int32 tensor on q's device) applies attention-prob dropout with the
    counter-hash mask (numerator only, inverted scaling).
    Differentiable in q, k and v: when torch autograd is recording, the
    backward runs the backward kernels on CUDA tensors and the plain
    backward on CPU tensors. A CUDA input the kernels do not take raises
    here, in the forward; there is no other path on a card.

    ``block_q``, ``block_k`` and ``interpret`` are the Pallas kernel's
    tiling and its interpreter switch. They are accepted and change
    nothing: the CUDA kernels choose their own tiles (a tile is what the
    Hopper kernel's shared memory and warps take, not the TPU's), and the
    plain version of a CPU tensor is what the interpreter stood for; the
    result does not depend on them in the JAX package either."""
    del block_q, block_k, interpret
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale, dropout_p,
                                     dropout_seed)
    return flash_attention_fwd(q, k, v, causal, scale, dropout_p,
                               dropout_seed)[0]
