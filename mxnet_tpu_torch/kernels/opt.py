"""Fused optimizer ladder: the CUDA kernel's wrapper and its dispatch
(counterpart of mxnet_tpu/kernels/opt.py).

The TPU kernel ``_ladder_kernel`` (launched by ``_ladder_pallas``) becomes
the hand-written CUDA kernel ``csrc/opt_ladder.cu``: one elementwise pass
per parameter that reads the gradient once, reads and writes the master (or
weight) and each state leaf once and writes the low-precision weight once,
so under multi-precision the f32 gradient never exists in device memory.

:func:`param_step` is the drop-in twin of ``Optimizer._fused_param_step``,
which is the kernel's plain version. Which of the two runs is decided
before any launch by the rule, the dtypes and the device alone, and counted
by outcome (kernels/dispatch.py): ``unsupported_rule`` (not one of SGD,
NAG, Signum, Adam, AdamW: a rule that couples elements cannot run per
element); ``unsupported_dtype``; ``platform`` (the tensors are not CUDA
tensors); else ``kernel``. Once the decision is ``kernel``, a build or
launch failure raises. The TPU kernel's size rule (a multiple of 1024 elements) was a lane
rule: here the tail is masked in the kernel, and a parameter of any size
takes it.

The update is IN PLACE, like the plain version's.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as _build
from . import dispatch as _dispatch

__all__ = ["param_step", "KERNEL", "LAUNCHES"]

KERNEL = "opt_ladder"
#: launches of the CUDA kernel (plain-version calls are not counted)
LAUNCHES = _build.counter(KERNEL)

# rules proven elementwise, and their number in csrc/opt_ladder.cu
_RULE_IDS = {"SGD": 0, "NAG": 1, "Signum": 2, "Adam": 3, "AdamW": 4}
# the rule's own scalars, in the order the kernel takes them (h0, h1, h2)
_RULE_HYPER = {
    "SGD": ("momentum",), "NAG": ("momentum",),
    "Signum": ("momentum", "wd_lh"),
    "Adam": ("beta1", "beta2", "eps"), "AdamW": ("beta1", "beta2", "eps"),
}


def _plain(cls, clip, gn, mp, w, st, g, lr, wd, t, scale, hyper):
    from ..optimizer.optimizer import Optimizer
    return Optimizer._fused_param_step(cls, clip, gn, mp, w, st, g, lr, wd,
                                       t, scale, hyper)


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return [leaf for s in state for leaf in _leaves(s)]


def _supported(cls, mp, w, st, g):
    """None when the ladder kernel can run this parameter, else the
    outcome name."""
    if cls.__name__ not in _RULE_IDS:
        return "unsupported_rule"
    if mp:
        master, inner = st
        if (master.dtype != torch.float32 or master.shape != w.shape
                or w.dtype != torch.bfloat16 or g.dtype != torch.bfloat16):
            return "unsupported_dtype"
        leaves = _leaves(inner)
    else:
        if w.dtype != torch.float32 or g.dtype != torch.float32:
            return "unsupported_dtype"
        leaves = _leaves(st)
    for leaf in leaves:
        if leaf.shape != w.shape or leaf.dtype != torch.float32:
            return "unsupported_dtype"
    return None


def _decide(cls, mp, w, st, g):
    """The outcome for one parameter: ``kernel``, or why the plain ladder
    runs (``unsupported_rule``, ``unsupported_dtype``, ``platform``)."""
    reason = _supported(cls, mp, w, st, g)
    if reason is not None:
        return reason
    if not _dispatch.platform_ok(w, g, *_leaves(st)):
        return "platform"
    return "kernel"


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.mxtpu_opt_ladder
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(cls, clip, gn, mp, w, st, g, lr, wd, t, scale, hyper):
    master = st[0] if mp else w
    leaves = _leaves(st[1] if mp else st)
    for name, x in (("weight", w), ("gradient", g), ("master", master),
                    *(("state", leaf) for leaf in leaves)):
        if not x.is_contiguous():
            raise ValueError(f"the optimizer ladder kernel takes contiguous "
                             f"tensors; the {name} is not")
    if g.shape != w.shape:
        raise ValueError(f"gradient shape {tuple(g.shape)} != weight shape "
                         f"{tuple(w.shape)}")
    name = cls.__name__
    hs = [float(hyper[k]) for k in _RULE_HYPER[name]] + [0.0] * 3
    s0 = leaves[0].data_ptr() if len(leaves) > 0 else None
    s1 = leaves[1].data_ptr() if len(leaves) > 1 else None
    lib = _lib()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.mxtpu_opt_ladder(
            master.data_ptr(), g.data_ptr(), s0, s1,
            w.data_ptr() if mp else None, w.numel(), int(mp),
            _RULE_IDS[name], len(leaves), int(bool(gn)),
            int(clip is not None), float(lr), float(wd), float(t),
            float(hyper["rescale_grad"]), float(scale) if gn else 0.0,
            float(clip) if clip is not None else 0.0, hs[0], hs[1], hs[2],
            stream)
    if err:
        raise RuntimeError("optimizer ladder kernel launch failed: "
                           + lib.mxtpu_cuda_error_string(err).decode())
    LAUNCHES.add()
    return w, st


def param_step(cls, clip, gn, mp, w, st, g, lr, wd, t, scale, hyper):
    """Kernel-backed twin of ``Optimizer._fused_param_step``: one
    parameter's rescale -> clip -> rule -> cast ladder, in place. The
    decision between the kernel and the plain ladder is counted in
    ``dispatch.COUNTS`` under ``opt_<rule>``."""
    outcome = _decide(cls, mp, w, st, g)
    _dispatch.record("opt_" + cls.__name__.lower(), outcome)
    if outcome != "kernel":
        return _plain(cls, clip, gn, mp, w, st, g, lr, wd, t, scale, hyper)
    return _launch(cls, clip, gn, mp, w, st, g, lr, wd, t, scale, hyper)
