"""Fused optimizer ladder and its global-norm pre-pass: the CUDA kernels'
wrappers and their dispatch (counterpart of mxnet_tpu/kernels/opt.py).

The TPU kernel ``_ladder_kernel`` (launched by ``_ladder_pallas``) becomes
the hand-written CUDA kernel ``csrc/opt_ladder.cu``: one elementwise pass
that reads each gradient once, reads and writes each master (or weight)
and state leaf once and writes each low-precision weight once, so under
multi-precision the f32 gradient never exists in device memory. It runs
ONE LAUNCH PER BUCKET (one rule, one gradient dtype, one state count), the
reference's one jit per bucket: the bucket's tensors travel in a table
passed by value as the kernel's parameter, :data:`TABLE_CAPACITY` tensors a
launch, a longer bucket split into as many launches as it needs. The same
source holds the pre-pass of ``clip_global_norm``, the sum of squares of
the rescaled gradients of a bucket over the same table, deterministic (no
atomics).

:func:`bucket_step` is the drop-in twin of ``Optimizer._fused_param_step``
looped over a bucket (:func:`bucket_step_reference`, the kernel's plain
version), :func:`param_step` a bucket of one, and :func:`bucket_sqnorm`
the twin of ``Optimizer._fused_sqnorm`` (:func:`bucket_sqnorm_reference`).
Which of the two runs is decided for each member before any launch, by the
rule, the dtypes and the device alone, and counted by outcome
(kernels/dispatch.py) under ``opt_<rule>``: ``unsupported_rule`` (not one
of SGD, NAG, Signum, Adam, AdamW, the rules of the JAX package's Pallas
ladder; the others, LAMB's layer-wise norms among them, run plain); ``unsupported_dtype``; ``platform`` (the tensors are not CUDA
tensors); else ``kernel``. The members decided ``kernel`` go into one
launch; once the decision is ``kernel``, a build or launch failure raises.
The TPU kernel's size rule (a multiple of 1024 elements) was a lane rule:
here a tensor's last chunk is masked in the kernel, and a parameter of any
size takes it.

The table (:func:`ladder_tables`, :func:`norm_tables`) is built on the host
as a numpy array of :data:`ENTRY` records, the C struct's layout: pointers,
size, first chunk, a 16-byte-alignment flag and every scalar that depends
on the tensor's own lr, wd or update count, computed in f32 as the
per-parameter entry point of the first port computed them (libm's
``powf``, then f32 products), so each element's result is that kernel's.

For a launch captured in a CUDA graph (``gluon.TrainStep``),
:func:`bucket_step_dev` takes the same members without their lr, wd and t:
the table keeps only pointers, sizes, first chunks and alignment flags, and
each entry's scalars and the rescale are read at run time from a small f32
buffer on the device, :data:`SCALAR_STRIDE` floats a member
(:func:`ladder_scalars` computes the rows on the host, by :func:`_scalars`,
so both entries give the same bits). :func:`bucket_step_dev_reference`, its
plain version, reads the same rows.

Counters: :data:`LAUNCHES` (``opt_ladder``) and :data:`SQNORM_LAUNCHES`
(``opt_sqnorm``: one per bucket norm, its partial launches and the finish
together) count launches; :data:`TENSORS` counts the tensors the ladder
kernel updated and is not among ``build.COUNTERS``.

The update is IN PLACE, like the plain version's.
"""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as _np
import torch

from . import build as _build
from . import dispatch as _dispatch

__all__ = ["bucket_step", "bucket_step_reference", "bucket_sqnorm",
           "bucket_sqnorm_reference", "param_step", "ladder_tables",
           "norm_tables", "bucket_step_dev", "bucket_step_dev_reference",
           "ladder_scalars", "KERNEL", "LAUNCHES",
           "SQNORM_LAUNCHES", "TENSORS", "CHUNK", "TABLE_CAPACITY",
           "NORM_BLOCKS", "ENTRY", "SCALAR_STRIDE"]

KERNEL = "opt_ladder"
#: launches of the ladder kernel (plain-version calls are not counted)
LAUNCHES = _build.counter(KERNEL)
#: bucket norms computed by the norm kernels
SQNORM_LAUNCHES = _build.counter("opt_sqnorm")
#: tensors the ladder kernel updated; not a launch counter, so not in
#: build.COUNTERS
TENSORS = _build.LaunchCounter("opt_ladder_tensors")

#: elements of one tensor a CTA takes; tensors a launch; CTAs of a norm
#: launch (csrc/opt_ladder.cu kChunk, kMaxEntries, kNormBlocks)
CHUNK = 8192
TABLE_CAPACITY = 384
NORM_BLOCKS = 1024
#: f32 values a member of :func:`bucket_step_dev` reads from its scalar
#: buffer: lr, wd, b1c, b2c, lr_t, c1, rescale (kScalarStride), then the
#: update count t, which the kernel does not read: the plain version hands
#: it to a rule that computes its own powers of t (Nadam, FTML, LAMB, ...)
SCALAR_STRIDE = 8

#: one table entry, the layout of ``struct Entry`` in csrc/opt_ladder.cu
ENTRY = _np.dtype([
    ("w", "<u8"), ("g", "<u8"), ("s0", "<u8"), ("s1", "<u8"),
    ("w_lp", "<u8"), ("n", "<i8"), ("lr", "<f4"), ("wd", "<f4"),
    ("b1c", "<f4"), ("b2c", "<f4"), ("lr_t", "<f4"), ("c1", "<f4"),
    ("chunk0", "<i4"), ("vec", "<i4")])

# rules proven elementwise, and their number in csrc/opt_ladder.cu
_RULE_IDS = {"SGD": 0, "NAG": 1, "Signum": 2, "Adam": 3, "AdamW": 4}
# the rule's own scalars, in the order the kernel takes them (h0, h1, h2)
_RULE_HYPER = {
    "SGD": ("momentum",), "NAG": ("momentum",),
    "Signum": ("momentum", "wd_lh"),
    "Adam": ("beta1", "beta2", "eps"), "AdamW": ("beta1", "beta2", "eps"),
}
_F32 = _np.float32
_LIBM = None


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


def _parts(mp, w, st):
    """``(master, state leaves)`` of one parameter: under multi-precision
    the f32 master and its inner state's leaves, else ``w`` and its
    state's."""
    if mp:
        return st[0], _leaves(st[1])
    return w, _leaves(st)


def _supported(cls, mp, w, st, g):
    """None when the ladder kernel can run this parameter, else the
    outcome name."""
    return _unsupported(cls.__name__, mp, w, g, *_parts(mp, w, st))


def _unsupported(name, mp, w, g, master, leaves):
    if name not in _RULE_IDS:
        return "unsupported_rule"
    wdt = torch.bfloat16 if mp else torch.float32
    shape = w.shape
    if (w.dtype != wdt or g.dtype != wdt or master.dtype != torch.float32
            or master.shape != shape):
        return "unsupported_dtype"
    for leaf in leaves:
        if leaf.shape != shape or leaf.dtype != torch.float32:
            return "unsupported_dtype"
    return None


def _outcome(name, mp, w, g, master, leaves):
    reason = _unsupported(name, mp, w, g, master, leaves)
    if reason is not None:
        return reason
    if not _dispatch.platform_ok(w, g, master, *leaves):
        return "platform"
    return "kernel"


def _decide(cls, mp, w, st, g):
    """The outcome for one parameter: ``kernel``, or why the plain ladder
    runs (``unsupported_rule``, ``unsupported_dtype``, ``platform``)."""
    return _outcome(cls.__name__, mp, w, g, *_parts(mp, w, st))


# -- the table ---------------------------------------------------------------

def _powf(x, y):
    """libm's ``powf``: the function the first port's C entry point called
    for ``beta^t``, so its bits (numpy's ``power`` may take another
    routine)."""
    global _LIBM
    if _LIBM is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.powf.restype = ctypes.c_float
        _LIBM = lib
    return _F32(_LIBM.powf(x, y))


def _hyper_f32(name, hyper):
    """(h0, h1, h2) of rule ``name`` as f32, zeros where it has none."""
    hs = [_F32(hyper[k]) for k in _RULE_HYPER.get(name, ())]
    return tuple(hs + [_F32(0.0)] * (3 - len(hs)))


def _scalars(name, h0, h1, lr, wd, t):
    """``(lr, wd, b1c, b2c, lr_t, c1)`` of one tensor in f32, as the first
    port's per-parameter entry point computed them: ``c1`` is Signum's
    ``lr * wd_lh`` or Adam's ``1 - beta2``; ``b1c = 1 - h0^t``, ``b2c = 1 -
    h1^t``; ``lr_t = lr * sqrt(b2c) / b1c``."""
    lr, wd, t = _F32(lr), _F32(wd), _F32(t)
    one = _F32(1.0)
    with _np.errstate(all="ignore"):   # a momentum of 1: C gives inf too
        c1 = lr * h1 if name == "Signum" else one - h1
        b1c = one - _powf(h0, t)
        b2c = one - _powf(h1, t)
        lr_t = lr * _np.sqrt(b2c) / b1c
    return lr, wd, b1c, b2c, lr_t, c1


def ladder_scalars(cls, hyper, rescale, steps):
    """The scalar rows of :func:`bucket_step_dev` for members whose
    ``(lr, wd, t)`` are ``steps``: an f32 numpy array of shape
    ``(len(steps), SCALAR_STRIDE)``, each row :func:`_scalars` of its
    member, then ``rescale`` and ``t`` in f32. Host work only."""
    name = cls.__name__
    h0, h1, _ = _hyper_f32(name, hyper)
    memo, rows = {}, []
    for key in steps:
        row = memo.get(key)
        if row is None:
            row = memo[key] = _scalars(name, h0, h1, *key) + (
                _F32(rescale), _F32(key[2]))
        rows.append(row)
    return _np.array(rows, dtype=_F32).reshape(len(steps), SCALAR_STRIDE)


def _tables(sizes, capacity):
    """Cut members into launches of at most ``capacity`` and number their
    chunks: ``[(start, stop, chunk0)]``, ``chunk0`` each member's first
    chunk in its launch."""
    sizes = _np.asarray(sizes, dtype=_np.int64)
    chunks = (sizes + CHUNK - 1) // CHUNK
    out = []
    for start in range(0, len(sizes), capacity):
        stop = min(start + capacity, len(sizes))
        c = chunks[start:stop]
        out.append((start, stop, _np.cumsum(c) - c))
    return out


def _aligned(*ptrs):
    bits = 0
    for p in ptrs:
        bits |= p
    return int(bits & 15 == 0)


def ladder_tables(cls, mp, members, hyper, capacity=TABLE_CAPACITY):
    """The ladder's launches for ``members``, ``[(w, st, g, lr, wd, t)]``
    that the kernel takes (non-empty, contiguous): a list of numpy arrays
    of :data:`ENTRY`, one a launch, each entry with its first chunk and its
    own scalars (:func:`_scalars`). Pure: reads addresses and sizes,
    launches nothing, works on CPU tensors too."""
    return _ladder_tables(
        cls.__name__, mp, [(w, g, *_parts(mp, w, st), lr, wd, t)
                           for w, st, g, lr, wd, t in members],
        hyper, capacity)


def _ladder_tables(name, mp, members, hyper, capacity=TABLE_CAPACITY):
    """:func:`ladder_tables` of ``[(w, g, master, leaves, lr, wd, t)]``."""
    h0, h1, _ = _hyper_f32(name, hyper)
    rows, memo = [], {}
    for w, g, master, leaves, lr, wd, t in members:
        n_leaves = len(leaves)
        ptrs = (master.data_ptr(), g.data_ptr(),
                leaves[0].data_ptr() if n_leaves > 0 else 0,
                leaves[1].data_ptr() if n_leaves > 1 else 0,
                w.data_ptr() if mp else 0)
        key = (lr, wd, t)
        if key not in memo:
            memo[key] = _scalars(name, h0, h1, lr, wd, t)
        rows.append(ptrs + (w.numel(),) + memo[key] + (0, _aligned(*ptrs)))
    tables = []
    for start, stop, chunk0 in _tables([r[5] for r in rows], capacity):
        table = _np.array(rows[start:stop], dtype=ENTRY)
        table["chunk0"] = chunk0
        tables.append(table)
    return tables


def norm_tables(gs, capacity=TABLE_CAPACITY):
    """The norm's launches over gradients ``gs`` (non-empty, contiguous):
    numpy arrays of :data:`ENTRY` with only ``g``, ``n``, ``chunk0`` and
    ``vec`` set."""
    tables = []
    for start, stop, chunk0 in _tables([g.numel() for g in gs], capacity):
        table = _np.zeros(stop - start, dtype=ENTRY)
        ptrs = [g.data_ptr() for g in gs[start:stop]]
        table["g"] = ptrs
        table["n"] = [g.numel() for g in gs[start:stop]]
        table["chunk0"] = chunk0
        table["vec"] = [_aligned(p) for p in ptrs]
        tables.append(table)
    return tables


def _n_chunks(table):
    return int(table["chunk0"][-1] + (table["n"][-1] + CHUNK - 1) // CHUNK)


# -- launches ------------------------------------------------------------------

def _lib():
    lib = _build.load(KERNEL)
    fn = lib.mxtpu_opt_ladder_bucket
    if fn.argtypes is None:
        consts = {"mxtpu_opt_entry_size": ENTRY.itemsize,
                  "mxtpu_opt_table_capacity": TABLE_CAPACITY,
                  "mxtpu_opt_chunk": CHUNK,
                  "mxtpu_opt_norm_blocks": NORM_BLOCKS,
                  "mxtpu_opt_scalar_stride": SCALAR_STRIDE}
        for cname, want in consts.items():
            getattr(lib, cname).restype = ctypes.c_int
            got = getattr(lib, cname)()
            if got != want:
                raise RuntimeError(f"csrc/opt_ladder.cu {cname}() is {got}; "
                                   f"kernels/opt.py plans with {want}")
        lib.mxtpu_opt_sqnorm_bucket.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.mxtpu_opt_sqnorm_bucket.restype = ctypes.c_int
        lib.mxtpu_opt_sqnorm_finish.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.mxtpu_opt_sqnorm_finish.restype = ctypes.c_int
        lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        dev = lib.mxtpu_opt_ladder_bucket_dev
        dev.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                        + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 2)
        dev.restype = ctypes.c_int
    return lib


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.mxtpu_cuda_error_string(err).decode())


def _check_contiguous(names, tensors):
    for name, x in zip(names, tensors):
        if not x.is_contiguous():
            raise ValueError(f"the optimizer kernels take contiguous "
                             f"tensors; the {name} is not")


_LADDER_NAMES = ("weight", "gradient", "master", "state", "state")


def _by_state(members):
    """``{state leaves: members}`` of the non-empty ``members`` (``(w, g,
    master, leaves, ...)``), each checked for what the kernel takes."""
    by_state = {}
    for m in members:
        w, g, master, leaves = m[:4]
        if not all(x.is_contiguous() for x in (w, g, master, *leaves)):
            _check_contiguous(_LADDER_NAMES, (w, g, master, *leaves))
        if g.shape != w.shape:
            raise ValueError(f"gradient shape {tuple(g.shape)} != weight "
                             f"shape {tuple(w.shape)}")
        if w.numel():
            by_state.setdefault(len(leaves), []).append(m)
    return by_state


def _launch_bucket(name, clip, gn, mp, members, scale, hyper):
    """One ladder launch per table over ``members``, ``(w, g, master,
    leaves, lr, wd, t)`` that the kernel takes."""
    by_state = _by_state(members)
    if not by_state:
        return
    h0, h1, h2 = (float(h) for h in _hyper_f32(name, hyper))
    dev = members[0][0].device
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for n_state, group in by_state.items():
            for table in _ladder_tables(name, mp, group, hyper):
                err = lib.mxtpu_opt_ladder_bucket(
                    table.ctypes.data, len(table), int(mp), _RULE_IDS[name],
                    n_state, int(bool(gn)), int(clip is not None),
                    float(hyper["rescale_grad"]),
                    float(scale) if gn else 0.0,
                    float(clip) if clip is not None else 0.0, h0, h1, h2,
                    stream)
                _raise_on(lib, err, "optimizer ladder kernel")
                LAUNCHES.add()
                TENSORS.add(len(table))


def _check_scalars(scalars, n, device):
    if (scalars.dtype != torch.float32 or not scalars.is_contiguous()
            or tuple(scalars.shape) != (n, SCALAR_STRIDE)
            or scalars.device != device):
        raise ValueError(
            f"the scalar rows must be a contiguous f32 ({n}, "
            f"{SCALAR_STRIDE}) tensor on {device}, got "
            f"{tuple(scalars.shape)} {scalars.dtype} on {scalars.device}")


def _launch_bucket_dev(name, clip, mp, members, scalars, hyper):
    """One ladder launch per table over ``members``, ``(w, g, master,
    leaves, row)`` that the kernel takes, each reading row ``row`` of
    ``scalars``."""
    by_state = _by_state(members)
    h0, h1, h2 = (float(h) for h in _hyper_f32(name, hyper))
    dev = scalars.device
    lib = _lib()
    row_bytes = SCALAR_STRIDE * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for n_state, group in by_state.items():
            # the rows of one launch must be consecutive: a group gathers
            # its members' rows into a block of its own when they are not
            rows = [m[4] for m in group]
            if rows == list(range(rows[0], rows[0] + len(rows))):
                block, base = scalars, rows[0]
            else:
                block, base = scalars[rows], 0
            at = 0
            for table in _ladder_tables(
                    name, mp, [m[:4] + (0.0, 0.0, 1) for m in group], hyper):
                err = lib.mxtpu_opt_ladder_bucket_dev(
                    table.ctypes.data, len(table), int(mp), _RULE_IDS[name],
                    n_state, int(clip is not None),
                    float(clip) if clip is not None else 0.0, h0, h1, h2,
                    block.data_ptr() + (base + at) * row_bytes, stream)
                _raise_on(lib, err, "optimizer ladder kernel")
                LAUNCHES.add()
                TENSORS.add(len(table))
                at += len(table)


def bucket_step_dev_reference(cls, clip, mp, members, scalars, hyper):
    """The plain version of :func:`bucket_step_dev`:
    ``Optimizer._fused_param_step`` over each ``(w, st, g)`` with the lr,
    wd, ``1 - beta^t``, rescale and t of its row of ``scalars`` (read on
    the host: on a CUDA tensor this synchronises)."""
    from ..optimizer.optimizer import Optimizer
    rows = scalars.tolist()
    for (w, st, g), row in zip(members, rows):
        lr, wd, b1c, b2c, _lr_t, _c1, rescale, t = row
        h = dict(hyper, rescale_grad=rescale, b1c=b1c, b2c=b2c)
        Optimizer._fused_param_step(cls, clip, False, mp, w, st, g, lr, wd,
                                    int(t), 1.0, h)


def bucket_step_dev(cls, clip, mp, members, scalars, hyper):
    """The ladder of every ``(w, st, g)`` of one bucket, in place, as
    :func:`bucket_step` without a global norm, each member taking its lr,
    wd, update-count scalars and the rescale from its row of ``scalars``,
    an f32 ``(len(members), SCALAR_STRIDE)`` tensor on the members' device
    (:func:`ladder_scalars`). The launches read the rows when they run, so
    a launch captured in a CUDA graph takes each replay's values. Decisions
    are counted as in :func:`bucket_step`; members the kernel does not take
    run :func:`bucket_step_dev_reference`."""
    name = cls.__name__
    key = "opt_" + name.lower()
    if not members:
        return
    _check_scalars(scalars, len(members), members[0][0].device)
    kernel, plain = [], []
    for k, (w, st, g) in enumerate(members):
        master, leaves = _parts(mp, w, st)
        outcome = _outcome(name, mp, w, g, master, leaves)
        _dispatch.record(key, outcome)
        if outcome == "kernel":
            kernel.append((w, g, master, leaves, k))
        else:
            plain.append(k)
    if plain:
        bucket_step_dev_reference(cls, clip, mp,
                                  [members[k] for k in plain],
                                  scalars[plain], hyper)
    if kernel:
        _launch_bucket_dev(name, clip, mp, kernel, scalars, hyper)


def bucket_step_reference(cls, clip, gn, mp, items, scale, hyper):
    """The plain version of :func:`bucket_step`:
    ``Optimizer._fused_param_step`` over each ``(w, st, g, lr, wd, t)``."""
    for w, st, g, lr, wd, t in items:
        _plain(cls, clip, gn, mp, w, st, g, lr, wd, t, scale, hyper)


def bucket_step(cls, clip, gn, mp, items, scale, hyper):
    """Kernel-backed twin of :func:`bucket_step_reference`: the rescale ->
    clip -> rule -> cast ladder of every ``(w, st, g, lr, wd, t)`` of one
    bucket, in place. Each member's decision is counted in
    ``dispatch.COUNTS`` under ``opt_<rule>``; the members decided
    ``kernel`` take one launch (more when the bucket outgrows a table),
    the others the plain ladder."""
    name = cls.__name__
    key = "opt_" + name.lower()
    members = []
    for w, st, g, lr, wd, t in items:
        master, leaves = _parts(mp, w, st)
        outcome = _outcome(name, mp, w, g, master, leaves)
        _dispatch.record(key, outcome)
        if outcome == "kernel":
            members.append((w, g, master, leaves, lr, wd, t))
        else:
            _plain(cls, clip, gn, mp, w, st, g, lr, wd, t, scale, hyper)
    if members:
        _launch_bucket(name, clip, gn, mp, members, scale, hyper)


def param_step(cls, clip, gn, mp, w, st, g, lr, wd, t, scale, hyper):
    """One parameter's ladder, a bucket of one (:func:`bucket_step`).
    Returns ``(w, st)``, the tensors it was given."""
    bucket_step(cls, clip, gn, mp, [(w, st, g, lr, wd, t)], scale, hyper)
    return w, st


def bucket_sqnorm_reference(gs, rescale, out=None):
    """The plain version of :func:`bucket_sqnorm`:
    ``Optimizer._fused_sqnorm``, written into ``out`` when given."""
    from ..optimizer.optimizer import Optimizer
    total = Optimizer._fused_sqnorm(gs, rescale)
    if out is None:
        return total
    return out.copy_(total)


def bucket_sqnorm(gs, rescale, out=None):
    """Sum of squares of the rescaled gradients ``gs`` of one bucket, f32
    accumulation (the pre-pass of ``clip_global_norm``), as a 0-dim f32
    tensor on their device: ``out`` (a 0-dim f32 tensor, e.g. one slot of
    a vector of bucket sums) when given. CUDA gradients of one dtype, bf16
    or f32, take the norm kernels; CPU gradients, or a dtype they do not
    take, the plain version; gradients on the card and off it raise."""
    cuda = [g.is_cuda for g in gs]
    dtypes = {g.dtype for g in gs}
    if not all(cuda):
        if any(cuda):
            raise ValueError("bucket_sqnorm: the gradients of a bucket lie "
                             "on the card and off it")
        return bucket_sqnorm_reference(gs, rescale, out)
    if len(dtypes) != 1 or not dtypes <= {torch.bfloat16, torch.float32}:
        return bucket_sqnorm_reference(gs, rescale, out)
    dev = gs[0].device
    if out is None:
        out = torch.empty((), dtype=torch.float32, device=dev)
    elif out.dtype != torch.float32 or out.numel() != 1 or out.device != dev:
        raise ValueError("bucket_sqnorm: out must be one f32 element on the "
                         "gradients' device")
    gs = [g for g in gs if g.numel()]
    if not gs:
        return out.zero_()
    _check_contiguous(("gradient",) * len(gs), gs)
    tables = norm_tables(gs)
    blocks = [min(_n_chunks(t), NORM_BLOCKS) for t in tables]
    partials = torch.empty(sum(blocks), dtype=torch.float32, device=dev)
    bf16 = int(gs[0].dtype == torch.bfloat16)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        at = partials.data_ptr()
        for table, n in zip(tables, blocks):
            err = lib.mxtpu_opt_sqnorm_bucket(
                table.ctypes.data, len(table), bf16, float(_F32(rescale)),
                at, stream)
            _raise_on(lib, err, "global-norm kernel")
            at += 4 * n
        err = lib.mxtpu_opt_sqnorm_finish(partials.data_ptr(), sum(blocks),
                                          out.data_ptr(), stream)
        _raise_on(lib, err, "global-norm finish kernel")
    SQNORM_LAUNCHES.add()
    return out
