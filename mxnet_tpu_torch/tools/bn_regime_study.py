"""How each regime of K1 and K2 on the NCHW path does at the main paths'
BatchNorm shapes: every regime a shape can take, timed on the card.

    python -m mxnet_tpu_torch.tools.bn_regime_study [--sets mobilenet_v2,resnet18_cifar]

For each NCHW BatchNorm shape of MobileNetV2-1.0 at 224x224, batch 256,
and of ResNet-18 on CIFAR's 32x32, batch 64 (bf16, the f32 elementwise
mode) and each direction, it times ``bn_train_fwd`` / ``bn_train_bwd`` in
the regime ``launch_geometry`` chooses and in every other it could take:
``planes`` (its chunks) and ``resident`` at each cluster size of 1, 2, 4
or 8 CTAs whose share fits a block's shared memory. A regime is forced by
putting a fixed geometry in ``launch_geometry``'s place. Each time is the
kernels' own (the summed CUDA kernel durations the profiler records over
20 calls, after a warm-up), the inputs rotated over copies that exceed
twice the L2 (read from HBM, as the bounds assume), beside the read-once
bound. The outputs of every regime are held within 2^-7 of the largest
value against the chosen one's (the sums add in other orders). Prints
one JSON line a shape and direction, then a summary line. Needs a CUDA
card and the CUDA toolkit.
With ``--variants``, it times the resident kernels instead beside copies
of ``csrc/bn_train.cu`` with one part taken out (by text, as
``ring_hop_study`` does; each copy compiled by the port's ``nvcc`` flags
into ``build/kernels/study/``; a copy computes garbage, only its time
counts), in the regime launch_geometry chooses at a few MobileNetV2
shapes: ``no_copy`` (no cp.async into shared memory: no HBM reads),
``no_stats`` (no sums over the slots), ``no_apply`` (no normalize and no
stores), ``no_cluster`` (CTA barriers for the cluster's, each CTA's own
sums), ``occupancy_4`` (registers capped for 4 CTAs an SM, 2 slots in
flight from shared memory in place of 4), ``no_partial_stores`` (a
plane's head and tail slots not written) and ``whole_slot_stores`` (those
slots written as one 16-byte store, over the neighbouring plane's bytes).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess

import torch

from ..kernels import build, norm as knorm

HBM_BYTES_PER_S = 3.35e12   # H100 SXM
L2_BYTES = 50 * 2 ** 20


def mobilenet_v2_bn_sites(batch):
    """``[(NCHW shape, sites)]`` of MobileNetV2-1.0's 53 BatchNorm blocks
    at 224x224: the stem, each bottleneck's expansion, depthwise and
    projection, the last 1x1 convolution."""
    sites, c_in, hw = {(32, 112): 1}, 32, 112
    for t, c, n, s in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                       (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                       (6, 320, 1, 1)):
        for i in range(n):
            out_hw = hw // (s if i == 0 else 1)
            for key in ((c_in * t, hw), (c_in * t, out_hw), (c, out_hw)):
                sites[key] = sites.get(key, 0) + 1
            c_in, hw = c, out_hw
    sites[(1280, 7)] = 1
    return [((batch, c, hw, hw), k) for (c, hw), k in sites.items()]


#: ResNet-18's 20 BatchNorm sites on CIFAR's 32x32 (the ImageNet stem:
#: 16x16 after its convolution, 8x8 after the max pool); the 1x1 sites'
#: channels are innermost (channels last), so they are not studied here
RESNET18_CIFAR_SITES = [((64, 64, 16, 16), 1), ((64, 64, 8, 8), 4),
                        ((64, 128, 4, 4), 5), ((64, 256, 2, 2), 5),
                        ((64, 512, 1, 1), 5)]


def candidates(shape, backward, sms, smem, geometry=knorm.launch_geometry):
    """Every geometry a shape can take on the NCHW path (``geometry``:
    launch_geometry): the chosen one first, planes, and resident at each
    cluster size whose share fits a block."""
    chosen = geometry(shape, 1, 2, sms, True, backward, smem)
    out = [chosen]
    if chosen.regime != "planes":
        # the chunks planes would take: the geometry with no shared memory
        out.append(geometry(shape, 1, 2, sms, True, backward, 0))
    items = shape[0] * knorm.plane_slots(math.prod(shape[2:]), 2)
    for cs in (1, 2, 4, 8):
        data = -(-items // cs) * 16 * (2 if backward else 1)
        if cs != chosen.chunks or chosen.regime != "resident":
            if data + knorm._SMEM_STATIC <= smem:
                out.append(chosen._replace(chunks=cs, regime="resident"))
    return out


def _operands(shape, gen, dev):
    c = shape[1]
    x = (torch.randn(shape, device=dev, generator=gen) * 2 + 1).bfloat16()
    dy = torch.randn(shape, device=dev, generator=gen).bfloat16()
    g = torch.rand(c, device=dev, generator=gen) + 0.5
    b = torch.randn(c, device=dev, generator=gen)
    sh = torch.randn(c, device=dev, generator=gen) * 0.1 + 1
    return x, dy, g, b, sh


def _kernel_ms(fns, iters=20):
    """Mean summed CUDA kernel time of one call (ms), the calls rotating
    over ``fns``."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset")))
    return us / 1e3 / iters


def study_shape(shape, gen, dev, sms, smem):
    x, dy, g, b, sh = _operands(shape, gen, dev)
    nbytes = x.numel() * x.element_size()
    copies = min(32, max(2, -(-2 * L2_BYTES // nbytes) + 1))
    xs = [x.clone() for _ in range(copies)]
    dys = [dy.clone() for _ in range(copies)]
    _, mean, _, inv = knorm.bn_train_fwd_reference(x, g, b, sh, 1e-5, 1)
    dm, dv = torch.zeros_like(mean), torch.zeros_like(mean)
    rows = []
    real = knorm.launch_geometry
    try:
        for backward in (False, True):
            chosen = real(shape, 1, 2, sms, True, backward, smem)
            outs, times = [], []
            for geo in candidates(shape, backward, sms, smem, real):
                knorm.launch_geometry = lambda *a, geo=geo, **k: geo
                if backward:
                    fns = [lambda x=x_, dy=d_: knorm.bn_train_bwd(
                        x, g, sh, mean, inv, dy, dm, dv, 1)
                        for x_, d_ in zip(xs, dys)]
                    out = knorm.bn_train_bwd(x, g, sh, mean, inv, dy, dm, dv,
                                             1)
                else:
                    fns = [lambda x=x_: knorm.bn_train_fwd(x, g, b, sh, 1e-5,
                                                           1) for x_ in xs]
                    out = knorm.bn_train_fwd(x, g, b, sh, 1e-5, 1)
                outs.append(out[0].float())
                times.append(dict(regime=geo.regime, chunks=geo.chunks,
                                  ms=_kernel_ms(fns)))
            ref = outs[0]
            scale = max(ref.abs().max().item(), 1.0)
            errs = [(o - ref).abs().max().item() for o in outs]
            if max(errs) > 2.0 ** -7 * scale:
                raise AssertionError(f"{shape} {'bwd' if backward else 'fwd'}"
                                     f": regimes disagree by {errs}")
            n = math.prod(shape)
            bound = 1e3 * (3 if backward else 2) * n * 2 / HBM_BYTES_PER_S
            best = min(times, key=lambda t: t["ms"])
            rows.append(dict(
                shape=list(shape), side="bwd" if backward else "fwd",
                chosen=dict(regime=chosen.regime, chunks=chosen.chunks,
                            ms=times[0]["ms"]),
                best=best, bound_ms=bound, times=times,
                max_err_between_regimes=max(errs)))
    finally:
        knorm.launch_geometry = real
    return rows


STUDY_DIR = build.BUILD_DIR / "study"
#: the resident shapes the variants are timed at
VARIANT_SHAPES = ((256, 960, 7, 7), (256, 576, 14, 14), (256, 192, 28, 28),
                  (256, 144, 56, 56))


def _cut(src, old, new=""):
    if old not in src:
        raise RuntimeError(f"the source no longer holds {old[:60]!r}")
    return src.replace(old, new)


def variants():
    """``{variant: source text}`` of bn_train.cu with one part taken out
    of the resident kernels."""
    src = (build.CSRC / "bn_train.cu").read_text()
    no_copy = src
    for op in ("cp", "cpx", "cpdy"):
        no_copy = _cut(no_copy, "  for_items<kSmemUnroll, ALIGNED>(g, c, "
                                f"i0, i1, {op});\n")
    stats = "  for_items<kSmemUnroll, ALIGNED>(g, c, i0, i1, st);\n"
    apply = "  for_items<kSmemUnroll, ALIGNED>(g, c, i0, i1, ap);\n"
    no_cluster = _cut(_cut(src, "  cl.sync();", "  __syncthreads();"),
                      "cluster_sum(cl, sums, s1, s2);",
                      "s1 = sums[0];\n    s2 = sums[1];")
    occupancy = _cut(_cut(src, "__launch_bounds__(kThreads, 2)",
                          "__launch_bounds__(kThreads, 4)"),
                     "constexpr int kSmemUnroll = 4;",
                     "constexpr int kSmemUnroll = 2;")
    partial = ("    if (in_plane<T, false>(it, v)) store_elem(e, v, f[v]);\n")
    whole = ("  if (ALIGNED || (it.lo <= 0 && it.hi >= 16)) {\n"
             "    *reinterpret_cast<uint4*>(p)")
    return {"no_copy": no_copy, "no_stats": _cut(src, stats),
            "no_apply": _cut(src, apply), "no_cluster": no_cluster,
            "occupancy_4": occupancy,
            "no_partial_stores": _cut(src, partial, "    ;\n"),
            "whole_slot_stores": _cut(src, whole, whole.replace(
                "(it.lo <= 0 && it.hi >= 16)", "it.hi > 0"))}


def _compile_all(texts):
    """``({variant: library path}, {variant: ptxas register notes})``, one
    nvcc each, all started together."""
    STUDY_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = STUDY_DIR / f"bn_train_{name}.cu"
        lib = STUDY_DIR / f"libbn_train_{name}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, notes = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        libs[name] = lib
        notes[name] = sorted({line.split(":")[-1].strip()
                              for line in log.splitlines()
                              if "registers" in line})
    return libs, notes


def study_variants(gen, dev, sms, smem, shapes=None):
    """Each resident kernel's time beside its variants', in turns (the
    kernel, each variant, the kernel again)."""
    libs, notes = _compile_all(variants())
    print("bn_variant_ptxas " + json.dumps(notes), flush=True)
    real = knorm._lib
    loaded = {name: knorm._bind(ctypes.CDLL(str(path)))
              for name, path in libs.items()}
    for shape in shapes or VARIANT_SHAPES:
        x, dy, g, b, sh = _operands(shape, gen, dev)
        nbytes = x.numel() * x.element_size()
        copies = min(32, max(2, -(-2 * L2_BYTES // nbytes) + 1))
        xs = [x.clone() for _ in range(copies)]
        dys = [dy.clone() for _ in range(copies)]
        _, mean, _, inv = knorm.bn_train_fwd_reference(x, g, b, sh, 1e-5, 1)
        dm = torch.zeros_like(mean)
        for backward in (False, True):
            geo = knorm.launch_geometry(shape, 1, 2, sms, True, backward,
                                        smem)
            if geo.regime != "resident":
                continue
            if backward:
                fns = [lambda x=x_, dy=d_: knorm.bn_train_bwd(
                    x, g, sh, mean, inv, dy, dm, dm, 1)
                    for x_, d_ in zip(xs, dys)]
            else:
                fns = [lambda x=x_: knorm.bn_train_fwd(x, g, b, sh, 1e-5, 1)
                       for x_ in xs]
            times = {}
            try:
                for name in ("kernel", *loaded, "kernel"):
                    knorm._lib = (real if name == "kernel"
                                  else lambda lib=loaded[name]: lib)
                    times.setdefault(name, []).append(_kernel_ms(fns))
            finally:
                knorm._lib = real
            n = math.prod(shape)
            print("bn_variant " + json.dumps(dict(
                shape=list(shape), side="bwd" if backward else "fwd",
                chunks=geo.chunks,
                bound_ms=1e3 * (3 if backward else 2) * n * 2
                / HBM_BYTES_PER_S, ms=times)), flush=True)
        del xs, dys
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sets", default="mobilenet_v2,resnet18_cifar")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--shapes", default=None,
                    help="variants: indices into VARIANT_SHAPES, e.g. 0,1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bn_regime_study needs a CUDA card")
    build.build([knorm.SOURCE])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(9)
    sms, smem = knorm.sm_count(dev), knorm.smem_per_block(dev)
    if args.variants:
        study_variants(gen, dev, sms, smem, None if args.shapes is None
                       else [VARIANT_SHAPES[int(i)]
                             for i in args.shapes.split(",")])
        return
    sets = {"mobilenet_v2": mobilenet_v2_bn_sites(256),
            "resnet18_cifar": RESNET18_CIFAR_SITES}
    summary = {}
    for name in args.sets.split(","):
        total = dict(chosen_fwd=0.0, best_fwd=0.0, bound_fwd=0.0,
                     chosen_bwd=0.0, best_bwd=0.0, bound_bwd=0.0)
        for shape, k in sets[name]:
            if math.prod(shape[2:]) == 1:
                continue
            for row in study_shape(shape, gen, dev, sms, smem):
                row.update(set=name, sites=k)
                print("bn_regime " + json.dumps(row), flush=True)
                side = row["side"]
                total[f"chosen_{side}"] += k * row["chosen"]["ms"]
                total[f"best_{side}"] += k * row["best"]["ms"]
                total[f"bound_{side}"] += k * row["bound_ms"]
            torch.cuda.empty_cache()
        summary[name] = total
    print("bn_regime_study " + json.dumps(dict(
        summary=summary, sms=sms, smem_per_block=smem,
        card=torch.cuda.get_device_name(0))), flush=True)


if __name__ == "__main__":
    main()
