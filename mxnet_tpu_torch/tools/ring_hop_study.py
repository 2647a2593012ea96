"""Where one hop of the flash ring (K6) spends its time on the card: each
hop kernel beside copies of itself with one part taken out.

    python -m mxnet_tpu_torch.tools.ring_hop_study [--heads 12] [--seq 8192]

Builds ``csrc/ring_flash_fwd.cu`` and ``csrc/ring_flash_bwd.cu`` as the
port does, then copies of each source with one part removed (by text, so a
copy goes stale when its source changes: the tool then stops with the
part it could not find), each compiled by the same ``nvcc`` flags into
``build/kernels/study/``:

* forward: ``no_softmax`` (the masks, maxima, exponentials and sums),
  ``no_exp`` (p = the exponent, no MUFU), ``no_pv`` (the P V products),
  ``no_loads`` (the producer arrives without loading K and V),
  ``skeleton`` (no softmax, no O rescale, no K/V loads: the products and
  the pipeline alone);
* backward: ``no_dq`` (dQ's product, its staging and TMA add),
  ``no_ds`` (P and dS are the raw S^T and dP^T: no exponentials, masks or
  delta), ``no_loads`` (no Q/dO loads), ``no_barrier`` (the two consumer
  groups no longer meet before dQ).

A copy computes garbage; only its time counts. Each variant is timed on
one non-causal middle hop at (1, heads, seq, 64) bf16 on ``cuda:0``: the
mean of 20 host-issued launches between CUDA events after 3 warm-ups, in
turns with the kernel itself (kernel, variant, variant, kernel). Also
prints the ptxas notes of each library (serialised wgmma pipelines show
there as C7514/C7520) and counts of SASS instructions. Prints one JSON
object. Needs a CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..kernels import build
from ..ops import ring_hop as rh

STUDY_DIR = build.BUILD_DIR / "study"
SASS_OPS = ("HGMMA", "WARPGROUP.ARRIVE", "WARPGROUP.DEPBAR", "MUFU.EX2",
            "UTMALDG", "UTMAREDG", "BAR.SYNC", "LDL", "STL")

_FWD_LOADS = """\
          tma_load_4d(smem + L::kK + s * L::kKVBytes + hh * L::kKVHalf, &tk,
                      &full[s], hh * 64, j * kBlockN, h, b);
          tma_load_4d(smem + L::kV + s * L::kKVBytes + hh * L::kKVHalf, &tv,
                      &full[s], hh * 64, j * kBlockN, h, b);"""
_FWD_EXPECT = "mbar_expect_tx(&full[s], 2 * L::kKVBytes);"
_FWD_SOFTMAX = ("      softmax_tile(sc, (j + 1) * kBlockN, r_wg, row0, lane, "
                "a, m_run, l_run,\n                   corr);")
_FWD_EXP = ("fast_exp2(fmaf(sc[4 * i + e], a.scale_log2, "
            "neg_base[e >> 1]))")
_FWD_PV = ("      issue_pv<D>(o, pf, smem + L::kV + (j % kStages) * "
           "L::kKVBytes);")
_FWD_RESCALE = "      rescale_o<D>(o, corr);"
_BWD_LOADS = """\
            tma_load_4d(smem + L::kQ + s * L::kQBytes + hh * L::kQHalf, &tq,
                        &full[s], hh * 64, t * kBlockM, h, b);
            tma_load_4d(smem + L::kDO + s * L::kQBytes + hh * L::kQHalf,
                        &tdo, &full[s], hh * 64, t * kBlockM, h, b);"""
_BWD_EXPECT = "mbar_expect_tx(&full[s], 2 * L::kQBytes);"
_BWD_BARRIER = "      named_barrier(1, kConsumerThreads);"


def _cut(src, old, new=""):
    if old not in src:
        raise RuntimeError(f"the source no longer holds {old[:60]!r}")
    return src.replace(old, new)


def _between(src, start, end):
    """``src`` from ``start`` up to (not including) ``end``."""
    i = src.index(start)
    return src[i:src.index(end, i)]


def variants():
    """``{kernel: {variant: source text}}``."""
    fwd = (build.CSRC / "ring_flash_fwd.cu").read_text()
    bwd = (build.CSRC / "ring_flash_bwd.cu").read_text()
    no_fwd_loads = _cut(_cut(fwd, _FWD_LOADS), _FWD_EXPECT,
                        "mbar_arrive(&full[s]);")
    ds_math = _between(bwd, "            float x = fast_exp2(",
                       "          // 16-column block i / 2")
    dq = _between(bwd, "        // dQ = dS K for the tile's 64 queries",
                  "    if (tid == 0) bulk_wait();")
    dq = dq[:dq.rindex("      }\n    }")]
    return {
        "ring_flash_fwd": {
            "no_softmax": _cut(fwd, _FWD_SOFTMAX),
            "no_exp": _cut(fwd, _FWD_EXP, _FWD_EXP[len("fast_exp2("):-1]),
            "no_pv": _cut(fwd, _FWD_PV),
            "no_loads": no_fwd_loads,
            "skeleton": _cut(_cut(no_fwd_loads, _FWD_SOFTMAX),
                             _FWD_RESCALE),
        },
        "ring_flash_bwd": {
            "no_dq": _cut(bwd, dq),
            "no_ds": _cut(bwd, ds_math,
                          "            p[c] = st[4 * i + e + c];\n"
                          "            ds[c] = dpt[4 * i + e + c];\n"
                          "          }\n"),
            "no_loads": _cut(_cut(bwd, _BWD_LOADS), _BWD_EXPECT,
                             "mbar_arrive(&full[s]);"),
            "no_barrier": _cut(bwd, _BWD_BARRIER),
        },
    }


def _compile(kernel, name, text):
    STUDY_DIR.mkdir(parents=True, exist_ok=True)
    src = STUDY_DIR / f"{kernel}_{name}.cu"
    lib = STUDY_DIR / f"lib{kernel}_{name}.so"
    src.write_text(text)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    return lib


def _as_hop_lib(path, kernel):
    """A variant library with the argument types :mod:`ring_hop` sets."""
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, f"mxtpu_{kernel}")
    n_ptr, tail = rh._ARGTYPES[kernel]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong)] + tail
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mxtpu_ring_hop_error_string.argtypes = [ctypes.c_int]
    lib.mxtpu_ring_hop_error_string.restype = ctypes.c_char_p
    return lib


def _mean_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _notes(kernel):
    log = (build.BUILD_DIR / f"{kernel}.log").read_text()
    sass = subprocess.run(
        [str(Path(build.nvcc_path()).with_name("cuobjdump")), "-sass",
         str(build.library_path(kernel))], capture_output=True, text=True,
        check=True).stdout
    return dict(
        ptxas=[line.strip() for line in log.splitlines()
               if "Potential Performance Loss" in line
               or "registers" in line or "spill" in line],
        sass={op: sass.count(op) for op in SASS_OPS})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--seq", type=int, default=8192)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ring_hop_study needs a CUDA card")
    build.build([rh.KERNEL_FWD, rh.KERNEL_BWD])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (1, args.heads, args.seq, 64)
    q, k, v, do = (torch.randn(*shape, device=dev, generator=gen)
                   .bfloat16() for _ in range(4))
    acc = torch.zeros(shape, device=dev)
    lse = torch.zeros(shape[:3], device=dev)
    delta = torch.zeros(shape[:3], device=dev)
    sums = [torch.zeros(shape, device=dev) for _ in range(3)]
    calls = {
        rh.KERNEL_FWD: lambda: rh.ring_hop_fwd(q, k, v, acc, lse, False,
                                               0.125, False),
        rh.KERNEL_BWD: lambda: rh.ring_hop_bwd(q, k, v, do, lse, delta,
                                               *sums, False, 0.125),
    }
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    report = dict(shape=list(shape), causal=False, card=card, kernels={})
    own_lib = rh._lib
    try:
        for kernel, cuts in variants().items():
            libs = {name: _as_hop_lib(_compile(kernel, name, text), kernel)
                    for name, text in cuts.items()}
            times = {}
            for name, lib in libs.items():
                turns = []
                for side in ("kernel", name, name, "kernel"):
                    rh._lib = own_lib if side == "kernel" else (
                        lambda _kernel, lib=lib: lib)
                    turns.append((side, _mean_ms(calls[kernel])))
                times[name] = dict(
                    ms=[t for s, t in turns if s == name],
                    kernel_ms=[t for s, t in turns if s == "kernel"])
            rh._lib = own_lib
            report["kernels"][kernel] = dict(variants=times, **_notes(kernel))
    finally:
        rh._lib = own_lib
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
