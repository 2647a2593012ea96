"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source under ``mxnet_tpu_torch/csrc/`` with a
plain C interface. It is compiled by ``nvcc`` for ``sm_90a`` into a shared
library under ``build/kernels/`` at the repository root (listed in
``.gitignore``) and loaded with ``ctypes``. The library's file name carries
a digest of the source, the shared headers and the flags, so an edited
source rebuilds and an unchanged one is reused. :func:`build` starts one ``nvcc`` per source, all
at once. Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.

Each kernel wrapper also keeps a :class:`LaunchCounter`, which adds one
where the wrapper launches its kernel and nowhere else, so a run can show
that its main path went through the kernel. A launch captured in a CUDA
graph runs only when the graph replays, and a replay runs no Python: the
capture runs inside :func:`captured_counts`, which sends every count that
belongs to the capture (to any counter, and to the dispatch counts,
kernels/dispatch.py) into a tally, and the capturer adds the tally once
per replay with :func:`add_deltas`. A count belongs to the capture when
the stream it is launched on is capturing, whichever thread launches it
(autograd runs a captured backward on its own device thread); counts of
other streams go to the counters meanwhile (an engine serving on the same
card while another captures), so the counters stay the only count.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "library_path",
           "build", "load", "LaunchCounter", "COUNTERS", "counter",
           "reset_counters", "captured_counts", "capture_tally",
           "add_deltas"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}
_LOCK = threading.Lock()
#: the tally of the capture underway and the test that a count belongs
#: to it (captured_counts; one capture at a time: gluon/_graph.py)
_CAPTURE = [None, None]


def nvcc_path():
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on the PATH; raises when there is none."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels build only on a "
        "machine with the CUDA toolkit")


def _source(name):
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    return src


def library_path(name):
    """Where ``name``'s library lives for the current source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names):
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns ``{name: seconds}``
    for the ones built; raises with the compiler's output on a failure.
    The ptxas report (registers, shared memory, spills) is kept beside
    each library as ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name):
    """The loaded ``ctypes.CDLL`` of kernel ``name``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


class LaunchCounter:
    """Number of times a wrapper launched its kernel (thread-safe)."""

    def __init__(self, name):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n=1):
        tally = capture_tally()
        if tally is not None:          # launched into a graph being captured
            tally.count(tally, self, n)
            return
        with self._lock:
            self._n += n

    @property
    def value(self):
        return self._n

    def reset(self):
        with self._lock:
            self._n = 0


#: every kernel's launch counter, by kernel name
COUNTERS = {}


def counter(name):
    """The launch counter of kernel ``name`` (created on first use)."""
    with _LOCK:
        return COUNTERS.setdefault(name, LaunchCounter(name))


def reset_counters():
    for c in COUNTERS.values():
        c.reset()


class _Tally(dict):
    """What one capture added: ``{LaunchCounter: n}`` as a dict, and the
    dispatch decisions ``{(kernel, outcome): n}`` in ``decisions``."""

    def __init__(self):
        super().__init__()
        self.decisions = {}
        self._lock = threading.Lock()

    def count(self, table, key, n):
        """Add ``n`` to ``table[key]`` (this tally or its decisions): the
        capturing thread and autograd's may both count."""
        with self._lock:
            table[key] = table.get(key, 0) + n


def capture_tally():
    """The open :func:`captured_counts` tally when a count made here and
    now belongs to it, else None."""
    tally, belongs = _CAPTURE
    if tally is not None and belongs():
        return tally
    return None


def _stream_capturing():
    import torch

    return torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def captured_counts(belongs=_stream_capturing):
    """Inside, every count for which ``belongs()`` holds (by default: the
    calling thread's current CUDA stream is capturing) goes into the
    yielded tally instead of the counters and kernels/dispatch.py's
    counts: for a CUDA-graph capture, whose launches run only when it
    replays. One at a time."""
    if _CAPTURE[0] is not None:
        raise RuntimeError("captured_counts is already open")
    tally = _Tally()
    _CAPTURE[:] = [tally, belongs]
    try:
        yield tally
    finally:
        _CAPTURE[:] = [None, None]


def add_deltas(tally):
    """Add a :func:`captured_counts` tally to the counters and the dispatch
    counts: one replay."""
    for c, n in tally.items():
        c.add(n)
    if tally.decisions:
        from . import dispatch

        dispatch.add_counts(tally.decisions)
