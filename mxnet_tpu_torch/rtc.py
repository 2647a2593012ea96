"""Runtime-compiled CUDA kernels launched on NDArrays (counterpart of
mxnet_tpu/rtc.py, K7; the API is MXNet's ``rtc.CudaModule``).

The JAX package's ``PallasModule`` compiles a user's kernel body per
(out_shape, out_dtype, grid) with ``pl.pallas_call`` (rtc.py:65) and keeps
``CudaModule`` only as a guard (:20-30). On this card the native body is
CUDA C++, so here :class:`CudaModule` works:

* **build**: ``nvcc -cubin -gencode arch=compute_90a,code=sm_90a`` plus the
  user's ``options``, cached by a digest of the source, the options and the
  flags under ``build/kernels/rtc/`` (listed in ``.gitignore``). nvcc, not
  NVRTC: the CUDA toolkit the port builds its own kernels with is the one
  dependency, and a cached cubin skips the compiler on a second run;
* **load and launch**: the CUDA driver API through ``ctypes`` on
  ``libcuda.so.1`` (``cuModuleLoadData``, ``cuModuleGetFunction``,
  ``cuLaunchKernel``) in torch's primary context, on torch's current
  stream. Every ``CUresult`` is checked; a refused launch raises with the
  text of ``cuGetErrorName`` and ``cuGetErrorString``;
* **kernels**: ``extern "C"`` names, read from the cubin's symbol table;
  an export or kernel that is not there raises with the names that are.

:meth:`CudaKernel.launch` checks each argument against the signature
(pointer or scalar, dtype, device, contiguity), writes into the NDArrays it
is given, as MXNet's does, and runs outside autograd: an output that
requires a gradient inside ``autograd.record()`` raises, and every written
tensor gets its autograd version bumped. Each launch adds one to the
``rtc`` launch counter.

:class:`PallasModule` is the plain version: the user's body run over CPU
tensors standing in for the refs (``o_ref[...] = x_ref[...] + 1.0`` runs
as written), with ``grid=None`` only. On CUDA arrays it raises and names
:class:`CudaModule`; :class:`CudaModule` on CPU arrays raises too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import struct
import subprocess
import threading
import time

import numpy as _np
import torch

from . import autograd as _ag
from .base import MXNetError, normalize_dtype
from .kernels import build as _build
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "PallasKernel",
           "parse_signature", "kernel_names", "LAUNCHES", "RTC_DIR"]

KERNEL = "rtc"
#: launches of user kernels through CudaKernel.launch
LAUNCHES = _build.counter(KERNEL)
RTC_DIR = _build.BUILD_DIR / "rtc"
TARGET = (9, 0)
NVCC_FLAGS = ("-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17")

# the signature's C types: (torch dtype of a pointer's data, ctypes scalar)
_CTYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, None), "half": (torch.float16, None),
    "__nv_bfloat16": (torch.bfloat16, None),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "unsigned int": (None, ctypes.c_uint32),
    "uint32_t": (None, ctypes.c_uint32),
    "long long": (torch.int64, ctypes.c_int64),
    "int64_t": (torch.int64, ctypes.c_int64),
    "unsigned long long": (None, ctypes.c_uint64),
    "uint64_t": (None, ctypes.c_uint64),
    "char": (torch.int8, ctypes.c_int8), "int8_t": (torch.int8, ctypes.c_int8),
    "unsigned char": (torch.uint8, ctypes.c_uint8),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "bool": (torch.bool, ctypes.c_bool),
}
_QUALIFIERS = {"const", "__restrict__", "restrict", "volatile"}


class Arg:
    """One parameter of a kernel's signature."""

    __slots__ = ("name", "ctype", "pointer", "const", "dtype", "scalar")

    def __init__(self, name, ctype, pointer, const):
        if ctype not in _CTYPES:
            raise ValueError(f"unsupported type {ctype!r} in a kernel "
                             f"signature; supported: {sorted(_CTYPES)}")
        self.name, self.ctype = name, ctype
        self.pointer, self.const = pointer, const
        self.dtype, self.scalar = _CTYPES[ctype]
        if pointer and self.dtype is None:
            raise ValueError(f"no tensor dtype for a pointer to {ctype!r}")
        if not pointer and self.scalar is None:
            raise ValueError(f"a {ctype!r} scalar argument is not supported; "
                             "pass it as float or through a pointer")

    def __repr__(self):
        return (f"{'const ' if self.const else ''}{self.ctype}"
                f"{' *' if self.pointer else ' '}{self.name}")


def parse_signature(signature):
    """The kernel's parameters from a C signature such as ``"const float
    *x, float *y, float alpha, int n"`` (MXNet's ``get_kernel``): types of
    :data:`_CTYPES`, each a scalar or a pointer, names optional."""
    args = []
    for i, part in enumerate(p for p in signature.split(",") if p.strip()):
        if not re.fullmatch(r"[\s\w*]+", part):
            raise ValueError(f"cannot parse kernel argument {part.strip()!r}")
        tokens = re.findall(r"\*|[A-Za-z_]\w*", part)
        const = "const" in tokens
        pointer = tokens.count("*")
        if pointer > 1:
            raise ValueError(f"argument {part.strip()!r}: pointers to "
                             "pointers are not supported")
        words = [t for t in tokens if t != "*" and t not in _QUALIFIERS]
        for n in (3, 2, 1):
            if len(words) >= n and " ".join(words[:n]) in _CTYPES:
                ctype, rest = " ".join(words[:n]), words[n:]
                break
        else:
            raise ValueError(f"unsupported type in kernel argument "
                             f"{part.strip()!r}; supported: {sorted(_CTYPES)}")
        if len(rest) > 1:
            raise ValueError(f"cannot parse kernel argument {part.strip()!r}")
        args.append(Arg(rest[0] if rest else f"arg{i}", ctype, bool(pointer),
                        const))
    return args


def kernel_names(elf):
    """The global function symbols of an ELF image (a cubin's kernels)."""
    if elf[:4] != b"\x7fELF" or elf[4] != 2:
        raise ValueError("not a 64-bit ELF image")
    shoff = struct.unpack_from("<Q", elf, 0x28)[0]
    shentsize, shnum = struct.unpack_from("<HH", elf, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", elf, shoff + i * shentsize)
                for i in range(shnum)]
    names = set()
    for _, sh_type, _, _, off, size, link, _, _, entsize in sections:
        if sh_type not in (2, 11):      # SHT_SYMTAB, SHT_DYNSYM
            continue
        str_off = sections[link][4]
        for sym in range(off, off + size, entsize or 24):
            st_name, st_info, _, st_shndx = struct.unpack_from("<IBBH", elf,
                                                               sym)
            if st_info & 0xF == 2 and st_info >> 4 == 1 and st_shndx:
                end = elf.index(b"\0", str_off + st_name)
                names.add(elf[str_off + st_name:end].decode())
    return sorted(names)


# -- the CUDA driver API ----------------------------------------------------------

_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8


class _Driver:
    """``libcuda.so.1`` through ctypes: the calls this module makes, each
    with its argument types declared (pointers and handles 64 bits)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        vp, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        pvp, pi32 = ctypes.POINTER(vp), ctypes.POINTER(i32)
        decl = {
            "cuInit": [u32],
            "cuDeviceGet": [pi32, i32],
            "cuCtxGetCurrent": [pvp],
            "cuCtxSetCurrent": [vp],
            "cuDevicePrimaryCtxRetain": [pvp, i32],
            "cuModuleLoadData": [pvp, vp],
            "cuModuleGetFunction": [pvp, vp, ctypes.c_char_p],
            "cuFuncSetAttribute": [vp, i32, i32],
            "cuLaunchKernel": [vp, u32, u32, u32, u32, u32, u32, u32, vp,
                               pvp, pvp],
            "cuGetErrorName": [i32, ctypes.POINTER(ctypes.c_char_p)],
            "cuGetErrorString": [i32, ctypes.POINTER(ctypes.c_char_p)],
        }
        for name, argtypes in decl.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib = lib
        self.check(lib.cuInit(0), "cuInit")
        self._primary = {}

    @classmethod
    def get(cls):
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def check(self, res, what):
        if res:
            name, text = ctypes.c_char_p(), ctypes.c_char_p()
            self.lib.cuGetErrorName(res, ctypes.byref(name))
            self.lib.cuGetErrorString(res, ctypes.byref(text))
            raise MXNetError(
                f"{what} failed: {(name.value or b'?').decode()} ({res}): "
                f"{(text.value or b'unknown error').decode()}")

    def context(self, index):
        """Make torch's primary context of card ``index`` current on this
        thread (a fresh thread has none until torch or this call sets it),
        or raise."""
        with self._lock:
            primary = self._primary.get(index)
            if primary is None:
                dev = ctypes.c_int()
                self.check(self.lib.cuDeviceGet(ctypes.byref(dev), index),
                           "cuDeviceGet")
                primary = ctypes.c_void_p()
                self.check(self.lib.cuDevicePrimaryCtxRetain(
                    ctypes.byref(primary), dev), "cuDevicePrimaryCtxRetain")
                self._primary[index] = primary
        cur = ctypes.c_void_p()
        self.check(self.lib.cuCtxGetCurrent(ctypes.byref(cur)),
                   "cuCtxGetCurrent")
        if cur.value != primary.value:
            self.check(self.lib.cuCtxSetCurrent(primary), "cuCtxSetCurrent")
            self.check(self.lib.cuCtxGetCurrent(ctypes.byref(cur)),
                       "cuCtxGetCurrent")
            if cur.value != primary.value:
                raise MXNetError(f"could not make the primary context of "
                                 f"cuda:{index} current")


def _compile(source, options):
    """The cubin of ``source`` (bytes) and the seconds nvcc took (0.0 when
    the cache had it)."""
    flags = NVCC_FLAGS + tuple(options)
    h = hashlib.sha256(source.encode())
    h.update("\0".join(flags).encode())
    digest = h.hexdigest()[:20]
    cubin = RTC_DIR / f"{digest}.cubin"
    if cubin.is_file():
        return cubin.read_bytes(), 0.0
    nvcc = _build.nvcc_path()
    RTC_DIR.mkdir(parents=True, exist_ok=True)
    # files of this process and thread only: another may build the same
    # source at the same time
    tag = f"{digest}.{os.getpid()}.{threading.get_ident()}"
    src, tmp = RTC_DIR / f"{tag}.cu", RTC_DIR / f"{tag}.tmp"
    src.write_text(source)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    src.unlink()
    (RTC_DIR / f"{digest}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise MXNetError(f"nvcc exited {proc.returncode} compiling the "
                         f"CudaModule source:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, cubin)
    return cubin.read_bytes(), seconds


class CudaModule:
    """CUDA C++ compiled for ``sm_90a`` (MXNet's ``rtc.CudaModule``).

    Example, MXNet's own::

        source = r'''
        extern "C" __global__ void axpy(const float *x, float *y,
                                        float alpha) {
            int i = threadIdx.x + blockIdx.x * blockDim.x;
            y[i] += alpha * x[i];
        }'''
        module = mx.rtc.CudaModule(source)
        func = module.get_kernel("axpy", "const float *x, float *y, "
                                         "float alpha")
        x = mx.np.ones((10,), ctx=mx.gpu(0))
        y = mx.np.zeros((10,), ctx=mx.gpu(0))
        func.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
    """

    def __init__(self, source, options=(), exports=()):
        if not torch.cuda.is_available():
            raise MXNetError(
                "CudaModule compiles for and launches on a CUDA card, and "
                "none is available; PallasModule runs a kernel body over "
                "CPU tensors")
        if isinstance(options, str):
            options = (options,)
        self.source = source
        self.options = tuple(options)
        self.cubin, self.build_seconds = _compile(source, self.options)
        self.kernels = kernel_names(self.cubin)
        missing = [e for e in ([exports] if isinstance(exports, str)
                               else exports) if e not in self.kernels]
        if missing:
            raise KeyError(f"exports {missing} are not kernels of this "
                           f"module; it has {self.kernels} (declare kernels "
                           f"extern \"C\")")
        self._loaded = {}
        self._lock = threading.Lock()

    def get_kernel(self, name, signature):
        """The kernel ``name`` with its C ``signature``."""
        if name not in self.kernels:
            raise KeyError(f"no kernel {name!r} in this module; it has "
                           f"{self.kernels} (declare kernels extern \"C\")")
        return CudaKernel(self, name, signature)

    def _module(self, index):
        """The module loaded into card ``index``'s primary context."""
        with self._lock:
            mod = self._loaded.get(index)
            if mod is None:
                cap = torch.cuda.get_device_capability(index)
                if cap != TARGET:
                    raise MXNetError(
                        f"the module is compiled for sm_90a; cuda:{index} "
                        f"is sm_{cap[0]}{cap[1]}")
                drv = _Driver.get()
                drv.context(index)
                mod = ctypes.c_void_p()
                drv.check(drv.lib.cuModuleLoadData(ctypes.byref(mod),
                                                   self.cubin),
                          "cuModuleLoadData")
                self._loaded[index] = mod
            return mod


class CudaKernel:
    """One kernel of a :class:`CudaModule` (MXNet's ``CudaKernel``)."""

    def __init__(self, module, name, signature):
        self.module = module
        self.name = name
        self.signature = parse_signature(signature)
        self._functions = {}
        self._max_dynamic_smem = None

    def __repr__(self):
        return f"CudaKernel({self.name}({', '.join(map(repr, self.signature))}))"

    def set_max_dynamic_shared_memory(self, nbytes):
        """Let launches take up to ``nbytes`` of dynamic shared memory
        (above 48 KB a kernel must opt in:
        ``CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES``)."""
        self._max_dynamic_smem = int(nbytes)
        for index, func in self._functions.items():
            self._apply_smem(index, func)

    def _apply_smem(self, index, func):
        drv = _Driver.get()
        drv.context(index)
        drv.check(drv.lib.cuFuncSetAttribute(
            func, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
            self._max_dynamic_smem), "cuFuncSetAttribute")

    def _function(self, index):
        func = self._functions.get(index)
        if func is None:
            mod = self.module._module(index)
            drv = _Driver.get()
            func = ctypes.c_void_p()
            drv.check(drv.lib.cuModuleGetFunction(
                ctypes.byref(func), mod, self.name.encode()),
                f"cuModuleGetFunction({self.name})")
            if self._max_dynamic_smem is not None:
                self._apply_smem(index, func)
            self._functions[index] = func
        return func

    def _marshal(self, args, device):
        """The ctypes values of ``args`` and the NDArrays written. Every
        argument is checked against the signature (kind, dtype), then each
        array's device and layout."""
        if len(args) != len(self.signature):
            raise ValueError(f"{self.name} takes {len(self.signature)} "
                             f"arguments ({self.signature}), got {len(args)}")
        for spec, arg in zip(self.signature, args):
            if spec.pointer:
                if not isinstance(arg, NDArray):
                    raise TypeError(f"{self.name}: argument {spec!r} takes an "
                                    f"NDArray, got {type(arg).__name__}")
                if arg._data.dtype != spec.dtype:
                    raise TypeError(f"{self.name}: argument {spec!r} takes "
                                    f"{spec.dtype}, got {arg._data.dtype}")
            elif isinstance(arg, (NDArray, torch.Tensor, _np.ndarray)):
                raise TypeError(f"{self.name}: argument {spec!r} is a scalar, "
                                "got an array")
            elif spec.ctype in ("float", "double"):
                if not isinstance(arg, (int, float, _np.number)):
                    raise TypeError(f"{self.name}: argument {spec!r} takes a "
                                    f"number, got {arg!r}")
            elif not isinstance(arg, (int, _np.integer)) \
                    or isinstance(arg, bool) != (spec.ctype == "bool"):
                raise TypeError(f"{self.name}: argument {spec!r} takes an "
                                f"integer, got {arg!r}")
        values, written = [], []
        for spec, arg in zip(self.signature, args):
            if not spec.pointer:
                values.append(spec.scalar(float(arg) if spec.ctype in (
                    "float", "double") else int(arg)))
                continue
            t = arg._data
            if t.device != device:
                raise ValueError(
                    f"{self.name}: argument {spec!r} is on {t.device}, the "
                    f"launch on {device}; CudaModule launches on CUDA arrays "
                    "only (PallasModule runs CPU arrays)")
            if not t.is_contiguous():
                raise ValueError(f"{self.name}: argument {spec!r} is not "
                                 "contiguous")
            if not spec.const:
                if _ag.is_recording() and t.requires_grad:
                    raise MXNetError(
                        f"{self.name}: argument {spec!r} requires a gradient "
                        "inside autograd.record(); a raw kernel writes "
                        "outside autograd")
                written.append(arg)
            values.append(ctypes.c_void_p(t.data_ptr()))   # 64-bit pointer
        return values, written

    def launch(self, args, device, grid_dims, block_dims, shared_mem=0):
        """Launch on ``device`` (a CUDA device) over ``grid_dims`` blocks of
        ``block_dims`` threads with ``shared_mem`` bytes of dynamic shared
        memory, on torch's current stream; no synchronisation."""
        device = torch.device(device)
        if device.type != "cuda":
            raise MXNetError(
                f"CudaKernel.launch runs on a CUDA device, not {device}; "
                "PallasModule runs a kernel body over CPU arrays")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        values, written = self._marshal(args, device)
        dims = []
        for what, d in (("grid_dims", grid_dims), ("block_dims", block_dims)):
            d = tuple(int(v) for v in d)
            if not 1 <= len(d) <= 3 or min(d) < 1:
                raise ValueError(f"{what} must be 1 to 3 positive ints, "
                                 f"got {d}")
            dims += list(d) + [1] * (3 - len(d))
        params = (ctypes.c_void_p * max(len(values), 1))(
            *[ctypes.addressof(v) for v in values])
        drv = _Driver.get()
        with torch.cuda.device(device):
            drv.context(device.index)
            func = self._function(device.index)
            stream = torch.cuda.current_stream(device).cuda_stream
            drv.check(drv.lib.cuLaunchKernel(
                func, *dims, int(shared_mem), ctypes.c_void_p(stream),
                params, None), f"cuLaunchKernel({self.name})")
        LAUNCHES.add()
        for arr in written:
            arr._version += 1
            torch.autograd.graph.increment_version(arr._data)


class PallasKernel:
    """The plain version of a kernel: the user's Pallas-style body run over
    CPU tensors standing in for the refs (rtc.py:PallasKernel)."""

    def __init__(self, body, name):
        self._body = body
        self.name = name

    def launch(self, args, out_shape, out_dtype="float32", grid=None,
               **pallas_kwargs):
        """Run the body once over the whole arrays and return the output,
        outside autograd. A ``grid`` or BlockSpecs raise."""
        if grid is not None or pallas_kwargs:
            raise NotImplementedError(
                "PallasKernel.launch runs the body once over whole arrays: "
                "grid= and BlockSpecs are not ported")
        tensors = []
        for a in args:
            t = a._data if isinstance(a, NDArray) else torch.as_tensor(
                _np.asarray(a))
            if t.is_cuda:
                raise MXNetError(
                    f"PallasModule kernel {self.name!r} got an array on "
                    f"{t.device}: on the card, compile CUDA C++ with "
                    "mx.rtc.CudaModule")
            tensors.append(t.detach())
        out = torch.zeros(tuple(out_shape), dtype=normalize_dtype(out_dtype))
        with torch.no_grad():
            self._body(*tensors, out)
        return NDArray(out)


class PallasModule:
    """Named kernel bodies, each run by :class:`PallasKernel` (rtc.py:78).

    Example::

        def add_one(x_ref, o_ref):
            o_ref[...] = x_ref[...] + 1.0
        k = mx.rtc.PallasModule({"add_one": add_one}).get_kernel("add_one")
        y = k.launch([x], out_shape=x.shape)
    """

    def __init__(self, kernels):
        if callable(kernels):
            kernels = {kernels.__name__: kernels}
        self._kernels = dict(kernels)

    def get_kernel(self, name, signature=None):  # noqa: ARG002 - the API's
        if name not in self._kernels:
            raise KeyError(f"no kernel {name!r}; have {sorted(self._kernels)}")
        return PallasKernel(self._kernels[name], name)
