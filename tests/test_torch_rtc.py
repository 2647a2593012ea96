"""``mx.rtc`` of the port on the CPU: the plain version (``PallasModule``)
against the JAX package's ``PallasModule``, which runs its body through
``pl.pallas_call`` in interpret mode here (mxnet_tpu/rtc.py:58-62), and the
parts of ``CudaModule`` that need no card: signature parsing, argument
checks, the cubin's symbol table, and the errors raised where there is no
card or no nvcc. The kernels themselves run in
``tests/test_torch_cuda_rtc.py`` and ``chip_smoke.py``.
"""
import ctypes
import glob

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.rtc as jrtc
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError


def add_one(x_ref, o_ref):
    o_ref[...] = x_ref[...] + 1.0


def fma_two(x_ref, y_ref, o_ref):
    o_ref[...] = x_ref[...] * y_ref[...] + 2.0


@pytest.mark.parametrize("body,n_in", [(add_one, 1), (fma_two, 2)])
def test_pallas_module_matches_the_jax_pallas_module(body, n_in):
    r = onp.random.RandomState(1)
    xs = [r.standard_normal((2, 8, 128)).astype("f") for _ in range(n_in)]
    jk = jrtc.PallasModule({body.__name__: body}).get_kernel(body.__name__)
    jout = jk.launch([jmx.np.array(x) for x in xs], out_shape=(2, 8, 128))
    tk = rtc.PallasModule(body).get_kernel(body.__name__)
    with mt.cpu():
        targs = [mt.np.array(x) for x in xs]
    tout = tk.launch(targs, out_shape=(2, 8, 128))
    assert isinstance(tout, mt.NDArray) and tout.dtype == onp.float32
    # XLA contracts x * y + 2 into one FMA, which skips the product's
    # rounding: one ulp of the 2.0 added (2.4e-7) where the sum nears zero
    onp.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=1e-6,
                                atol=2.5e-7)
    # the inputs are untouched, and the launch recorded nothing
    onp.testing.assert_array_equal(targs[0].asnumpy(), xs[0])
    with mt.autograd.record():
        assert not tk.launch(targs, out_shape=(2, 8, 128))._data.requires_grad


def test_missing_kernels_raise_key_error_naming_what_is_there():
    mod = rtc.PallasModule({"add_one": add_one})
    with pytest.raises(KeyError, match="add_one"):
        mod.get_kernel("missing")
    cmod = object.__new__(rtc.CudaModule)   # a module whose build is done
    cmod.kernels = ["axpy", "row_sum_bf16"]
    with pytest.raises(KeyError, match="row_sum_bf16"):
        cmod.get_kernel("axpy2", "float *y")
    assert cmod.get_kernel("axpy", "float *y").name == "axpy"


def test_signatures_parse_into_ctypes_and_dtypes():
    sig = rtc.parse_signature(
        "const float *x, float* __restrict__ y, float alpha, int n, "
        "long long offset, const __half *h, __nv_bfloat16 *b, "
        "unsigned int u, double d, int64_t *idx, uint8_t *mask")
    got = [(a.name, a.pointer, a.const, a.dtype, a.scalar) for a in sig]
    assert got == [
        ("x", True, True, torch.float32, ctypes.c_float),
        ("y", True, False, torch.float32, ctypes.c_float),
        ("alpha", False, False, torch.float32, ctypes.c_float),
        ("n", False, False, torch.int32, ctypes.c_int32),
        ("offset", False, False, torch.int64, ctypes.c_int64),
        ("h", True, True, torch.float16, None),
        ("b", True, False, torch.bfloat16, None),
        ("u", False, False, None, ctypes.c_uint32),
        ("d", False, False, torch.float64, ctypes.c_double),
        ("idx", True, False, torch.int64, ctypes.c_int64),
        ("mask", True, False, torch.uint8, ctypes.c_uint8),
    ]
    assert [a.name for a in rtc.parse_signature("float*, int")] == \
        ["arg0", "arg1"]
    for bad in ("float **p", "float x[]", "complex z", "__half h",
                "int a b"):
        with pytest.raises(ValueError):
            rtc.parse_signature(bad)


def test_launch_checks_every_argument_before_touching_the_card():
    k = rtc.CudaKernel(None, "axpy", "const float *x, float *y, float alpha, "
                                     "int n")
    with mt.cpu():
        x, y = mt.np.ones((8,)), mt.np.zeros((8,))
        xi = mt.np.ones((8,), dtype="int32")
    cuda = torch.device("cuda", 0)
    before = rtc.LAUNCHES.value
    with pytest.raises(MXNetError, match="CUDA device"):
        k.launch([x, y, 2.0, 8], mt.cpu(), (1,), (8,))
    with pytest.raises(ValueError, match="takes 4 arguments"):
        k.launch([x, y, 2.0], cuda, (1,), (8,))
    with pytest.raises(TypeError, match="torch.float32"):
        k.launch([xi, y, 2.0, 8], cuda, (1,), (8,))
    with pytest.raises(TypeError, match="NDArray"):
        k.launch([x.asnumpy(), y, 2.0, 8], cuda, (1,), (8,))
    with pytest.raises(TypeError, match="scalar"):
        k.launch([x, y, x, 8], cuda, (1,), (8,))
    with pytest.raises(TypeError, match="integer"):
        k.launch([x, y, 2.0, 8.0], cuda, (1,), (8,))
    with pytest.raises(ValueError, match="is on cpu"):
        k.launch([x, y, 2.0, 8], cuda, (1,), (8,))
    with pytest.raises(ValueError, match="contiguous"):
        rtc.CudaKernel(None, "k", "float *y")._marshal(
            [mt.np.zeros((4, 4), device="cpu").T], torch.device("cpu"))
    assert rtc.LAUNCHES.value == before   # nothing was launched


def test_cuda_module_raises_without_a_card_or_without_nvcc(monkeypatch,
                                                           tmp_path):
    src = 'extern "C" __global__ void k(float *y) { y[0] = 1.f; }'
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA card"):
            rtc.CudaModule(src)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(rtc, "RTC_DIR", tmp_path / "rtc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rtc.CudaModule(src)


def test_pallas_module_refuses_a_grid_and_block_specs():
    k = rtc.PallasModule(add_one).get_kernel("add_one")
    x = mt.np.ones((4,), device="cpu")
    with pytest.raises(NotImplementedError, match="grid"):
        k.launch([x], out_shape=(4,), grid=(2,))
    with pytest.raises(NotImplementedError, match="BlockSpecs"):
        k.launch([x], out_shape=(4,), in_specs=[None])


def test_kernel_names_read_an_elf_symbol_table():
    so = sorted(glob.glob(onp.__path__[0] + "/_core/_multiarray_umath*.so")
                + glob.glob(onp.__path__[0] + "/core/_multiarray_umath*.so"))
    names = rtc.kernel_names(open(so[0], "rb").read())
    assert "PyInit__multiarray_umath" in names
    with pytest.raises(ValueError, match="ELF"):
        rtc.kernel_names(b"not an elf image")
