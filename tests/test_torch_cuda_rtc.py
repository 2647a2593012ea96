"""``mx.rtc.CudaModule`` (K7) on the card: user CUDA C++ compiled at run
time for ``sm_90a`` and launched on ``mx.np`` arrays, each kernel held
against its plain PyTorch version at small sizes; refused launches, dynamic
shared memory above 48 KB, a launch from a fresh thread, and the checks
that keep a raw launch away from autograd. Marked ``cuda``; every test
skips without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_rtc.py
"""
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import rtc

AXPY = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] += alpha * x[i];
}
"""

ROW_SUM = r"""
#include <cuda_bf16.h>
extern "C" __global__ void row_sum_bf16(const __nv_bfloat16 *x, float *out,
                                        int cols) {
    extern __shared__ float warp_sums[];
    const __nv_bfloat16 *row = x + (long long)blockIdx.x * cols;
    float s = 0.f;
    if ((cols & 7) == 0 && (reinterpret_cast<unsigned long long>(x) & 15) == 0) {
        for (int c = threadIdx.x * 8; c < cols; c += blockDim.x * 8) {
            uint4 v = *reinterpret_cast<const uint4 *>(row + c);
            const __nv_bfloat16 *h = reinterpret_cast<const __nv_bfloat16 *>(&v);
            for (int k = 0; k < 8; ++k) s += __bfloat162float(h[k]);
        }
    } else {
        for (int c = threadIdx.x; c < cols; c += blockDim.x)
            s += __bfloat162float(row[c]);
    }
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
    int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) warp_sums[warp] = s;
    __syncthreads();
    if (warp == 0) {
        s = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
        for (int off = 16; off > 0; off >>= 1)
            s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) out[blockIdx.x] = s;
    }
}

extern "C" __global__ void tile_reverse(const float *x, float *y, int tile) {
    extern __shared__ float buf[];
    const float *src = x + (long long)blockIdx.x * tile;
    float *dst = y + (long long)blockIdx.x * tile;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) buf[i] = src[i];
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += blockDim.x)
        dst[i] = buf[tile - 1 - i];
}
"""

STRIDED = r"""
#include <cuda_fp16.h>
extern "C" __global__ void strided_scale_half(const __half *x, __half *y,
                                              float scale, int n, int stride,
                                              long long offset) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n)
        y[i] = __float2half(scale * __half2float(x[offset + (long long)i * stride]));
}
"""

F32_EPS = 2.0 ** -23


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CudaModule compiles and launches "
                    "there only")
    return torch.device("cuda", 0)


def _arr(a, dev, dtype=None):
    return mt.np.array(a, dtype=dtype or a.dtype, device=dev)


@pytest.mark.cuda
def test_axpy_matches_its_plain_version(dev):
    k = rtc.CudaModule(AXPY, exports=["axpy"]).get_kernel(
        "axpy", "const float *x, float *y, float alpha, int n")
    r = onp.random.RandomState(0)
    n = 100_003                                   # a ragged last block
    xv, yv = r.standard_normal(n).astype("f"), r.uniform(size=n).astype("f")
    x, y = _arr(xv, dev), _arr(yv, dev)
    before, v0 = rtc.LAUNCHES.value, y._version
    k.launch([x, y, 2.5, n], dev, ((n + 255) // 256,), (256,))
    torch.cuda.synchronize()
    assert rtc.LAUNCHES.value == before + 1 and y._version == v0 + 1
    want = torch.from_numpy(yv) + 2.5 * torch.from_numpy(xv)
    # nvcc contracts y + a*x into one FMA: 2 ulps of the largest value
    err = (y._data.cpu() - want).abs().max().item()
    assert err <= 2 * F32_EPS * want.abs().max().item()
    onp.testing.assert_array_equal(x.asnumpy(), xv)   # const: untouched


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(300, 1024), (7, 1000)])
def test_row_sum_matches_its_plain_version(dev, rows, cols):
    mod = rtc.CudaModule(ROW_SUM, exports=("row_sum_bf16", "tile_reverse"))
    k = mod.get_kernel("row_sum_bf16",
                       "const __nv_bfloat16 *x, float *out, int cols")
    x = mt.np.random.normal(size=(rows, cols), dtype="bfloat16", device=dev)
    out = mt.np.zeros((rows,), device=dev)
    k.launch([x, out, cols], dev, (rows,), (128,), shared_mem=16)
    again = mt.np.zeros((rows,), device=dev)
    k.launch([x, again, cols], dev, (rows,), (128,), shared_mem=16)
    want = x._data.float().sum(1)
    torch.cuda.synchronize()
    # f32 sums of bf16 values in two fixed orders: 1e-5 of the row's |x|
    tol = 1e-5 * x._data.float().abs().sum(1).max().item()
    assert (out._data - want).abs().max().item() <= tol
    assert torch.equal(out._data, again._data)    # the same bits each run


@pytest.mark.cuda
def test_int_long_long_and_half_arguments(dev):
    k = rtc.CudaModule(STRIDED).get_kernel(
        "strided_scale_half", "const __half *x, __half *y, float scale, "
                              "int n, int stride, long long offset")
    n, stride, offset = 4096, 3, 12345
    x = mt.np.random.normal(size=(offset + n * stride,), dtype="float16",
                            device=dev)
    y = mt.np.zeros((n,), dtype="float16", device=dev)
    k.launch([x, y, 0.75, n, stride, offset], dev, ((n + 255) // 256,),
             (256,))
    want = (x._data[offset::stride][:n].float() * 0.75).half()
    torch.cuda.synchronize()
    assert torch.equal(y._data, want)             # one rounding both sides


@pytest.mark.cuda
def test_refused_launches_raise_with_cuda_error_strings(dev):
    mod = rtc.CudaModule(ROW_SUM)
    axpy = rtc.CudaModule(AXPY).get_kernel(
        "axpy", "const float *x, float *y, float alpha, int n")
    x, y = mt.np.ones((4096,), device=dev), mt.np.zeros((4096,), device=dev)
    before = rtc.LAUNCHES.value
    with pytest.raises(mt.MXNetError, match="CUDA_ERROR"):
        axpy.launch([x, y, 1.0, 4096], dev, (2,), (2048,))
    rev = mod.get_kernel("tile_reverse", "const float *x, float *y, int tile")
    tile = 16384                                  # 64 KB of floats
    tx = mt.np.random.uniform(size=(4 * tile,), device=dev)
    ty = mt.np.zeros((4 * tile,), device=dev)
    with pytest.raises(mt.MXNetError, match="CUDA_ERROR"):
        rev.launch([tx, ty, tile], dev, (4,), (1024,), shared_mem=4 * tile)
    assert rtc.LAUNCHES.value == before
    rev.set_max_dynamic_shared_memory(4 * tile)
    rev.launch([tx, ty, tile], dev, (4,), (1024,), shared_mem=4 * tile)
    torch.cuda.synchronize()
    assert torch.equal(ty._data, tx._data.view(4, -1).flip(1).reshape(-1))
    with pytest.raises(KeyError, match="tile_reverse"):
        rtc.CudaModule(ROW_SUM, exports=["row_sum"])


@pytest.mark.cuda
def test_a_fresh_thread_launches_in_torchs_primary_context(dev):
    k = rtc.CudaModule(AXPY).get_kernel(
        "axpy", "const float *x, float *y, float alpha, int n")
    x, y = mt.np.ones((256,), device=dev), mt.np.zeros((256,), device=dev)
    errors = []

    def work():
        try:
            k.launch([x, y, 3.0, 256], dev, (1,), (256,))
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - handed to the main thread
            errors.append(e)

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and errors == []
    onp.testing.assert_array_equal(y.asnumpy(), onp.full(256, 3.0, "f"))


@pytest.mark.cuda
def test_nothing_falls_back_and_autograd_is_kept_out(dev):
    k = rtc.CudaModule(AXPY).get_kernel(
        "axpy", "const float *x, float *y, float alpha, int n")
    x, y = mt.np.ones((256,), device=dev), mt.np.zeros((256,), device=dev)
    with pytest.raises(ValueError, match="is on cpu"):
        k.launch([x.as_in_ctx(mt.cpu()), y, 1.0, 256], dev, (1,), (256,))
    add_one = rtc.PallasModule(
        {"add_one": lambda x_ref, o_ref: None}).get_kernel("add_one")
    with pytest.raises(mt.MXNetError, match="CudaModule"):
        add_one.launch([x], out_shape=(256,))
    y.attach_grad()
    with mt.autograd.record():
        with pytest.raises(mt.MXNetError, match="requires a gradient"):
            k.launch([x, y, 1.0, 256], dev, (1,), (256,))
