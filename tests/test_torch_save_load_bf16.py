"""``mx.nd.save`` / ``mx.nd.load`` of bfloat16 between the JAX package and
the PyTorch port, on the CPU: the npz dtype codec (``__mx_npz_dtypes__``
sidecar, bf16 stored as its uint16 bits) read and written by both, bit for
bit, without ml_dtypes on the port's side. Files with no exotic array stay
plain npz files whose members are the bytes ``np.savez`` writes.
"""
import zipfile

import ml_dtypes
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dtype_codec as codec


def _bf16(seed, shape):
    """bf16 values from a seed, with inf, -inf, a NaN and -0 among them."""
    r = onp.random.RandomState(seed)
    a = (r.randn(*shape) * 3).astype(ml_dtypes.bfloat16)
    flat = a.reshape(-1)
    flat[:4] = onp.array([onp.inf, -onp.inf, onp.nan, -0.0],
                         dtype=ml_dtypes.bfloat16)
    return a


def _bits(t):
    return t.view(torch.int16).numpy()


def test_jax_bf16_dict_loads_in_the_port_bit_for_bit(tmp_path):
    w, b = _bf16(0, (7, 5)), _bf16(1, (5,))
    fname = str(tmp_path / "ck.npz")
    jmx.nd.save(fname, {"w": jmx.np.array(w, dtype="bfloat16"),
                        "b": jmx.np.array(b, dtype="bfloat16"),
                        "i": jmx.np.array(onp.arange(6, dtype="int32"))})
    got = mt.nd.load(fname, device=mt.cpu())
    assert sorted(got) == ["b", "i", "w"]         # no sidecar key
    assert got["w"]._data.dtype == torch.bfloat16
    assert onp.array_equal(_bits(got["w"]._data), w.view(onp.int16))
    assert onp.array_equal(_bits(got["b"]._data), b.view(onp.int16))
    assert got["i"]._data.dtype == torch.int32
    assert onp.array_equal(got["i"].asnumpy(), onp.arange(6))


def test_port_bf16_list_loads_in_jax_bit_for_bit(tmp_path):
    w = _bf16(2, (3, 4, 5))
    t = torch.from_numpy(w.view(onp.int16).copy()).view(torch.bfloat16)
    fname = str(tmp_path / "ck.npz")
    mt.nd.save(fname, [mt.nd.array(t, device=mt.cpu()),
                       mt.nd.array(onp.ones(3, "float32"), device=mt.cpu())])
    got = jmx.nd.load(fname)
    assert isinstance(got, list) and len(got) == 2
    assert got[0].dtype == ml_dtypes.bfloat16
    assert onp.array_equal(got[0].asnumpy().view(onp.int16),
                           w.view(onp.int16))
    assert got[1].dtype == onp.float32
    # and back into the port
    back = mt.nd.load(fname, device=mt.cpu())
    assert onp.array_equal(_bits(back[0]._data), w.view(onp.int16))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_plain_files_stay_plain_npz(tmp_path, dtype):
    """No exotic array: no sidecar, and each member holds the bytes
    np.savez writes for the same arrays (the zip's timestamps aside); the
    JAX package loads it, and plain numpy too."""
    r = onp.random.RandomState(3)
    arrays = {"a": (r.randn(4, 3) * 100).astype(dtype),
              "b": (r.randn(5) * 100).astype(dtype)}
    port, plain = str(tmp_path / "port.npz"), str(tmp_path / "plain.npz")
    mt.nd.save(port, {k: mt.nd.array(v, dtype=dtype, device=mt.cpu())
                      for k, v in arrays.items()})
    onp.savez(plain, **arrays)
    with zipfile.ZipFile(port) as zp, zipfile.ZipFile(plain) as zq:
        assert sorted(zp.namelist()) == sorted(zq.namelist()) \
            == ["a.npy", "b.npy"]
        for name in zq.namelist():
            assert zp.read(name) == zq.read(name)
    with onp.load(port) as z:
        assert codec.DTYPE_KEY not in z.files
    got = jmx.nd.load(port)
    for k, v in arrays.items():
        assert got[k].dtype == onp.dtype(dtype)
        assert onp.array_equal(got[k].asnumpy(), v)


def test_sidecar_key_is_reserved_and_never_returned(tmp_path):
    x = mt.nd.array(onp.ones(2, "float32"), device=mt.cpu())
    with pytest.raises(ValueError, match="reserved"):
        mt.nd.save(str(tmp_path / "x.npz"), {codec.DTYPE_KEY: x})
    fname = str(tmp_path / "y.npz")
    bf = torch.ones(3, dtype=torch.bfloat16)
    mt.nd.save(fname, {"x": mt.nd.array(bf, device=mt.cpu())})
    with onp.load(fname) as z:
        assert sorted(z.files) == sorted(["x", codec.DTYPE_KEY])
        assert codec.read_sidecar(z) == {"x": "bfloat16"}
        assert z["x"].dtype == onp.uint16
    assert list(mt.nd.load(fname, device=mt.cpu())) == ["x"]


def test_other_exotic_dtypes_raise_naming_the_dtype(tmp_path):
    """float8 has no torch dtype in the port: loading a JAX file with one
    raises and names it; bf16 cannot go to .npy, which has no sidecar."""
    fname = str(tmp_path / "f8.npz")
    f8 = onp.arange(4, dtype="float32").astype(ml_dtypes.float8_e4m3fn)
    jmx.nd.savez(fname, q=f8)
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        mt.nd.load(fname, device=mt.cpu())
    bf = mt.nd.array(torch.ones(2, dtype=torch.bfloat16), device=mt.cpu())
    with pytest.raises(ValueError, match=".npy"):
        mt.nd.save(str(tmp_path / "x.npy"), bf)
