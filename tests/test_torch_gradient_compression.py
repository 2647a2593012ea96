"""Gradient compression (mxnet_tpu_torch/kvstore/gradient_compression.py)
against the JAX package's on the CPU (64-bit types on): over two rounds,
with the first round's residual fed into the second, the packed ``uint8``
codes, the residuals and the dequantized values of 2-bit and 1-bit
compression, f32 and bf16, at sizes that fill the last byte and sizes that
pad it, bit for bit. The JAX side of the table runs through one
``jax.jit``."""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.kvstore import gradient_compression as jgc
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kvstore.gradient_compression import GradientCompression

R = onp.random.RandomState(17)
#: (shape, dtype, threshold): sizes 1, 7 and 30 pad the last byte
CASES = [((1,), "float32", 0.5), ((7,), "float32", 0.5),
         ((6, 5), "float32", 0.5), ((32, 33), "float32", 0.25),
         ((3, 4, 8), "bfloat16", 0.5), ((30,), "bfloat16", 0.125)]
GRADS = [(R.uniform(-1.2, 1.2, s), R.uniform(-1.2, 1.2, s))
         for s, _, _ in CASES]


def _jax_table(kind):
    comp = jgc._compress_2bit if kind == "2bit" else jgc._compress_1bit
    decomp = jgc._decompress_2bit if kind == "2bit" else \
        jgc._decompress_1bit

    def table(*grads):
        out = []
        for (shape, dt, thr), g1, g2 in zip(CASES, grads[0::2],
                                           grads[1::2]):
            p1, r1 = comp(g1, jnp.zeros_like(g1), threshold=thr)
            p2, r2 = comp(g2, r1, threshold=thr)
            out.append([p1, r1, p2, r2,
                        decomp(p1, threshold=thr, shape=shape, dtype=dt),
                        decomp(p2, threshold=thr, shape=shape, dtype=dt)])
        return out

    args = [jnp.asarray(g, dtype=dt) for (_, dt, _), pair in
            zip(CASES, GRADS) for g in pair]
    return jax.jit(table)(*args)


def _bits(a):
    """An array's raw bits as numpy (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view("uint16")
        return a.numpy()
    a = onp.asarray(a)
    return a.view("uint16") if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind", ["2bit", "1bit"])
def test_codes_and_residuals_bit_for_bit_over_two_rounds(kind):
    want = _jax_table(kind)
    for (shape, dt, thr), (g1, g2), jout in zip(CASES, GRADS, want):
        gc = GradientCompression(type=kind, threshold=thr)
        dtype = getattr(torch, dt)
        t1 = torch.from_numpy(g1).to(dtype)
        t2 = torch.from_numpy(g2).to(dtype)
        p1 = gc.compress("w:0", t1)
        r1 = gc._residuals["w:0"].clone()
        p2 = gc.compress("w:0", t2)
        r2 = gc._residuals["w:0"]
        got = [p1, r1, p2, r2, gc.decompress(p1, shape, dtype),
               gc.decompress(p2, shape, dtype)]
        assert p1.dtype == torch.uint8 and p1.numel() == -(
            -g1.size // (4 if kind == "2bit" else 8))
        for i, (a, b) in enumerate(zip(jout, got)):
            assert tuple(b.shape) == tuple(a.shape), (shape, dt, i)
            onp.testing.assert_array_equal(_bits(b), _bits(a),
                                           err_msg=f"{shape} {dt} {i}")


def test_pipeline_factor_keys_and_errors():
    """compress_pipeline is compress then decompress; residuals are kept
    per key and restart when a key's shape changes; the factors; an
    unknown type raises, as in the JAX package."""
    for kind, factor in (("2bit", 16), ("1bit", 32)):
        gc = GradientCompression(type=kind, threshold=0.5)
        jc = jgc.GradientCompression(type=kind, threshold=0.5)
        assert gc.get_compression_factor() == factor == \
            jc.get_compression_factor()
        g = GRADS[2][0].astype("f")
        for key in ("a:0", "a:0", "b:0"):
            got = gc.compress_pipeline(key, torch.from_numpy(g))
            want = jc.compress_pipeline(key, jnp.asarray(g))
            onp.testing.assert_array_equal(got.numpy(), onp.asarray(want))
        assert set(gc._residuals) == {"a:0", "b:0"}
        # another shape under the same key starts from a zero residual
        h = GRADS[1][0].astype("f")
        onp.testing.assert_array_equal(
            gc.compress_pipeline("a:0", torch.from_numpy(h)).numpy(),
            onp.asarray(jc.compress_pipeline("a:0", jnp.asarray(h))))
    for pkg in (mt.kvstore.gradient_compression, jgc):
        with pytest.raises(ValueError, match="1bit/2bit"):
            pkg.GradientCompression(type="3bit")


@pytest.mark.parametrize("kind", ["2bit", "1bit"])
def test_store_pushpull_compressed_two_rounds(kind):
    """A store with compression on: two rounds of a two-copy pushpull
    (residual per (key, copy)) bit for bit the JAX store's, local and
    tpu_dist alike."""
    grads = [GRADS[3][0].astype("f"), GRADS[3][1].astype("f")]
    results = {}
    for pkg in (jmx, mt):
        ctx = mt.cpu() if pkg is mt else torch.no_grad()
        with ctx:
            out = []
            for name in ("local", "tpu_dist"):
                kv = pkg.kvstore.create(name)
                kv.set_gradient_compression({"type": kind,
                                             "threshold": 0.25})
                o = pkg.nd.zeros(grads[0].shape)
                for _ in range(2):
                    kv.pushpull("g", [pkg.nd.array(g) for g in grads],
                                out=o)
                    out.append(onp.asarray(o.asnumpy()).copy())
            results[pkg] = out
    for a, b in zip(results[jmx], results[mt]):
        onp.testing.assert_array_equal(b, a)
