"""The port's Ulysses attention (mxnet_tpu_torch/parallel/ulysses.py)
against the JAX package's ``ulysses_attention_sharded`` over the 8 virtual
CPU devices of tests/conftest.py, with the same numpy inputs and output
gradient (forward within rtol 1e-5, atol 1e-6; gradients rtol 2e-4, atol
2e-5), against the port's own rings, and its head-divisibility error. The
port's mesh holds 8 ``cpu`` positions.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu.parallel import ulysses as julysses
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import ring_attention as tring
from mxnet_tpu_torch.parallel import ulysses as tulysses


def _meshes(n):
    return (jmesh.make_mesh({"sp": n}, jax.devices()[:n]),
            tmesh.make_mesh({"sp": n}, [torch.device("cpu")] * n))


def _inputs(seed, shape):
    rs = onp.random.RandomState(seed)
    return [rs.randn(*shape).astype("f") for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_the_jax_package(causal):
    jm, tm = _meshes(8)
    arrs = _inputs(0, (2, 8, 32, 8))
    jq, jk, jv, jg = (jnp.asarray(a) for a in arrs)
    ref, vjp = jax.vjp(lambda q, k, v: julysses.ulysses_attention_sharded(
        q, k, v, jm, causal=causal), jq, jk, jv)
    q, k, v = (torch.from_numpy(a.copy()).requires_grad_()
               for a in arrs[:3])
    out = tulysses.ulysses_attention_sharded(q, k, v, tm, causal=causal)
    out.backward(torch.from_numpy(arrs[3].copy()))
    onp.testing.assert_allclose(out.detach().numpy(), onp.asarray(ref),
                                rtol=1e-5, atol=1e-6)
    for t, r in zip((q, k, v), vjp(jg)):
        onp.testing.assert_allclose(t.grad.numpy(), onp.asarray(r),
                                    rtol=2e-4, atol=2e-5)


def test_ulysses_and_the_rings_agree():
    """The JAX package's own check (test_profiler_ulysses.py), on the
    port: Ulysses, the plain ring and the flash ring give one result."""
    _, tm = _meshes(8)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, (1, 8, 64, 16))[:3])
    for causal in (False, True):
        u = tulysses.ulysses_attention_sharded(q, k, v, tm, causal=causal)
        for ring in (tring.ring_attention_sharded,
                     tring.ring_flash_attention_sharded):
            r = ring(q, k, v, tm, causal=causal)
            onp.testing.assert_allclose(u.numpy(), r.numpy(), rtol=1e-5,
                                        atol=1e-5)


def test_ulysses_bf16_rounds_once():
    """bf16 shards: the exchange moves them as they are, the attention runs
    in f32 and rounds once, as in the JAX package."""
    jm, tm = _meshes(4)
    arrs = _inputs(2, (1, 4, 32, 8))
    ref = julysses.ulysses_attention_sharded(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs[:3]), jm, causal=True)
    got = tulysses.ulysses_attention_sharded(
        *(torch.from_numpy(a).bfloat16() for a in arrs[:3]), tm,
        causal=True)
    assert got.dtype == torch.bfloat16
    diff = onp.abs(got.float().numpy() - onp.asarray(ref, onp.float32))
    # one bf16 rounding apart at most: half an ulp each way
    assert diff.max() <= 2 ** -8 * onp.abs(onp.asarray(ref, onp.float32)
                                           ).max()


def test_heads_must_divide_the_axis():
    jm, tm = _meshes(8)
    x = onp.ones((1, 4, 32, 8), "f")   # 4 heads < 8 positions
    with pytest.raises(ValueError) as ref:
        julysses.ulysses_attention_sharded(*[jnp.asarray(x)] * 3, jm)
    with pytest.raises(ValueError) as got:
        tulysses.ulysses_attention_sharded(*[torch.from_numpy(x)] * 3, tm)
    assert str(got.value) == str(ref.value) == \
        "heads 4 not divisible by axis size 8"
