"""Flash-attention backward of the PyTorch port against the JAX package.

The port's plain backward (mxnet_tpu_torch/ops/flash_attention.py:
flash_attention_bwd_reference, explicit FlashAttention-2 formulas) is held
against the JAX package's Pallas backward kernels run as that package's own
tests run them on the CPU: ``jax.vjp`` through ``pa.flash_attention(...,
interpret=True, block_q=32, block_k=32)``, which reaches ``_flash_bwd`` and
its two ``pallas_call``s in interpret mode. Same numpy inputs and output
gradient on both sides; f32 within rtol 2e-4, atol 2e-5 (that package's own
tolerance for its backward). The CUDA kernels themselves are held against
the plain backward on the card, in tests/test_torch_cuda.py.

``torch.autograd.gradcheck`` needs float64 throughout; the forward's lse and
the backward's accumulators are float32 by contract (as in the TPU
kernels), so instead of a gradcheck the explicit backward is held against
``torch.autograd`` through the plain forward.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu_torch.ops import flash_attention as fa

# (B, H, S, D, causal, dropout_p, dtype)
CASES = [
    (1, 2, 64, 32, False, 0.0, "float32"),     # plain
    (2, 2, 64, 64, True, 0.0, "float32"),      # causal
    (2, 3, 37, 32, False, 0.0, "float32"),     # ragged S, padded to 64
    (1, 2, 200, 64, False, 0.0, "float32"),    # ragged S above 128
    (2, 2, 96, 32, False, 0.1, "float32"),     # dropout, seed 7
    (1, 2, 200, 64, True, 0.1, "float32"),     # ragged, causal, dropout
    (2, 2, 64, 64, False, 0.0, "bfloat16"),
]


def _inputs(b, h, s, d, seed=0):
    rs = onp.random.RandomState(seed)
    return [rs.randn(b, h, s, d).astype("f") * 0.5 for _ in range(4)]


@pytest.mark.parametrize("b,h,s,d,causal,p,dtype", CASES)
def test_plain_backward_matches_jax_pallas_backward(b, h, s, d, causal, p,
                                                    dtype):
    q, k, v, g = _inputs(b, h, s, d)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, g))
    _, pull = jax.vjp(
        lambda q_, k_, v_: pa.flash_attention(
            q_, k_, v_, causal=causal, interpret=True, block_q=32,
            block_k=32, dropout_p=p,
            dropout_seed=jnp.int32(7) if p else None), jq, jk, jv)
    want = [onp.asarray(x.astype(jnp.float32)) for x in pull(jg)]

    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    seed = 7 if p else None
    out, lse = fa.flash_attention_reference(tq, tk, tv, causal=causal,
                                            dropout_p=p, dropout_seed=seed)
    got = fa.flash_attention_bwd_reference(
        tq, tk, tv, out, lse, tg, causal=causal, dropout_p=p,
        dropout_seed=seed)
    # bf16: both sides round dS and P_d to bf16 at the same points, but an
    # f32 difference of one ulp before a rounding moves the result by one
    # bf16 ulp (2^-8 relative), and dq, dk, dv round once more at the end
    tol = (dict(rtol=2e-4, atol=2e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tdt and a.shape == (b, h, s, d)
        onp.testing.assert_allclose(a.float().numpy(), w, err_msg=name,
                                    **tol)


def test_explicit_backward_equals_torch_autograd_of_the_plain_forward():
    for causal, p in ((False, 0.0), (True, 0.0), (False, 0.2), (True, 0.1)):
        q, k, v, g = (torch.from_numpy(a).requires_grad_(i < 3)
                      for i, a in enumerate(_inputs(2, 2, 45, 24, seed=3)))
        seed = 11 if p else None
        out, lse = fa.flash_attention_reference(
            q, k, v, causal=causal, dropout_p=p, dropout_seed=seed)
        want = torch.autograd.grad(out, (q, k, v), g)
        got = fa.flash_attention_bwd_reference(
            q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(),
            g, causal=causal, dropout_p=p, dropout_seed=seed)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=2e-5, atol=2e-6)


def test_flash_attention_is_differentiable_and_launches_nothing_on_cpu():
    """On CPU tensors the autograd.Function runs the plain forward and the
    plain explicit backward; no kernel is launched, and without recording
    it returns the forward's output with no graph."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 2, 40, 16))
    before = [c.value for c in (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ,
                                fa.LAUNCHES_BWD_DKV)]
    q.requires_grad_(True)
    k.requires_grad_(True)
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.requires_grad and out.grad_fn is not None
    dq, dk = torch.autograd.grad(out, (q, k), g)
    ref, lse = fa.flash_attention_reference(q.detach(), k.detach(), v,
                                            causal=True)
    want = fa.flash_attention_bwd_reference(q.detach(), k.detach(), v, ref,
                                            lse, g, causal=True)
    assert torch.equal(dq, want[0]) and torch.equal(dk, want[1])
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    assert [c.value for c in (fa.LAUNCHES, fa.LAUNCHES_BWD_DQ,
                              fa.LAUNCHES_BWD_DKV)] == before
    # a fully masked row cannot arise from causal masking, but lse = -inf
    # must give zero gradients, not NaN
    lse_dead = lse.clone()
    lse_dead[:, :, 0] = -float("inf")
    dead = fa.flash_attention_bwd_reference(q.detach(), k.detach(), v, ref,
                                            lse_dead, g, causal=True)
    assert all(torch.isfinite(x).all() for x in dead)
    assert dead[0][:, :, 0].abs().max() == 0
