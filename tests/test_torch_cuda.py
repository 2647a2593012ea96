"""The PyTorch port's attention kernels against their plain versions, on
the card: the forward in float32 (the FP32 variant) and in bfloat16 (the
tensor-core variant), and the bfloat16 backward (the float32 backward is in
tests/test_torch_cuda_train.py; the dropout-mask probe and determinism in
tests/test_torch_flash_attention_mma.py). These tests are marked ``cuda``
and skip without a card. The file imports no JAX, so it also runs where
JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.ops import flash_attention as fa

# (B, H, S, D, causal, dropout_p), as in test_torch_flash_attention.py
CASES = [
    (2, 3, 37, 32, False, 0.0),
    (1, 2, 200, 64, False, 0.0),
    (2, 2, 64, 64, True, 0.0),
    (1, 2, 37, 32, True, 0.0),
    (2, 2, 128, 32, False, 0.1),
    (1, 2, 200, 64, True, 0.1),
    (1, 2, 77, 40, False, 0.0),    # ragged head dim
    (1, 2, 130, 128, True, 0.1),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_raises_for_head_dim_over_128(cuda_device):
    q = torch.randn(1, 2, 16, 136, device=cuda_device)
    before = fa.LAUNCHES.value
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    assert fa.LAUNCHES.value == before


def _fwd_against_plain(q, k, v, causal, p, variant):
    seed = 7 if p else None
    counter = fa.VARIANT_LAUNCHES[fa.KERNEL][variant]
    before = (fa.LAUNCHES.value, counter.value)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, dropout_p=p,
                                      dropout_seed=seed)
    want, want_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, dropout_p=p, dropout_seed=seed)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES.value, counter.value) == (before[0] + 1,
                                                  before[1] + 1)
    return out, lse, want, want_lse


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,d,causal,p", CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, b, h, s, d, causal,
                                           p):
    rs = onp.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rs.randn(b, h, s, d).astype("f"))
                  .to(cuda_device) for _ in range(4))
    seed = 7 if p else None
    # float32: the FP32 kernel; f32 on both sides, summed in another order
    out, lse, want, want_lse = _fwd_against_plain(q, k, v, causal, p, "fp32")
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    # bfloat16: the tensor-core kernels, forward then backward. P and out
    # round to bf16 at other points than in the plain version (out 3e-2,
    # lse 1e-3); dS, P_d and the gradients round to bf16: two ulps of the
    # largest gradient
    qb, kb, vb, gb = (t.to(torch.bfloat16) for t in (q, k, v, g))
    out, lse, want, want_lse = _fwd_against_plain(qb, kb, vb, causal, p,
                                                  "mma")
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert (out.float() - want.float()).abs().max().item() <= 3e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3
    counters = [fa.VARIANT_LAUNCHES[n]["mma"]
                for n in (fa.KERNEL_BWD_DQ, fa.KERNEL_BWD_DKV)]
    before = [c.value for c in counters]
    got = fa.flash_attention_bwd(qb, kb, vb, out, lse, gb, causal=causal,
                                 dropout_p=p, dropout_seed=seed)
    want = fa.flash_attention_bwd_reference(qb, kb, vb, out, lse, gb,
                                            causal=causal, dropout_p=p,
                                            dropout_seed=seed)
    torch.cuda.synchronize()
    assert [c.value - n for c, n in zip(counters, before)] == [1, 1]
    big = max(w.float().abs().max().item() for w in want)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert (a.float() - w.float()).abs().max().item() <= 2.0 ** -7 * big
