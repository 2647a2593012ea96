"""The PyTorch port's forward attention kernel against its plain version,
on the card (the training slice's kernels are in
tests/test_torch_cuda_train.py). These tests are marked ``cuda`` and skip
without a card. The file imports no JAX, so it also runs where JAX is
absent:

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


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,d,causal,p", CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, b, h, s, d, causal,
                                           p):
    rs = onp.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(b, h, s, d).astype("f"))
               .to(cuda_device) for _ in range(3))
    seed = 7 if p else None
    before = fa.LAUNCHES.value
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, dropout_p=p,
                                      dropout_seed=seed)
    want, want_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, dropout_p=p, dropout_seed=seed)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.value == before + 1
    # f32 on both sides, summed in another order
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
