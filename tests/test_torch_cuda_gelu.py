"""The exact GELU (ops/nn.py:gelu_exact) on the card against the CPU at
x = -8 ... 8, f32 and bf16, and its f32 gradient: chip_smoke.py's phase 4b.
Marked ``cuda``; skips without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_gelu.py
"""
import pytest
import torch

import chip_smoke


@pytest.mark.cuda
def test_gelu_card_against_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    errs = chip_smoke.phase_gelu(torch)
    assert set(errs) == {"torch.float32", "torch.bfloat16",
                         "grad_float32_excess"}
