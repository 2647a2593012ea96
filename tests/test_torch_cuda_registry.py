"""The operator corpus on the card. Marked ``cuda``; every test skips
without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_registry.py

``chip_smoke.py`` phase 22 at its full size (ResNet-50 in the legacy ops,
the registered flash attention at BERT-base's shape, the sweep of every
case of ``ops/_sweep_cases.py``), and the refusals: a CUDA input the
attention kernels do not take raises through the registered op, and a
sampler without a card scope draws on ``cuda:0``.
"""
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.kernels import build as kbuild
from mxnet_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kbuild.build(["bn_train", "flash_attention_fwd", "flash_attention_bwd"])
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_resnet50_in_the_legacy_ops(cuda_device):  # noqa: ARG001
    out = chip_smoke.phase_registry_resnet(torch, mt, kbuild, vision)
    assert out["launches"]["bn_train_fwd"] == 53 * chip_smoke.REG_STEPS


@pytest.mark.cuda
def test_registered_flash_attention(cuda_device):  # noqa: ARG001
    out = chip_smoke.phase_registry_attention(torch, mt, kbuild, fa)
    assert out["launches"]["flash_attention_fwd_mma"] == 4


@pytest.mark.cuda
def test_sweep_on_the_card(cuda_device):  # noqa: ARG001
    assert chip_smoke.phase_registry_sweep(torch, mt)["failed"] == 0


@pytest.mark.cuda
def test_no_silent_fallback(cuda_device):
    """A CUDA input the kernels refuse (float64) raises through the
    registry's op; draws outside a scope land on ``cuda:0``."""
    q = mt.np.array(torch.randn(1, 2, 16, 8, device=cuda_device),
                    dtype="float64")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mt.npx.flash_attention(q, q, q)
    assert mt.np.random.gamma(2.0, size=(3,)).device == cuda_device
    assert mt.nd.random.poisson(3.0, shape=(3,)).device == cuda_device
