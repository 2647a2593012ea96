"""Data-parallel training across processes on the card, at a small width:
chip_smoke.py's phase 24 with a narrow ResNet v1 (one bottleneck a stage,
64x64 images) at 8 images a rank for 2 steps in 24a: two ranks over gloo
on the one card bit for bit equal and within phase 8's measure of one
process over the two half-batches, K3 once a bucket a step, K1 and K2
against their plain versions at ResNet-50's 53 sites at batch 8; NCCL at
world size 1; the example and its compressed mode; compression on the
card against the CPU. Marked ``cuda``; the test skips without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_dist.py
"""
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_distributed_phase_at_a_small_width(card):  # noqa: ARG001
    out = chip_smoke.phase_distributed(torch, mt, narrow=True, batch=8,
                                       steps=2)
    resnet = out["resnet"]
    assert resnet["backend"] == "gloo"
    assert resnet["params_worst_over_tol"] <= 1.0
    for rank in resnet["ranks"]:
        assert rank["launches"]["bn_train_fwd"] == 2 * resnet["bn_layers"]
        assert rank["launches"]["opt_ladder"] == \
            2 * chip_smoke.DIST_LADDER_BUCKETS
    assert resnet["bn"]["sites"] == 53 and resnet["bn"]["batch"] == 8
    assert "nccl" in out["nccl"]["backend"]
    assert out["example"]["seen_loss"]["after"] < \
        out["example"]["seen_loss"]["before"]
