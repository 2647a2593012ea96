"""Training under sharding plans on the card, at a small width. Marked
``cuda``; the test skips without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_sharding.py

It runs chip_smoke.py's phase 27 on a 2-layer BERT (units 128, 2 heads,
batch 8, seq 384, bf16 with f32 masters, AdamW, dropout 0.1) through
``gluon.TrainStep``'s CUDA graph over positions of ``cuda:0``: under
``dp=2,fsdp=2,tp=2`` (layout, ZeRO) it equals the unplaced run bit for bit
(losses, weights, masters, moments) with K3 launched as the placed tables
predict; under ``dp=4`` (the per-shard form) it stays within the AdamW
step bound; at dropout 0 and learning rate 0 over fresh batches dp=4 and
the layout-less dp=2,fsdp=2 keep every first moment within
``SHARD_GRAD_LIMIT`` of the unplaced run's, where a control that drops a
shard's gradients does not; the layout-less dp=2,fsdp=2 trains as dp=2
bit for bit, its ZeRO blocks the slices of dp=2's state; ZeRO's bytes a
position; checkpoints across plans
(PlanMismatch, resharded and unplaced restores bit for bit, the offline
reshard, the CLI, a resumed run); and elastic re-entry to dp=2,fsdp=2 with
the LR halved, bit for bit with the unplaced run and one new capture.
"""
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import build as kbuild
from mxnet_tpu_torch.kernels import opt as kopt
from mxnet_tpu_torch.tools import finetune

TINY = dict(num_layers=2, units=128, hidden_size=256, num_heads=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and the CUDA graphs "
                    "have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_plans_checkpoints_and_reentry(cuda_device):
    kbuild.build(["flash_attention_fwd", "flash_attention_bwd",
                  "opt_ladder"])
    out = chip_smoke.phase_sharding(torch, mt, finetune, kbuild, kopt,
                                    cuda_device, **TINY)
    a = out["a"]
    assert all(a["hybrid_bitwise"].values())
    assert a["hybrid"]["launches"]["opt_ladder"] == a["k3_predicted"]
    assert a["dp4"]["launches"]["flash_attention_fwd_mma"] == \
        4 * 2 * chip_smoke.SHARD_STEPS
    assert a["dp4"]["bound"]["worst_excess"] <= 0
    gate = a["gradient_gate"]
    for label in ("dp4", "dp2_fsdp2"):
        assert gate["worst"][label] <= chip_smoke.SHARD_GRAD_LIMIT
    assert gate["control_least"] > chip_smoke.SHARD_GRAD_LIMIT
    z = a["dp2_fsdp2"]
    assert all(z["bitwise_dp2"].values())
    assert z["zero_blocks"]["equal"] == z["zero_blocks"]["compared"]
    assert out["b"]["total"] == out["b"]["expected_total"]
    assert all(out["c"]["resumed_bitwise"].values())
    assert out["d"]["captures"][1] == out["d"]["captures"][0] + 1
    assert all(out["d"]["bitwise"].values())
