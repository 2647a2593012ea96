"""The checkpoint manager on the card, at a tiny width. Marked ``cuda``;
the test skips without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_checkpoint.py

It runs chip_smoke.py's phase 26 on a 2-layer BERT (units 128, 2 heads,
batch 8, seq 384, bf16 with f32 masters, AdamW, dropout 0.1) through
``gluon.TrainStep``'s CUDA graph: a worker killed in the middle of an async
checkpoint write is resumed in a fresh process and equals the
uninterrupted run bit for bit (losses, weights, masters, moments; K3, K4,
K5a and K5b counted on the resumed steps); a restore into the live,
captured TrainStep replays the same steps with no new capture; a SIGTERM
between steps leaves a committed ``preempt`` checkpoint that
``mxnet_tpu_torch.tools.ckpt verify`` passes and exits with the configured
code.
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
def test_kill_resume_live_restore_and_preemption(cuda_device):
    kbuild.build(["flash_attention_fwd", "flash_attention_bwd",
                  "opt_ladder"])
    out = chip_smoke.phase_checkpoint(torch, mt, finetune, kbuild, kopt,
                                      cuda_device, **TINY)
    steps = chip_smoke.CKPT_STEPS - chip_smoke.CKPT_AT
    assert out["resumed_equals_uninterrupted"]
    assert out["c"]["losses"] == out["losses_a"][chip_smoke.CKPT_AT:]
    assert out["c"]["launches"]["flash_attention_fwd_mma"] == 2 * steps
    assert out["c"]["launches"]["opt_ladder"] > 0
    assert out["live"]["bitwise"] and out["live"]["captures"] == 1
    assert out["preempt"]["exit_code"] == chip_smoke.CKPT_PREEMPT_CODE
    assert out["numbers"]["bytes"] > 0
