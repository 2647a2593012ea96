"""LAMB under MXNet's AMP loop, and the 14 optimizer rules, on the card at
a tiny width. Marked ``cuda``; every test skips without a card. The file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_lamb.py

The first test runs 2 LAMB steps of a 2-layer BERT (units 128, 2 heads,
batch 8, seq 384, Xavier, bf16 with f32 masters, dropout 0) through
``tools/finetune.py``'s AMP loop on the card and on the CPU from the same
seed: the losses agree within 0.03 (bf16 activations: the card's
attention kernels and the CPU's plain versions round at other points, the
tolerance chip_smoke.py's phase 6 takes), no overflow and a scale of 1 on
both, and on the card K4, K5a and K5b run once per layer a step (all on
the tensor cores) and the global-norm kernel once per bucket a step, while
the ladder kernel runs none (LAMB is outside it). The second runs
chip_smoke.py's phase 17 at that width, the third its phase 18 (one update
of each rule in f32, bf16 and bf16 with masters, the card against the
CPU).
"""
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import build as kbuild
from mxnet_tpu_torch.kernels import dispatch
from mxnet_tpu_torch.kernels import opt as kopt
from mxnet_tpu_torch.optimizer import optimizer as topt
from mxnet_tpu_torch.tools import finetune

TINY = dict(num_layers=2, units=128, hidden_size=256, num_heads=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kbuild.build(["flash_attention_fwd", "flash_attention_bwd",
                  "opt_ladder"])
    return torch.device("cuda", 0)


def _two_steps(device):
    net, trainer, step = chip_smoke._lamb_build(finetune, mt, device, 0.0,
                                                **TINY)
    kbuild.reset_counters()
    losses = [step().float().mean().item() for _ in range(2)]
    launches = {c.name: c.value for c in kbuild.COUNTERS.values()}
    plan = chip_smoke.opt_plan(kopt, trainer)
    return losses, launches, plan, trainer, step


@pytest.mark.cuda
def test_lamb_amp_steps_on_the_card_match_the_cpu(cuda_device):
    card, launches, plan, trainer, step = _two_steps(cuda_device)
    cpu, _, _, cpu_trainer, cpu_step = _two_steps(mt.cpu())
    assert max(abs(a - b) for a, b in zip(card, cpu)) <= 0.03, (card, cpu)
    for tr, st in ((trainer, step), (cpu_trainer, cpu_step)):
        assert tr._amp_loss_scaler.loss_scale == 1.0
        assert st.overflows == [False, False]
    layers = TINY["num_layers"]
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert launches[name] == launches[f"{name}_mma"] == 2 * layers
    assert launches["opt_sqnorm"] == 2 * plan["buckets"] == 4
    assert launches["opt_ladder"] == 0


@pytest.mark.cuda
def test_phase_lamb_amp(cuda_device):
    out = chip_smoke.phase_lamb_amp(torch, mt, finetune, kbuild, kopt, topt,
                                    dispatch, cuda_device, warmup=1,
                                    steps=3, **TINY)
    assert out["launches"]["flash_attention_fwd_mma"] == 3 * 2
    assert out["loss_scale"] == 1.0
    assert out["optimizer_alone"]["bound_ms"] > 0


@pytest.mark.cuda
def test_rule_sweep_card_against_cpu(cuda_device):
    out = chip_smoke.phase_rule_sweep(torch, mt, kopt, topt, cuda_device,
                                      num_layers=1, units=128,
                                      hidden_size=256, num_heads=2)
    assert len(out["cases"]) == 14 * 3
    assert out["max_err_over_tol"] <= 1.0
