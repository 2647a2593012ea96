"""Checkpoint and resume on the card, at a tiny width. Marked ``cuda``;
every test skips without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_resume.py

The first test runs chip_smoke.py's phase 16 on a 2-layer BERT (units
128, 2 heads, batch 8, seq 384, bf16 with f32 masters, AdamW): a run
resumed from ``save_parameters``/``save_states`` equals the uninterrupted
one bit for bit, with K3, its norm, K4, K5a and K5b counted on the resumed
steps; a captured ``gluon.TrainStep`` replays after ``load_states`` and
``load_parameters`` with no rebuild and no capture; an engine's captured
rungs answer from the loaded weights, capturing again only after a
retyping load. The second holds ``mx.np.take``'s out-of-range gather on
the card to the CPU's.
"""
import numpy as onp
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving
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
def test_resume_train_step_and_serving_from_a_checkpoint(cuda_device):
    kbuild.build(["flash_attention_fwd", "flash_attention_bwd",
                  "opt_ladder"])
    out = chip_smoke.phase_resume(torch, mt, finetune, serving, kbuild,
                                  kopt, cuda_device, **TINY)
    assert out["resumed_equals_uninterrupted"]
    assert out["losses_resumed"] == out["losses_a"][2:]
    assert out["launches"]["flash_attention_fwd_mma"] == 2 * 2
    assert out["launches"]["opt_sqnorm"] > 0
    assert out["train_step"]["captures"] == 1
    assert out["serving_in_place"]["captures_after_load"] == 0
    assert out["serving_retyped"]["captures_after_load"] == 2


@pytest.mark.cuda
def test_take_out_of_range_gather_on_the_card(cuda_device):
    """'fill', 'clip' and 'wrap' with indices out of range: the card's
    gather equals the CPU's, fill values included."""
    idx = onp.array([[5, -1], [-5, 3]], "int32")
    for dtype in ("float32", "int32", "bool"):
        a = onp.arange(12).reshape(3, 4).astype(dtype)
        for mode in (None, "clip", "wrap"):
            kw = {} if mode is None else {"mode": mode}
            for axis in (None, 1):
                got = mt.np.take(mt.np.array(a, device=cuda_device),
                                 mt.np.array(idx, device=cuda_device),
                                 axis=axis, **kw)
                with mt.cpu():
                    want = mt.np.take(mt.np.array(a), mt.np.array(idx),
                                      axis=axis, **kw)
                assert got._data.is_cuda
                onp.testing.assert_array_equal(got.asnumpy(),
                                               want.asnumpy())
