"""The vision zoo's path on the card. Marked ``cuda``; every test skips
without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_vision.py

K1 and K2 at MobileNetV2-1.0's BatchNorm shapes (bf16 NCHW, the scalar
path, batch 64) against their plain versions with chip_smoke.py's checks;
a narrow MobileNetV2 training step on the card against the port on the
CPU; the activation table on the card against the CPU.
"""
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.kernels import build as kbuild
from mxnet_tpu_torch.kernels import norm as knorm
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.tools import train_resnet


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_bn_kernels_at_mobilenet_v2_nchw_sites(cuda_device):
    """Each of the 19 shapes of MobileNetV2's 53 sites at batch 64: the
    statistics within 1e-4 relative, out and dx within 2^-7 of their
    largest value, a second launch bit for bit, the scalar path."""
    kbuild.build(["bn_train"])
    sites = chip_smoke.mobilenet_v2_bn_sites(torch, vision, cuda_device, 64)
    assert sum(n for _, n in sites) == 53 and len(sites) == 19
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    sms = knorm.sm_count(cuda_device)
    for shape, _ in sites:
        row, ops = chip_smoke.bn_case(torch, knorm, gen, cuda_device, sms,
                                      str(shape), shape, 1, torch.bfloat16,
                                      "f32", True, 0)
        assert not row["vector_path"] and row["bitwise_repeat"]
        del ops


@pytest.mark.cuda
def test_narrow_mobilenet_v2_step_card_against_cpu(cuda_device,
                                                   monkeypatch):
    """MobileNetV2 at multiplier 0.25, f32, batch 8 of 64x64, one SGD
    step on the card (53 K1 and K2 launches) and on the CPU from the same
    weights: loss within 1e-4, every gradient within 1e-3 of the net's
    largest, the running statistics within 1e-4 relative. ReLU6 is
    softplus on both devices here: an activation within rounding of a
    kink takes the other branch on one device, and through 53 BatchNorms
    in training mode that moves whole gradient elements (the CPU tests'
    measure, ``tests/test_torch_vision_zoo.py``)."""
    monkeypatch.setitem(tnn._ACTS, "relu6", tnn._ACTS["softrelu"])
    kbuild.build(["bn_train", "opt_ladder"])
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        net, trainer, step = train_resnet.build_resnet_train(
            batch=8, layout="NCHW", stem_s2d=False, dtype="float32",
            device=dev, seed=3, image=64, classes=10,
            model=vision.MobileNetV2(0.25, classes=10))
        before = knorm.LAUNCHES_FWD.value, knorm.LAUNCHES_BWD.value
        loss = step().cpu()
        if dev.type == "cuda":
            assert (knorm.LAUNCHES_FWD.value - before[0],
                    knorm.LAUNCHES_BWD.value - before[1]) == (53, 53)
        ps = net.collect_params()
        res[dev.type] = (loss, {k: p.grad().cpu() for k, p in ps.items()
                                if p.grad_req != "null"},
                         {k: p._tensor().detach().cpu() for k, p in ps.items()
                          if p.grad_req == "null"})
    (closs, cg, cs), (ploss, pg, ps_) = res["cuda"], res["cpu"]
    assert (closs - ploss).abs().max() <= 1e-4
    big = max(g.abs().max() for g in pg.values())
    for k, g in pg.items():
        assert (cg[k] - g).abs().max() <= 1e-3 * big, k
    for k, v in ps_.items():
        assert (cs[k] - v).abs().max() <= 1e-4 * max(v.abs().max(), 1e-2), k


@pytest.mark.cuda
def test_activation_table_card_against_cpu(cuda_device):
    """Every act_type on the card against the CPU, f32 within 1e-6
    relative (plus 1e-6 of the largest for the exact GELU's tail and the
    row softmax), bf16 within 2^-7 of each value's magnitude."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 96, generator=gen) * 4
    x[0, :8] = torch.tensor([-0.0, 0.0, 3.0, -3.0, 6.0, -6.0, 40.0, -40.0])
    for name in sorted(tnn._ACTS):
        for dt, rtol in ((torch.float32, 1e-6), (torch.bfloat16, 2 ** -7)):
            want = tnn.activation(x.to(dt), name).float()
            got = tnn.activation(x.to(dt).to(cuda_device), name).float().cpu()
            atol = rtol * max(want.abs().max().item(), 1.0)
            assert torch.allclose(got, want, rtol=rtol, atol=atol), (name, dt)
            nd = mt.np.array(x.numpy(), device=cuda_device)
            assert mt.npx.activation(nd, name).shape == x.shape
