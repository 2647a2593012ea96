"""The vision zoo's path on the card. Marked ``cuda``; every test skips
without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_vision.py

K1 and K2 at MobileNetV2-1.0's BatchNorm shapes (bf16 NCHW, batch 64)
and at the NCHW regimes' edges against their plain versions with
chip_smoke.py's checks; a narrow MobileNetV2 training step on the card
against the port on the CPU; the activation table on the card against the
CPU.
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
    largest value, a second launch bit for bit, a plane regime."""
    kbuild.build(["bn_train"])
    sites = chip_smoke.mobilenet_v2_bn_sites(torch, vision, cuda_device, 64)
    assert sum(n for _, n in sites) == 53 and len(sites) == 19
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for shape, _ in sites:
        row, ops = chip_smoke.bn_case(torch, knorm, gen, cuda_device,
                                      str(shape), shape, 1, torch.bfloat16,
                                      "f32", True, 0)
        assert not row["vector_path"] and row["bitwise_repeat"]
        assert set(row["regime"].values()) <= {"planes", "resident"}
        del ops


def _resident_edge(c, hw, backward, sms, smem):
    """The largest batch at which a (N, c, hw, hw) bf16 channel still takes
    the resident regime (by launch_geometry)."""
    n = 1
    while knorm.launch_geometry((n + 1, c, hw, hw), 1, 2, sms, True,
                                backward, smem).regime == "resident":
        n += 1
    return n


# (label, shape, dtype, MXTPU_BN_COMPUTE, elements the views start into
# their storage)
NCHW_EDGES = [
    ("plane_49_elements", (16, 24, 7, 7), torch.bfloat16, "f32", 0),
    ("cluster_c32", (64, 32, 28, 28), torch.bfloat16, "f32", 0),
    ("c1", (64, 1, 28, 28), torch.bfloat16, "f32", 0),
    ("n1", (1, 64, 56, 56), torch.bfloat16, "f32", 0),
    ("f32_ragged_plane", (8, 40, 9, 11), torch.float32, "f32", 0),
    ("f32_planes", (8, 2, 256, 256), torch.float32, "f32", 0),
    ("f32_two_element_plane", (5, 100, 2), torch.float32, "f32", 0),
    ("bf16_math_resident", (32, 96, 14, 14), torch.bfloat16, "bf16", 0),
    ("bf16_math_planes", (24, 4, 224, 224), torch.bfloat16, "bf16", 0),
    ("misaligned_view", (4, 40, 9, 11), torch.bfloat16, "f32", 1),
    ("misaligned_planes", (24, 4, 224, 224), torch.bfloat16, "f32", 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtype,compute,misalign", NCHW_EDGES,
                         ids=[e[0] for e in NCHW_EDGES])
def test_bn_kernels_nchw_edges(cuda_device, label, shape, dtype, compute,
                               misalign):
    """K1 and K2 at the NCHW regimes' edges against their plain versions
    (chip_smoke.bn_case: tolerances, a second launch bit for bit, the
    regime launch_geometry chooses, the CUDA launches a call)."""
    kbuild.build(["bn_train"])
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    row, ops = chip_smoke.bn_case(torch, knorm, gen, cuda_device, label,
                                  shape, 1, dtype, compute, True, misalign)
    assert row["bitwise_repeat"] and not row["vector_path"]
    del ops


@pytest.mark.cuda
@pytest.mark.parametrize("backward", [False, True])
def test_bn_kernels_at_the_resident_limit(cuda_device, backward):
    """Just inside the resident regime's limit (the largest batch of a
    (N, 2, 56, 56) bf16 channel that a cluster of 8 holds) and just
    outside it (one image more: planes), against the plain versions."""
    kbuild.build(["bn_train"])
    sms = knorm.sm_count(cuda_device)
    smem = knorm.smem_per_block(cuda_device)
    n = _resident_edge(2, 56, backward, sms, smem)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    side = "bwd" if backward else "fwd"
    for batch, want in ((n, "resident"), (n + 1, "planes")):
        row, ops = chip_smoke.bn_case(torch, knorm, gen, cuda_device,
                                      f"edge_{batch}", (batch, 2, 56, 56), 1,
                                      torch.bfloat16, "f32", True, 0)
        assert row["regime"][side] == want, (batch, row["regime"])
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
