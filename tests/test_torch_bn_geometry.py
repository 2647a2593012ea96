"""The launch geometry of the BatchNorm-training kernels K1/K2
(mxnet_tpu_torch/kernels/norm.py:launch_geometry) and the per-channel
algebra their f32-elementwise mode runs (csrc/bn_train.cu), on the CPU.

The kernels run only on the card; what decides how they split the work,
and the formulas they fold per channel, are checked here: the geometry at
ResNet-50's 9 BatchNorm shapes and at the edges (C = 3, C = 100, NCHW, a
misaligned base), at SM counts 132 (H100 SXM) and 114 (H100 PCIe); the
vector path exactly where C and alignment allow it; chunk counts within
the grid's limit; every row visited once by the kernels' row walk; and a
result that depends on its arguments alone. The folded algebra is held
against the plain versions ops/nn.py:_bn_train_impl / _bn_train_bwd at
1e-5.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.kernels import norm as knorm
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.tools.bn_regime_study import (RESNET18_CIFAR_SITES,
                                                   mobilenet_v2_bn_sites)

SMS = (132, 114)


def resnet50_bn_sites(batch):
    """``[(NHWC shape, sites)]``: the 53 BatchNorm sites of ResNet-50 v1 at
    224x224, by shape (a copy of chip_smoke.py's)."""
    sites, hw = [((batch, 112, 112, 64), 1)], 56
    for i, (blocks, c) in enumerate(zip((3, 4, 6, 3), (256, 512, 1024, 2048))):
        hw = hw // 2 if i else hw
        sites += [((batch, hw, hw, c // 4), 2 * blocks),
                  ((batch, hw, hw, c), blocks + 1)]
    return sites


def _vector_rows(geom, itemsize):
    """The rows each (channel tile, chunk, row lane) of the vector kernels
    visits, as csrc/bn_train.cu's VSlice and for_vec_rows walk them:
    ``{row: visits}`` for one lane column (every lane walks the same rows)."""
    rows = geom.outer * geom.inner
    lanes = geom.c * itemsize // 16
    slab = min(lanes, 32)
    row_lanes = 256 // slab
    per_chunk = -(-rows // geom.chunks)
    seen = onp.zeros(rows, dtype=onp.int64)
    for chunk in range(geom.chunks):
        r0 = chunk * per_chunk
        nrows = max(0, min(per_chunk, rows - r0))
        for rl in range(row_lanes):
            seen[r0 + onp.arange(rl, nrows, row_lanes)] += 1
    return seen, lanes, per_chunk


def test_resnet50_sites_take_the_vector_path():
    sites = resnet50_bn_sites(256)
    assert sum(k for _, k in sites) == 53 and len(sites) == 9
    for shape, _ in sites:
        for sms in SMS:
            g = knorm.launch_geometry(shape, 3, 2, sms)
            assert g.regime == "vector", shape
            assert (g.outer, g.c, g.inner) == (shape[0] * shape[1] * shape[2],
                                               shape[3], 1)
            assert 1 <= g.chunks <= 65535
            lanes = shape[3] * 2 // 16
            tiles = -(-lanes // min(lanes, 32))
            rows = g.outer
            per_chunk = -(-rows // g.chunks)
            # a chunk holds at least 128 rows unless the card needs more CTAs
            assert per_chunk >= 128 or g.chunks * tiles <= 8 * sms, shape
            # about 8 CTAs an SM, not fewer than the rows allow
            assert tiles * g.chunks <= 8 * sms + tiles
            assert per_chunk * lanes < 2 ** 31


def test_edge_shapes():
    cases = [((7, 13, 17, 3), 3, 4, True, False),      # C = 3, f32
             ((5, 11, 100), 2, 4, True, True),         # C = 100, f32: 25 lanes
             ((5, 11, 100), 2, 2, True, False),        # C = 100, bf16
             ((32, 64, 56, 56), 1, 4, True, False),    # NCHW
             ((5, 100, 3), 1, 2, True, False),         # NCW
             ((4, 9, 9, 64), 3, 2, False, False),      # base off 16 bytes
             ((3, 7, 11, 8), 3, 2, True, True)]        # C = 8, ragged rows
    for shape, axis, itemsize, aligned, vector in cases:
        for sms in SMS:
            g = knorm.launch_geometry(shape, axis, itemsize, sms, aligned)
            assert (g.regime == "vector") == vector, (shape, itemsize,
                                                     aligned)
            assert 1 <= g.chunks <= 65535
            assert g.outer * g.c * g.inner == onp.prod(shape)
            assert g.inner == (1 if axis == len(shape) - 1
                               else onp.prod(shape[axis + 1:]))


def test_vector_path_exactly_where_c_and_alignment_allow():
    for c in range(1, 70):
        for itemsize in (2, 4):
            for aligned in (True, False):
                for shape, axis in (((6, 5, c), 2), ((6, c, 5), 1)):
                    g = knorm.launch_geometry(shape, axis, itemsize, 132,
                                              aligned)
                    want = (axis == 2 and c * itemsize % 16 == 0
                            and aligned)
                    assert (g.regime == "vector") == want, (shape, axis,
                                                          itemsize, aligned)


def test_chunks_bounded_and_offsets_fit_an_int():
    huge = (2 ** 20, 2 ** 11)            # 2^31 bf16 elements, channels last
    for sms in SMS:
        g = knorm.launch_geometry(huge, 1, 2, sms)
        lanes = huge[1] * 2 // 16
        assert g.regime == "vector" and g.chunks <= 65535
        assert -(-huge[0] // g.chunks) * lanes < 2 ** 30 + lanes
        g = knorm.launch_geometry((2 ** 26, 64, 1), 1, 4, sms)  # NCHW-ish
        assert 1 <= g.chunks <= 65535
        g = knorm.launch_geometry((1, 3), 1, 4, sms)             # one row
        assert g.chunks == 1


def test_every_row_visited_once():
    shapes = [s for s, _ in resnet50_bn_sites(8)] + [
        (3, 7, 11, 8), (5, 11, 100), (2, 3, 2056)]
    for shape in shapes:
        itemsize = 4 if shape == (5, 11, 100) else 2
        for sms in SMS:
            g = knorm.launch_geometry(shape, len(shape) - 1, itemsize, sms)
            assert g.regime == "vector"
            seen, _, _ = _vector_rows(g, itemsize)
            assert (seen == 1).all(), (shape, sms)


def test_geometry_depends_on_its_arguments_alone(monkeypatch):
    shape = (256, 14, 14, 1024)
    first = [knorm.launch_geometry(shape, 3, 2, sms) for sms in SMS]

    def no_card(*a, **k):
        raise AssertionError("launch_geometry asked the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "is_available", no_card)
    again = [knorm.launch_geometry(shape, 3, 2, sms) for sms in SMS]
    assert first == again
    assert first[0].chunks != first[1].chunks   # the SM count matters
    # the card's SM count comes from its properties, cached per device
    monkeypatch.setattr(knorm, "_SM_COUNT", {})

    class Props:
        multi_processor_count = 114

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda idx: Props())
    assert knorm.sm_count("cuda:0") == 114
    assert knorm._SM_COUNT == {0: 114}


# -- the f32-elementwise algebra of csrc/bn_train.cu, per channel ---------


def _folded_fwd(x, gamma, beta, shift, eps, axis):
    """K1 in f32 mode: partials of xf = x - s and xf^2, the combine's mean,
    var, inv and (s, a, b), then out = fma(x - s, a, b)."""
    dims = tuple(d for d in range(x.dim()) if d != axis)
    shape = [1] * x.dim()
    shape[axis] = -1
    n = x.numel() // x.shape[axis]
    s = shift.float().reshape(shape)
    xf = x.float() - s
    s1, s2 = xf.sum(dims), (xf * xf).sum(dims)
    mean_c = s1 / n
    var = (s2 / n - mean_c * mean_c).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    a = gamma.float() * inv
    b = beta.float() - mean_c * gamma.float() * inv
    out = xf * a.reshape(shape) + b.reshape(shape)
    return out.to(x.dtype), mean_c + shift.float(), var, inv


def _folded_bwd(x, gamma, mean, inv, dy, dmean, dvar, axis):
    """K2 in f32 mode: partials of dy and dy * (x - mean); dgamma = inv *
    the second; a = gamma * inv, b = (2 dvar - a dgamma inv) / n,
    c = (dmean - a dbeta) / n folded in float64; dx = a dy + b (x - m) + c."""
    dims = tuple(d for d in range(x.dim()) if d != axis)
    shape = [1] * x.dim()
    shape[axis] = -1
    n = x.numel() // x.shape[axis]
    xc = x.float() - mean.reshape(shape)
    dyf = dy.float()
    dbeta = dyf.sum(dims)
    dgamma = inv * (dyf * xc).sum(dims)
    a = gamma.float() * inv
    b = ((2.0 * dvar.double() - a.double() * dgamma.double() * inv.double())
         / n).float()
    c = ((dmean.double() - a.double() * dbeta.double()) / n).float()
    dx = (a.reshape(shape) * dyf + b.reshape(shape) * xc
          + c.reshape(shape))
    return dx.to(x.dtype), dgamma, dbeta


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_f32_folded_algebra_matches_the_plain_versions(layout):
    r = onp.random.RandomState(5)
    shape, axis = ((4, 5, 6, 16), 3) if layout == "nhwc" else ((4, 16, 5, 6),
                                                               1)
    c = shape[axis]
    x = torch.from_numpy((r.standard_normal(shape) * 2 + 3).astype("f"))
    dy = torch.from_numpy(r.standard_normal(shape).astype("f"))
    gamma, beta = (torch.from_numpy(r.uniform(0.5, 1.5, c).astype("f"))
                   for _ in range(2))
    shift = torch.from_numpy((r.standard_normal(c) * 0.1 + 3).astype("f"))
    dmean, dvar = (torch.from_numpy(r.standard_normal(c).astype("f"))
                   for _ in range(2))
    want = tnn._bn_train_impl(x, gamma, beta, shift, 1e-5, axis)
    got = _folded_fwd(x, gamma, beta, shift, 1e-5, axis)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    _, mean, _, inv = want
    wdx, wdg, wdb, _ = tnn._bn_train_bwd(
        1e-5, axis, (x, gamma, beta, shift, mean, inv), (dy, dmean, dvar))
    gdx, gdg, gdb = _folded_bwd(x, gamma, mean, inv, dy, dmean, dvar, axis)
    for g, w in ((gdx, wdx), (gdg, wdg), (gdb, wdb)):
        scale = max(1.0, w.abs().max().item())
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * scale)


# -- channels not last: the plane regimes of csrc/bn_train.cu ---------------


def test_nchw_regimes_at_mobilenet_v2_and_cifar_sites():
    mnv2 = mobilenet_v2_bn_sites(256)
    assert len(mnv2) == 19 and sum(k for _, k in mnv2) == 53
    assert sum(k for _, k in RESNET18_CIFAR_SITES) == 20
    for sms in SMS:
        for shape, _ in mnv2 + RESNET18_CIFAR_SITES:
            hw = shape[2]
            for backward in (False, True):
                g = knorm.launch_geometry(shape, 1, 2, sms, True, backward)
                want = ("vector" if hw == 1 else "planes" if hw == 112
                        or (hw == 56 and backward) else "resident")
                assert g.regime == want, (shape, backward, sms, g)
                # a misaligned base takes the same regime (the wrappers
                # copy it onto 16 bytes first)
                assert knorm.launch_geometry(
                    shape, 1, 2, sms, False, backward).regime in (want,
                                                                  "last")
                if want == "resident":
                    assert g.chunks in (1, 2, 4, 8)
                    kc = knorm.plane_slots(shape[2] * shape[3], 2)
                    per = -(-shape[0] * kc // g.chunks)
                    # two CTAs an SM, but where 8 CTAs hold 1/8 of a
                    # channel each (K1 at 56x56)
                    data = per * 16 * (2 if backward else 1)
                    assert data + knorm._SMEM_STATIC <= knorm._SMEM_BLOCK
                    assert g.chunks == 8 or 2 * (
                        data + knorm._SMEM_STATIC + knorm._SMEM_RESERVED) <= (
                        knorm._SMEM_BLOCK + knorm._SMEM_RESERVED)
                    # the grid covers the card where 8 CTAs a channel can
                    assert shape[1] * g.chunks >= sms or g.chunks == 8 or (
                        per < 2 * knorm._THREADS)
                elif want == "planes":
                    assert 1 <= g.chunks <= 65535
                assert knorm.cuda_launches(g) == {
                    "vector": 3, "planes": 2, "resident": 1}[want]
            # the same sites channels last take the 16-byte path
            nhwc = (shape[0], shape[2], shape[3], shape[1])
            assert knorm.launch_geometry(nhwc, 3, 2, sms).regime == "vector"
    # edges: C = 1, a plane of 1 element (channels last), of 49 (7 slots,
    # heads at every even byte), f32 planes of 2
    g = knorm.launch_geometry((64, 1, 28, 28), 1, 2, 132)
    assert (g.regime, g.chunks) == ("resident", 8)
    assert knorm.launch_geometry((64, 3, 1, 1), 1, 2, 132).regime == "last"
    assert knorm.plane_slots(49, 2) == 7 and knorm.plane_slots(196, 2) == 25
    assert knorm.plane_slots(784, 2) == 98 and knorm.plane_slots(2, 4) == 1
    assert knorm.launch_geometry((5, 100, 2), 1, 4, 132).regime == "resident"
    big = knorm.launch_geometry((2, 1, 2 ** 26), 1, 2, 132)
    assert big.regime == "planes" and big.chunks <= 65535


def _walk(geom, itemsize, c):
    """How often the plane walk of csrc/bn_train.cu (for_items over each
    CTA's items [q * per, ...), a thread's cursor stepped by (qs, rs))
    visits each element of channel ``c``; every slot it loads (one that
    overlaps its plane) lies inside the tensor's last 16 bytes."""
    outer, C, inner = geom.outer, geom.c, geom.inner
    pb, kc = inner * itemsize, knorm.plane_slots(inner, itemsize)
    items = outer * kc
    per = -(-items // geom.chunks)
    qs, rs = divmod(256, kc)
    seen = onp.zeros(outer * inner, dtype=onp.int64)
    t = onp.arange(256)
    end16 = -(-outer * C * pb // 16) * 16
    for q in range(geom.chunks):
        i0, i1 = q * per, min((q + 1) * per, items)
        cnt = onp.maximum(0, -(-(i1 - i0 - t) // 256))
        n, k = divmod(i0 + t, kc)
        for j in range(int(cnt.max())):
            act = j < cnt
            # the cursor is the item's (plane, slot), and the slot a
            # resident CTA keeps it in lies inside the CTA's share
            assert (n * kc + k == i0 + t + 256 * j)[act].all()
            assert (t + 256 * j < per)[act].all()
            start = (n * C + c) * pb
            head = start % 16
            lo, hi = head - 16 * k, head + pb - 16 * k
            loaded = act & (hi > 0)
            assert (start - head + 16 * k + 16 <= end16)[loaded].all()
            for v in range(16 // itemsize):
                byte = v * itemsize
                ok = act & (lo <= byte) & (byte < hi)
                e = (16 * k + byte - head) // itemsize
                onp.add.at(seen, (n * inner + e)[ok], 1)
            k = k + rs
            n = n + qs
            wrap = k >= kc
            k[wrap] -= kc
            n[wrap] += 1
    return seen


def test_nchw_walk_visits_every_element_once():
    shapes = ([(s, 2) for s, _ in mobilenet_v2_bn_sites(8)]
              + [(s, 2) for s, _ in RESNET18_CIFAR_SITES[:4]]
              + [((256, 144, 28, 28), 2), ((256, 160, 7, 7), 2),
                 ((64, 1, 28, 28), 2), ((4, 40, 9, 11), 4),
                 ((5, 100, 2), 4), ((3, 7, 5, 5), 2), ((24, 4, 224, 224), 2)])
    for shape, itemsize in shapes:
        for backward in (False, True):
            g = knorm.launch_geometry(shape, 1, itemsize, 132, True,
                                      backward)
            assert g.regime in ("planes", "resident")
            for c in sorted({0, min(1, g.c - 1), g.c - 1}):
                seen = _walk(g, itemsize, c)
                assert (seen == 1).all(), (shape, backward, c, g)
