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
            assert g.vector, shape
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
            assert g.vector == vector, (shape, itemsize, aligned)
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
                    assert g.vector == want, (shape, axis, itemsize, aligned)


def test_chunks_bounded_and_offsets_fit_an_int():
    huge = (2 ** 20, 2 ** 11)            # 2^31 bf16 elements, channels last
    for sms in SMS:
        g = knorm.launch_geometry(huge, 1, 2, sms)
        lanes = huge[1] * 2 // 16
        assert g.vector and g.chunks <= 65535
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
            assert g.vector
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
