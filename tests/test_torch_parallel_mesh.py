"""The port's meshes and collectives (mxnet_tpu_torch/parallel/mesh.py,
collectives.py) against the JAX package's on the 8 virtual CPU devices of
tests/conftest.py: ``make_mesh``'s inference and layout, the
``ShardingError`` messages, and psum_tree, psum_tree_flat, allreduce_mean,
all_gather, reduce_scatter and ring_permute on the same numpy inputs, with
the ``collective_*`` series and spans they record. The port's meshes hold
``cpu`` positions (several positions share the one CPU device); where a
test needs the positions told apart it names CUDA devices, which a mesh
never touches. f32 sums within 1e-6 relative (the sums run in another
order), integer-valued inputs exactly.
"""
import jax
import numpy as onp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import mxnet_tpu_torch as mt
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.diagnostics import spans as jspans
from mxnet_tpu.parallel import collectives as jcol
from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu_torch import telemetry as ttelemetry
from mxnet_tpu_torch.diagnostics import spans as tspans
from mxnet_tpu_torch.parallel import collectives as tcol
from mxnet_tpu_torch.parallel import mesh as tmesh

CPU4 = [torch.device("cpu")] * 4


def _jmesh(axes, n):
    return jmesh.make_mesh(axes, jax.devices()[:n])


def _tmesh(axes, n):
    return tmesh.make_mesh(axes, [torch.device("cpu")] * n)


def _close(port, ref, exact=False):
    got = port.numpy() if isinstance(port, torch.Tensor) else port
    want = onp.asarray(ref)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        onp.testing.assert_array_equal(got, want)
    else:
        onp.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _both(arr):
    return torch.from_numpy(arr.copy()), jax.numpy.asarray(arr)


def test_make_mesh_infers_sizes_and_lays_the_last_axis_innermost():
    specs = [{"dp": -1}, {"dp": -1, "tp": 4}, {"dp": 2, "sp": -1},
             {"a": None, "b": -1, "c": 2}, {"x": 2, "y": 2, "z": 2}]
    cards = [torch.device("cuda", i) for i in range(8)]
    for spec in specs:
        ref = jmesh.make_mesh(spec, jax.devices())
        port = tmesh.make_mesh(spec, cards)
        assert port.shape == ref.shape and port.axis_names == ref.axis_names
        ids = onp.vectorize(lambda d: d.index, otypes=[int])(port.devices)
        onp.testing.assert_array_equal(
            ids, onp.vectorize(lambda d: d.id, otypes=[int])(ref.devices))
    assert tmesh.data_parallel_mesh(CPU4).shape == {"dp": 4}
    mesh = tmesh.make_mesh({"dp": 2, "sp": 4}, cards)
    assert mesh.positions("sp") == cards[:4]
    assert mesh.positions("dp") == [cards[0], cards[4]]
    assert mt.parallel.make_mesh is tmesh.make_mesh


def test_sharding_errors_read_as_in_the_jax_package():
    def message(fn, *args):
        with pytest.raises(ValueError) as e:
            fn(*args)
        assert type(e.value).__name__ == "ShardingError"
        return str(e.value)

    for spec in ({"dp": 3}, {"dp": -1, "tp": 3}):
        assert message(tmesh.make_mesh, spec, [torch.device("cpu")] * 8) \
            == message(jmesh.make_mesh, spec, jax.devices())
    jm, tm = _jmesh({"dp": 4}, 4), _tmesh({"dp": 4}, 4)
    for shape, entries in (((6, 4), ("dp", None)), ((6, 4), (None, "zz")),
                           ((6,), (None, "dp")), ((8, 6), (("dp",), "dp"))):
        assert message(tmesh._check_divisible, "w", shape,
                       tmesh.PartitionSpec(*entries), tm) == \
            message(jmesh._check_divisible, "w", shape, JP(*entries), jm)
    tmesh._check_divisible("w", (8, 4), tmesh.PartitionSpec(("dp",), None),
                           tm)
    assert repr(tmesh.PartitionSpec("dp")) == repr(JP("dp"))
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError, match="CUDA"):
            tmesh.make_mesh({"sp": -1})
    # laying parameters and batches out (tests/test_torch_sharding_train.py
    # holds their blocks against the JAX package's shards)
    assert tmesh.shard_params({}, tm) is tm
    placed = tmesh.shard_batch(torch.arange(8.0).reshape(8, 1), tm)
    assert [b.flatten().tolist() for b in placed.shards] == [
        [0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]


def test_psum_tree_allreduce_mean_and_reduce_scatter():
    rs = onp.random.RandomState(0)
    tree_np = {"w": rs.randn(8, 3).astype("f"),
               "b": [rs.randint(-50, 50, (8,)).astype("int32"),
                     rs.randint(-50, 50, (16, 2)).astype("f")]}
    ttree = {"w": torch.from_numpy(tree_np["w"]),
             "b": [torch.from_numpy(x) for x in tree_np["b"]]}
    for axes, n in (({"dp": 4}, 4), ({"dp": 4, "tp": 2}, 8)):
        jm, tm = _jmesh(axes, n), _tmesh(axes, n)
        ref = jcol.psum_tree(tree_np, jm, "dp")
        port = tcol.psum_tree(ttree, tm, "dp")
        _close(port["w"], ref["w"])
        _close(port["b"][0], ref["b"][0], exact=True)
        _close(port["b"][1], ref["b"][1], exact=True)
    jm, tm = _jmesh({"dp": 4}, 4), _tmesh({"dp": 4}, 4)
    mean_ref = jcol.allreduce_mean({"w": tree_np["w"]}, jm, "dp")
    _close(tcol.allreduce_mean({"w": ttree["w"]}, tm, "dp")["w"],
           mean_ref["w"])
    x = rs.randint(-9, 9, (8, 5)).astype("f")
    tx, jx = _both(x)
    _close(tcol.reduce_scatter(tx, tm, "dp"), jcol.reduce_scatter(jx, jm,
                                                                  "dp"),
           exact=True)
    with pytest.raises(ValueError, match="not divisible"):
        tcol.reduce_scatter(tx[:6], tm, "dp")


def test_psum_tree_flat_buckets_two_dtypes_under_a_cap_that_splits(
        monkeypatch):
    rs = onp.random.RandomState(1)
    # 512 KB a leaf: a 1 MB cap puts two f32 leaves in a bucket
    leaves = [rs.randn(8, 16384).astype("f"),
              rs.randint(-5, 5, (8, 3)).astype("int32"),
              rs.randn(8, 16384).astype("f"), rs.randn(8, 16384).astype("f"),
              rs.randint(-5, 5, (4 * 8, 2)).astype("int32")]
    assert [len(b) for b in tcol._flat_buckets(
        [torch.from_numpy(x) for x in leaves], 1 << 20)] == \
        [len(b) for b in jcol._flat_buckets(leaves, 1 << 20)] == [2, 2, 1]
    jm, tm = _jmesh({"dp": 4}, 4), _tmesh({"dp": 4}, 4)
    # the 1 MB cap comes through the environment, the 64 MB one by argument
    for cap, arg in ((1, None), (64, 64)):
        monkeypatch.setenv("MXTPU_FUSED_BUCKET_MB", str(cap))
        assert tcol._resolve_bucket_mb(arg) == cap
        ref = jcol.psum_tree_flat(leaves, jm, "dp", bucket_mb=cap)
        port = tcol.psum_tree_flat([torch.from_numpy(x) for x in leaves],
                                   tm, "dp", bucket_mb=arg)
        assert isinstance(port, list) and len(port) == len(ref)
        for p, r, x in zip(port, ref, leaves):
            _close(p, r, exact=x.dtype == onp.int32)
        for p, r in zip(port, jcol.psum_tree(leaves, jm, "dp")):
            _close(p, r, exact=p.dtype == torch.int32)


@pytest.mark.parametrize("tiled", [True, False])
def test_all_gather(tiled):
    x = onp.random.RandomState(2).randn(8, 3, 2).astype("f")
    tx, jx = _both(x)
    for axes, n in (({"dp": 4}, 4), ({"tp": 2, "dp": 4}, 8)):
        ref = jcol.all_gather(jx, _jmesh(axes, n), "dp", tiled=tiled)
        _close(tcol.all_gather(tx, _tmesh(axes, n), "dp", tiled=tiled), ref,
               exact=True)


@pytest.mark.parametrize("shift", [1, -1])
def test_ring_permute(shift):
    x = onp.arange(8 * 3, dtype="f").reshape(8, 3)
    tx, jx = _both(x)
    ref = jcol.ring_permute(jx, _jmesh({"sp": 4}, 4), "sp", shift=shift)
    got = tcol.ring_permute(tx, _tmesh({"sp": 4}, 4), "sp", shift=shift)
    _close(got, ref, exact=True)
    onp.testing.assert_array_equal(got.numpy(), onp.roll(x, 2 * shift, 0))


def test_collective_series_and_spans_match_the_jax_package():
    pkgs = {"jax": (jtelemetry, jspans, jcol, _jmesh({"dp": 4}, 4), False),
            "torch": (ttelemetry, tspans, tcol, _tmesh({"dp": 4}, 4), True)}
    was = {k: (p[0].enabled(), p[1].enabled()) for k, p in pkgs.items()}
    x = onp.ones((8, 4), "f")
    leaves = [onp.ones((8, 16384), "f"), onp.ones((8, 2), "int32"),
              onp.ones((8, 16384), "f"), onp.ones((8, 16384), "f")]
    fams, spans = {}, {}
    try:
        for k, (tel, sp, col, mesh, port) in pkgs.items():
            tel.enable()
            tel.reset()
            sp.enable()
            sp.reset()
            arr = (lambda a: torch.from_numpy(a.copy())) if port else (
                lambda a: a)
            col.psum_tree({"a": arr(x)}, mesh, "dp")
            col.psum_tree_flat([arr(a) for a in leaves], mesh, "dp",
                               bucket_mb=1)
            col.allreduce_mean([arr(x)], mesh, "dp")
            col.all_gather(arr(x), mesh, "dp", tiled=False)
            col.reduce_scatter(arr(x), mesh, "dp")
            col.ring_permute(arr(x), mesh, "dp", shift=-1)
            text = tel.prometheus_text()
            parsed = (ttelemetry.promparse if port
                      else jtelemetry.promparse).parse_text(text)
            fams[k] = {n: f for n, f in parsed.items()
                       if n in ("collective_total", "collective_bytes_total",
                                "fused_bucket_size")}
            seconds = parsed["collective_seconds_total"]
            spans[k] = ([(r["name"], r["cat"]) for r in sp.records()],
                        sorted(s["labels"]["op"] for s in seconds["samples"]))
    finally:
        for k, (tel, sp, *_rest) in pkgs.items():
            tel.reset()
            tel.enable() if was[k][0] else tel.disable()
            sp.reset()
            sp.enable() if was[k][1] else sp.disable()
    assert fams["torch"] == fams["jax"]
    assert len(fams["torch"]) == 3
    assert spans["torch"] == spans["jax"]
    assert [n for n, _ in spans["torch"][0]] == [
        "psum", "psum_flat", "psum", "all_gather", "reduce_scatter",
        "ppermute"]
