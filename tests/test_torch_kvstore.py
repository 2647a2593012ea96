"""``mx.kvstore`` (mxnet_tpu_torch/kvstore) against the JAX package on the
CPU (64-bit types on): the cases of ``tests/test_kvstore.py`` and
``tests/test_kvstore_shims.py`` run through both packages from the same
numpy inputs, then the row-sparse push and ``row_sparse_pull``, the list
form's flat buckets, and optimizer-state files read across the packages.

Each scenario is written once over a package's namespace (``mx``) and run
through both; what it returns is compared value by value (sums of f32
inputs exactly, optimizer results within rtol 1e-6: the JAX package keeps
its scalars in float64).

No check here reads the JAX package's store registry as it stands at run
time: ``tests/test_kvstore.py`` registers a store of its own into the JAX
package's ``KVStoreBase.kv_registry``, a class attribute of that package.
"""
import logging

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kvstore import KVStoreBase, TPUDist

R = onp.random.RandomState(5)
#: inputs drawn once, so both packages see the same values
A, B = R.rand(3, 4).astype("f"), R.rand(5).astype("f")
XS = [R.rand(*s).astype("f") for s in ((3, 2), (7,), (2, 2, 2))]


def _host(x):
    """numpy of a result of either package, bf16 as f32."""
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.detach().float() if x.dtype == torch.bfloat16 else x.detach()
        return x.numpy()
    a = onp.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)
    return a.astype("f") if a.dtype.name == "bfloat16" else a


def both(scenario, *args):
    """``(jax result, port result)`` of ``scenario(mx, *args)``, the port's
    on CPU arrays."""
    want = _host(scenario(jmx, *args))
    with mt.cpu():
        got = _host(scenario(mt, *args))
    return want, got


def same(want, got, rtol=0.0, atol=0.0):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        onp.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                    err_msg=f"result {i}")


def _local_cases(mx):
    out = []
    kv = mx.kvstore.create("local")
    kv.init("3", mx.np.ones((2, 2)))
    o = mx.np.zeros((2, 2))
    kv.pull("3", out=o)
    out.append(o.copy())
    kv.push("3", mx.np.full((2, 2), 7.0))
    kv.pull("3", out=o)
    out.append(o)
    kv = mx.kvstore.create("local")
    kv.init("k", mx.np.zeros((3,)))
    kv.push("k", [mx.np.ones((3,)), mx.np.full((3,), 2.0)])
    o = mx.np.zeros((3,))
    kv.pull("k", out=o)
    out.append(o)
    kv = mx.kvstore.create("device")
    outs = [mx.np.zeros((4,)), mx.np.zeros((4,))]
    kv.pushpull("0", [mx.np.ones((4,)), mx.np.full((4,), 3.0)], out=outs)
    out += outs
    kv = mx.kvstore.create("local")
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1))
    kv.init("0", mx.np.ones((2,)))
    kv.push("0", mx.np.ones((2,)))
    o = mx.np.zeros((2,))
    kv.pull("0", out=o)
    out.append(o)
    kv = mx.kvstore.create("teststore")
    o = mx.np.zeros((2,))
    kv.pushpull("a", [mx.np.ones((2,)), mx.np.ones((2,))], out=o)
    out.append(o)
    # several keys at once, a list of copies each
    a, b = A, B
    kv = mx.kvstore.create("local")
    kv.init(["x", "y"], [mx.np.array(a), mx.np.array(b)])
    kv.push(["x", "y"], [[mx.np.array(a)] * 2, [mx.np.array(b)] * 3])
    outs = [mx.np.zeros((3, 4)), mx.np.zeros((5,))]
    kv.pull(["x", "y"], out=outs)
    return out + outs


def test_local_store_cases():
    """test_kvstore.py's local, device, server-side optimizer and
    teststore cases, and several keys at once."""
    want, got = both(_local_cases)
    same(want, got, rtol=1e-6)
    onp.testing.assert_allclose(got[1], onp.full((2, 2), 8.0))
    onp.testing.assert_allclose(got[5], onp.full((2,), 0.9), rtol=1e-6)


def _dist_cases(mx, fused):
    kv = mx.kvstore.create("tpu_dist")
    out = [onp.array([kv.rank, kv.num_workers])]
    vals = [mx.np.ones((8,)), mx.np.full((8,), 2.0)]
    outs = [mx.np.zeros((8,)), mx.np.zeros((8,))]
    kv.pushpull(0, vals, out=outs)
    out += outs
    o = [mx.np.zeros((8,))]
    kv.broadcast(1, mx.np.full((8,), 5.0), out=o)
    out += o
    kv.barrier()
    # the list form: three keys of two copies (the fused path's buckets
    # in one process) and the write-back's version bumps
    xs = XS
    vals = [[mx.np.array(x), mx.np.array(2 * x)] for x in xs]
    outs = [[mx.np.zeros(x.shape)] for x in xs]
    kv.pushpull([0, 1, 2], vals, out=outs)
    out += [o[0] for o in outs]
    out.append(onp.array([o[0]._version for o in outs]))
    # one copy a key: no sum, the write-back alone
    ones = [[mx.np.array(x)] for x in xs]
    kv.pushpull([0, 1, 2], ones, out=ones)
    out += [v[0] for v in ones]
    out.append(onp.array([v[0]._version for v in ones]))
    fb = mx.kvstore.create("horovod")
    a = mx.nd.array([1.0, 2.0, 3.0])
    o = mx.nd.zeros(3)
    fb.pushpull("w0", a, out=o)
    return out + [o]


@pytest.mark.parametrize("fused", ["1", "0"])
def test_tpu_dist_in_one_process(monkeypatch, fused):
    """tpu_dist in one process: rank 0 of 1, pushpull and broadcast, the
    list form (the JAX package's store with MXTPU_FUSED_UPDATE on and off;
    the port's store reads no knob and gives the same sums either way),
    the horovod name's pushpull contract."""
    monkeypatch.setenv("MXTPU_FUSED_UPDATE", fused)
    want, got = both(_dist_cases, fused)
    same(want, got)
    onp.testing.assert_array_equal(got[0], [0, 1])
    onp.testing.assert_allclose(got[1], onp.full((8,), 3.0))
    assert isinstance(mt.kvstore.create("tpu_dist").backend, type(None))


def test_create_aliases_adapters_and_registry(caplog):
    """Every alias of create ('horovod' and 'byteps' are TPUDist in the
    port, as the JAX package falls back to it without their packages; its
    log line says so), the server shim, and the port's own registry."""
    for name in ("tpu_dist", "dist_sync", "dist_async", "dist",
                 "dist_sync_device", "dist_async_device", "nccl", "p3",
                 "horovod", "byteps", "Horovod"):
        jkv = jmx.kvstore.create(name)
        with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.kvstore"):
            tkv = mt.kvstore.create(name)
        assert isinstance(tkv, TPUDist), name
        assert type(tkv).__name__ == type(jkv).__name__, name
    for name in ("local", "device", "local_allreduce_cpu",
                 "local_allreduce_device"):
        assert mt.kv.create(name).type == jmx.kv.create(name).type == name
    assert "using tpu_dist" in caplog.text
    assert KVStoreBase.find("tpudist") is TPUDist
    assert KVStoreBase.find("p3") is mt.kvstore.P3Store
    with pytest.raises(RuntimeError, match="serverless"):
        mt.kvstore.KVStoreServer(None).run()
    with pytest.raises(ValueError, match="unknown kvstore"):
        mt.kvstore.create("no_such_store")
    # the sharded methods over a mesh of CPU positions, their mesh and axes
    # taken from an adopted plan (tests/test_torch_sharding_train.py holds
    # them against the JAX package's)
    kv = mt.kv.create("tpu_dist")
    x = torch.arange(8.0).reshape(4, 2)
    mesh = mt.parallel.make_mesh({"dp": 2}, [mt.cpu()] * 2)
    assert torch.equal(kv.allreduce_sharded([x], mesh)[0], x[:2] + x[2:])
    with pytest.raises(ValueError, match="ZeRO axis"):
        kv.reduce_scatter_sharded([x])
    kv.set_sharding_plan(mt.sharding.ShardingPlan(
        "dp=2,fsdp=2", devices=[mt.cpu()] * 4))
    assert torch.equal(kv.allreduce_sharded({"g": x})["g"], x[:2] + x[2:])
    assert torch.equal(kv.reduce_scatter_sharded([x])[0], 2 * x)
    summed = kv.traced_allreduce([{"g": x}, {"g": x}])
    assert torch.equal(summed[1]["g"], 2 * x)

    # a store registered in the port is found by name, in the port alone
    class PortOnlyStore(KVStoreBase):
        def broadcast(self, key, value, out, priority=0):
            value.copyto(out if not isinstance(out, list) else out[0])

        def pushpull(self, key, value, out=None, priority=0):
            if out is not None:
                value.copyto(out if not isinstance(out, list) else out[0])

    try:
        KVStoreBase.register(PortOnlyStore)
        kv = mt.kvstore.create("portonlystore")
        with mt.cpu():
            out = mt.np.zeros((2,))
            kv.broadcast("k", mt.np.ones((2,)), out)
        onp.testing.assert_array_equal(out.asnumpy(), [1.0, 1.0])
        assert jmx.kvstore.KVStoreBase.find("portonlystore") is None
    finally:
        KVStoreBase.kv_registry.pop("portonlystore", None)


def _p3_cases(mx, raw, comp):
    kv = mx.kvstore.create("p3")
    plain = mx.kvstore.create("tpu_dist")
    if comp:
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        plain.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    outs = [mx.np.zeros(raw[0].shape) for _ in raw]
    kv.pushpull(0, [mx.np.array(v) for v in raw], out=outs, priority=0)
    ref = [mx.np.zeros(raw[0].shape) for _ in raw]
    plain.pushpull(0, [mx.np.array(v) for v in raw], out=ref)
    small = [mx.np.zeros((4, 4)) for _ in range(2)]
    kv.pushpull(1, [mx.np.array(onp.ones((4, 4), "f"))] * 2, out=small)
    # the list form in descending priority
    lst = [[mx.np.array(v)] for v in raw]
    kv.pushpull([5, 6, 7], lst, out=lst)
    return outs + ref + small + [v[0] for v in lst]


@pytest.mark.parametrize("comp", [False, True])
def test_p3_chunked(monkeypatch, comp):
    """P3's chunked reduce above MXNET_KVSTORE_BIGARRAY_BOUND against the
    unchunked store and the JAX package's, with and without 2-bit
    compression before the slicing."""
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "1000")
    rs = onp.random.RandomState(3)
    raw = [rs.randn(50, 100).astype("f") for _ in range(3)]  # 5 chunks
    want, got = both(_p3_cases, raw, comp)
    same(want, got)
    for o in got[:3]:
        onp.testing.assert_array_equal(o, got[3])
    if not comp:
        onp.testing.assert_allclose(got[0], sum(raw), rtol=1e-6)


def _sparse_cases(mx, rows, ids):
    out = []
    shape = (10, 3)
    kv = mx.kvstore.create("local")
    kv.init("emb", mx.nd.sparse.row_sparse_array(
        (rows[0], ids[0]), shape=shape))
    kv.push("emb", [mx.nd.sparse.row_sparse_array((r, i), shape=shape)
                    for r, i in zip(rows[1:], ids[1:])])
    for want in ([7, 1, 1, 9, 4], [0], onp.array([2, 8, 5])):
        rsp = kv.row_sparse_pull("emb", row_ids=mx.nd.array(want)
                                 if isinstance(want, onp.ndarray) else want)
        out += [rsp.data, rsp.indices]
    dense = mx.nd.zeros(shape)
    kv.pull("emb", out=dense)
    out.append(dense)
    # row_sparse_pull of a dense value, and into an out
    kv.init("d", mx.nd.array(onp.arange(30, dtype="f").reshape(shape)))
    dest = mx.nd.sparse.row_sparse_array((rows[0][:1], [0]), shape=shape)
    kv.row_sparse_pull("d", out=dest, row_ids=[4, 2, 4])
    out += [dest.data, dest.indices]
    # sparse pushpull and a server-side optimizer over a sparse push
    o = mx.nd.zeros(shape)
    kv.pushpull("s", [mx.nd.sparse.row_sparse_array((r, i), shape=shape)
                      for r, i in zip(rows[:2], ids[:2])], out=o)
    out.append(o)
    kv = mx.kvstore.create("local")
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
    kv.init("w", mx.nd.ones(shape))
    kv.push("w", mx.nd.sparse.row_sparse_array((rows[1], ids[1]),
                                               shape=shape))
    w = mx.nd.zeros(shape)
    kv.pull("w", out=w)
    return out + [w]


def test_row_sparse_push_and_pull():
    """The sparse push merges rows; row_sparse_pull gives the unique
    requested rows (zero where the stored value lacks one), from a
    row-sparse and from a dense value, into an out too."""
    rs = onp.random.RandomState(9)
    ids = [[1, 4, 7], [0, 4], [7, 9]]
    rows = [rs.randn(len(i), 3).astype("f") for i in ids]
    want, got = both(_sparse_cases, rows, ids)
    same(want, got, rtol=1e-6)
    onp.testing.assert_array_equal(got[1], [1, 4, 7, 9])
    assert got[1].dtype == onp.int32


def _resume_cases(mx, tmp, key, dtype):
    def make():
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        return kv

    def step(kv, w, n):
        for _ in range(n):
            kv.push(key, mx.nd.ones((4,), dtype=dtype) * 0.5)
            kv.pull(key, out=w)

    out = []
    kv1 = make()
    w1 = mx.nd.ones((4,), dtype=dtype)
    kv1.init(key, w1)
    step(kv1, w1, 3)
    fname = f"{tmp}/{mx.__name__}.states"
    kv1.save_optimizer_states(fname)
    saved = w1.copy()
    step(kv1, w1, 2)
    out.append(w1)
    kv2 = make()                      # load after set_optimizer
    w2 = saved.copy()
    kv2.init(key, w2)
    kv2.load_optimizer_states(fname)
    step(kv2, w2, 2)
    kv3 = mx.kv.create("local")       # load before set_optimizer
    w3 = saved.copy()
    kv3.init(key, w3)
    kv3.load_optimizer_states(fname)
    kv3.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    step(kv3, w3, 2)
    kv4 = make()                      # a warm state is overwritten
    w4 = saved.copy()
    kv4.init(key, w4)
    step(kv4, w4, 1)
    kv4.load_optimizer_states(fname)
    state = kv4._updater.states[int(key)]
    leaves = state if isinstance(state, (list, tuple)) else [state]
    return out + [w2, w3] + [leaf for leaf in leaves if leaf is not None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_states_resume_and_files_across(tmp_path, dtype):
    """A store resumed from its saved momentum continues as the
    uninterrupted one (loaded after and before set_optimizer; a warm state
    overwritten), in both packages; then each package's file is read by
    the other (bf16 momentum leaves through the dtype codec), and the
    next step agrees."""
    want, got = both(_resume_cases, str(tmp_path), "3", dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    same(want, got, rtol=tol)
    for g in got[1:3]:
        onp.testing.assert_array_equal(g, got[0])
    # files across: each loads the other's and takes two steps
    for reader, writer in ((mt, jmx), (jmx, mt)):
        path = f"{tmp_path}/{writer.__name__}.states"
        ctx = mt.cpu() if reader is mt else _null()
        with ctx:
            kv = reader.kv.create("local")
            kv.set_optimizer(reader.optimizer.SGD(learning_rate=0.1,
                                                  momentum=0.9))
            w = reader.nd.array(got[-1] * 0 + 1, dtype=dtype)
            kv.init("3", w)
            kv.load_optimizer_states(path)
            for _ in range(2):
                kv.push("3", reader.nd.ones((4,), dtype=dtype) * 0.5)
                kv.pull("3", out=w)
            if reader is mt:
                port_w = _host(w)
            else:
                jax_w = _host(w)
    onp.testing.assert_allclose(port_w, jax_w, rtol=tol)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
