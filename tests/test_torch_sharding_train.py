"""Training under sharding plans (mxnet_tpu_torch/sharding, the placed
Parameter, gluon/_sharded.py, Trainer, TrainStep, the store's sharded
methods, ``parallel.shard_params``/``shard_batch``,
``make_data_parallel_step(param_specs=)``) against the JAX package on the
8 virtual CPU devices of tests/conftest.py, the port on CPU positions.

The JAX tests' two-Dense net (tests/test_sharding.py :326-451) in f32, SGD
with momentum 0.9, 3 steps under ``dp=4``, ``dp=4,tp=2`` with a rule and
``dp=2,fsdp=2,tp=2`` from the layout, through ``Trainer.step`` and through
``TrainStep``: losses and parameters within 1e-6 relative of the JAX
package's (the two sum in other orders); the port's fsdp/tp plans bit for
bit against its own unplaced run (the logical step is the same, and the
update is elementwise block by block); each position's block of every
weight and of its momentum (the ZeRO layout under fsdp) equal, in shape
and value, to the JAX array's shard on the device at the same mesh
position. Each JAX program compiles once (module-scope runs).
"""
import os

import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from jax.sharding import PartitionSpec as JP
from mxnet_tpu.parallel import collectives as jcol
from mxnet_tpu.parallel import data_parallel as jdp
from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.parallel import collectives as tcol
from mxnet_tpu_torch.parallel import data_parallel as tdp
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.sharding import ShardingPlan as TPlan

BATCH, FEATS, OUT, STEPS = 16, 12, 4, 3
R = onp.random.RandomState(5)
XS = [R.randn(BATCH, FEATS).astype("f") for _ in range(STEPS)]
YS = [R.randn(BATCH, OUT).astype("f") for _ in range(STEPS)]
PLANS = {
    "dp4": ("dp=4", None, False),
    "dp4_tp2_rule": ("dp=4,tp=2", [(r"0\.weight", (None, "tp"))], False),
    "dp2_fsdp2_tp2": ("dp=2,fsdp=2,tp=2", None, True),
}


@pytest.fixture(autouse=True)
def _isolate_jax_globals():
    """The JAX package's plans stamp its flight identity: restore it."""
    from mxnet_tpu.elastic import reentry
    from mxnet_tpu.observability import flight

    ident = dict(flight._identity)
    gen = reentry._generation[0]
    yield
    flight._identity.clear()
    flight._identity.update(ident)
    reentry._generation[0] = gen


def _n(axes):
    n = 1
    for part in axes.split(","):
        n *= int(part.split("=")[1])
    return n


def _jax_net():
    mx.seed(0)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=FEATS),
            mx.gluon.nn.Dense(OUT, in_units=16))
    net.initialize()
    net.hybridize()
    return net


def _port_net(jnet):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(16, activation="relu", in_units=FEATS),
            tnn.Dense(OUT, in_units=16))
    net.initialize(device=mt.cpu())
    load_jax_params(net, {n: p.data().asnumpy()
                          for n, p in jnet.collect_params().items()})
    return net


def _plans(label, jnet, tnet):
    axes, rules, layout = PLANS[label]
    kw = {"rules": rules} if rules else {}
    if layout:
        return (mx.sharding.ShardingPlan.from_layout(axes, net=jnet, **kw),
                TPlan.from_layout(axes, net=tnet,
                                  devices=[mt.cpu()] * _n(axes), **kw))
    return (mx.sharding.ShardingPlan(axes, **kw),
            TPlan(axes, devices=[mt.cpu()] * _n(axes), **kw))


def _train(label, how):
    """(jax side, port side, port unplaced side): each a dict with the
    losses, the parameters and, for the planned sides, the trainer and
    the plan."""
    jnet = _jax_net()
    tnet, tref = _port_net(jnet), _port_net(jnet)
    jplan, tplan = _plans(label, jnet, tnet) if label else (None, None)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", opt,
                           kvstore="tpu_dist", sharding_plan=jplan)
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", opt,
                           kvstore="tpu_dist", sharding_plan=tplan)
    rtr = mt.gluon.Trainer(tref.collect_params(), "sgd", opt)
    out = {"jax": {"losses": [], "trainer": jtr, "plan": jplan},
           "port": {"losses": [], "trainer": ttr, "plan": tplan},
           "ref": {"losses": []}}
    jstep = mx.gluon.TrainStep(jnet, mx.gluon.loss.L2Loss(), jtr)
    if how == "train_step":
        tstep = mt.gluon.TrainStep(tnet, mt.gluon.loss.L2Loss(), ttr)
        rstep = mt.gluon.TrainStep(tref, mt.gluon.loss.L2Loss(), rtr)
    for x, y in zip(XS, YS):
        if how == "train_step" and label != "dp4":
            jl = jstep(mx.np.array(x), mx.np.array(y)).asnumpy()
            tl = tstep(torch.from_numpy(x), torch.from_numpy(y)).numpy()
            rl = rstep(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        elif how == "train_step":
            # the JAX package's shard_map whole step scales the gradients
            # by the axis size under this jax (its own
            # test_wholestep_mesh_matches_single_device fails, ROADMAP.md
            # queue 3): the port's is held to its phased step
            os.environ["MXTPU_WHOLE_STEP"] = "0"
            try:
                jl = jstep(mx.np.array(x), mx.np.array(y)).asnumpy()
            finally:
                del os.environ["MXTPU_WHOLE_STEP"]
            tl = tstep(torch.from_numpy(x), torch.from_numpy(y)).numpy()
            rl = rstep(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        else:
            # the JAX package's phased step: its forward and backward over
            # the batch placed on the plan's mesh, then Trainer.step
            os.environ["MXTPU_WHOLE_STEP"] = "0"
            try:
                jl = jstep(mx.np.array(x), mx.np.array(y)).asnumpy()
            finally:
                del os.environ["MXTPU_WHOLE_STEP"]
            losses = []
            for net, tr in ((tnet, ttr), (tref, rtr)):
                with mt.autograd.record():
                    L = mt.gluon.loss.L2Loss()(net(torch.from_numpy(x)),
                                               torch.from_numpy(y))
                mt.autograd.backward(L)
                tr.step(BATCH)
                losses.append(L.detach().numpy().copy())
            tl, rl = losses
        out["jax"]["losses"].append(onp.asarray(jl, "f"))
        out["port"]["losses"].append(tl)
        out["ref"]["losses"].append(rl)
    if how == "train_step":
        out["port"]["step"] = tstep
        out["jax"]["step"] = jstep
    for side, net in (("jax", jnet), ("port", tnet), ("ref", tref)):
        out[side]["params"] = {
            n: (p.data().asnumpy() if side == "jax"
                else p._tensor().detach().numpy()).copy()
            for n, p in sorted(net.collect_params().items())}
        out[side]["net"] = net
    return out


_RUNS = {}


@pytest.fixture(scope="module")
def runs():
    def get(label, how):
        if (label, how) not in _RUNS:
            _RUNS[label, how] = _train(label, how)
        return _RUNS[label, how]
    return get


def _jax_shards(arr, mesh):
    """{mesh position (flat index): shard data} of a JAX array."""
    flat = list(mesh.devices.flat)
    return {flat.index(s.device): onp.asarray(s.data)
            for s in arr.addressable_shards}


def _check_blocks(out, shards=True):
    """Each position's block of every weight and of its momentum: equal to
    the JAX array's shard at the same mesh position (``shards``: the JAX
    step pins its layouts, as its whole step does), else to that block of
    the JAX array's logical value (its eager step lets XLA choose the
    updated arrays' layouts)."""
    jplan, tplan = out["jax"]["plan"], out["port"]["plan"]
    jtr, ttr = out["jax"]["trainer"], out["port"]["trainer"]
    jp = dict(out["jax"]["net"].collect_params().items())
    tp = dict(out["port"]["net"].collect_params().items())
    assert tplan.axis_sizes() == dict(jplan.mesh.shape)
    for name in sorted(jp):
        i = jtr._param_names.index(name)
        pairs = [(jp[name].data()._data, tp[name].placement)]
        if jtr._states[i] is not None:
            pairs.append((jtr._states[i]._data,
                          ttr._states[ttr._param_names.index(name)]))
        for jarr, placed in pairs:
            if shards:
                assert str(placed.layout.spec) == str(jarr.sharding.spec), \
                    name
                want = _jax_shards(jarr, jplan.mesh)
            else:
                whole = onp.asarray(jarr)
                want = {k: whole[tuple(slice(a, b) for a, b in blk)]
                        for k, blk in enumerate(placed.layout.blocks)}
            assert sorted(want) == list(range(len(placed.shards)))
            for k, block in enumerate(placed.shards):
                assert tuple(block.shape) == want[k].shape, (name, k)
                onp.testing.assert_allclose(block.numpy(), want[k],
                                            rtol=1e-6, atol=1e-7,
                                            err_msg=f"{name} at {k}")


@pytest.mark.parametrize("label", sorted(PLANS))
def test_trainer_step_under_plans(runs, label):
    """Trainer.step: the JAX package's losses and parameters within 1e-6,
    the unplaced port run bit for bit, every block as JAX lays it."""
    out = runs(label, "trainer")
    for a, b in zip(out["port"]["losses"], out["jax"]["losses"]):
        onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    for n, v in out["port"]["params"].items():
        onp.testing.assert_allclose(v, out["jax"]["params"][n], rtol=1e-6,
                                    atol=1e-7, err_msg=n)
        onp.testing.assert_array_equal(v, out["ref"]["params"][n],
                                       err_msg=n)
    for a, b in zip(out["port"]["losses"], out["ref"]["losses"]):
        onp.testing.assert_array_equal(a, b)
    _check_blocks(out, shards=False)


@pytest.mark.parametrize("label", sorted(PLANS))
def test_train_step_under_plans(runs, label):
    """TrainStep: the port's whole step (the shard_map form under dp=4,
    the logical one under the plans that shard parameters) within 1e-6 of
    the JAX package's whole step (its phased step under dp=4, see
    ``_train``), the fsdp/tp plans bit for bit against the port's unplaced
    TrainStep, every block as JAX lays it."""
    out = runs(label, "train_step")
    ts, js = out["port"]["step"], out["jax"]["step"]
    assert ts.last_path == "whole_step", ts.ineligible_reason()
    assert js.last_path == ("phased" if label == "dp4" else "whole_step")
    assert ts.jit_trace_count() == 1
    assert ts._form == ("mesh" if label == "dp4" else "gspmd")
    for a, b in zip(out["port"]["losses"], out["jax"]["losses"]):
        onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    for n, v in out["port"]["params"].items():
        onp.testing.assert_allclose(v, out["jax"]["params"][n], rtol=1e-6,
                                    atol=1e-7, err_msg=n)
        if label != "dp4":
            onp.testing.assert_array_equal(v, out["ref"]["params"][n],
                                           err_msg=n)
    _check_blocks(out, shards=label != "dp4")


def test_shard_params_shard_batch_and_the_store(runs):
    """``shard_params``/``shard_batch`` lay blocks out as the JAX package's
    do (with its divisibility message), and the store's
    ``allreduce_sharded``/``reduce_scatter_sharded`` give its results,
    their mesh and axis taken from the adopted plan."""
    jmesh4 = jmesh.make_mesh({"dp": 2, "tp": 2}, jax.devices()[:4])
    tmesh4 = tmesh.make_mesh({"dp": 2, "tp": 2}, [mt.cpu()] * 4)
    jnet = _jax_net()
    tnet = _port_net(jnet)

    def spec(name, shape):  # noqa: ARG001
        return ("tp", None) if name.endswith("weight") else None

    jmesh.shard_params(jnet.collect_params(), jmesh4,
                       spec_fn=lambda n, s: JP(*spec(n, s))
                       if spec(n, s) else None)
    assert tmesh.shard_params(tnet.collect_params(), tmesh4,
                              spec_fn=spec) is tmesh4
    for name, p in tnet.collect_params().items():
        want = _jax_shards(jnet.collect_params()[name].data()._data, jmesh4)
        for k, block in enumerate(p.placement.shards):
            onp.testing.assert_array_equal(block.numpy(), want[k])
        onp.testing.assert_array_equal(p.placement.full().numpy(),
                                       p._tensor().detach().numpy())
    x = XS[0]
    jb = jmesh.shard_batch(jax.numpy.asarray(x), jmesh4, "dp")
    tb = tmesh.shard_batch(torch.from_numpy(x), tmesh4, "dp")
    want = _jax_shards(jb, jmesh4)
    assert [tuple(b.shape) for b in tb.shards] == [want[k].shape
                                                   for k in range(4)]
    for k, block in enumerate(tb.shards):
        onp.testing.assert_array_equal(block.numpy(), want[k])

    def message(fn, *a, **kw):
        with pytest.raises(Exception) as e:
            fn(*a, **kw)
        return str(e.value)

    bad = {"w": tnet.collect_params()["0.weight"]}
    assert message(tmesh.shard_params, bad, tmesh4,
                   spec_fn=lambda n, s: ("dp", None, "tp")) == message(
        jmesh.shard_params, {"w": jnet.collect_params()["0.weight"]},
        jmesh4, spec_fn=lambda n, s: JP("dp", None, "tp"))

    # the store, with the plan of a trained run adopted
    out = runs("dp2_fsdp2_tp2", "trainer")
    tkv, jkv = out["port"]["trainer"]._kvstore, out["jax"]["trainer"]._kvstore
    assert tkv._sharding_plan is out["port"]["plan"]
    tree = {"a": R.randn(8, 3).astype("f"), "b": R.randn(4).astype("f")}
    jt = {k: jax.device_put(v, jax.sharding.NamedSharding(
        out["jax"]["plan"].mesh, JP("dp"))) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    got, want = tkv.allreduce_sharded(tt), jkv.allreduce_sharded(jt)
    for k in tree:
        onp.testing.assert_allclose(got[k].numpy(), onp.asarray(want[k]),
                                    rtol=1e-6)
    got = tkv.reduce_scatter_sharded(tt)
    want = jkv.reduce_scatter_sharded(
        {k: jax.numpy.asarray(v) for k, v in tree.items()})
    for k in tree:
        onp.testing.assert_allclose(got[k].numpy(), onp.asarray(want[k]),
                                    rtol=1e-6)
    # the traced sum over positions, as the flat psum of the same blocks
    per = [{k: torch.from_numpy(v[2 * j:2 * j + 2].copy())
            for k, v in tree.items() if k == "a"} for j in range(4)]
    summed = tkv.traced_allreduce(per)
    ref = jcol.psum_tree_flat({"a": jax.numpy.asarray(tree["a"])},
                              jmesh.make_mesh({"dp": 4},
                                              jax.devices()[:4]), "dp")
    for s in summed:
        onp.testing.assert_allclose(s["a"].numpy(), onp.asarray(ref["a"]),
                                    rtol=1e-6)
    assert tcol.psum_tree_flat_traced([[torch.ones(2)]] * 3)[1][0].tolist() \
        == [3.0, 3.0]


def test_data_parallel_step_with_param_specs():
    """``make_data_parallel_step(param_specs=)`` over a dp=2,tp=2 mesh: the
    JAX package's step's numbers (rtol 1e-5), and its divisibility error
    names the parameter."""
    rs = onp.random.RandomState(2)
    params = {"w1": rs.randn(6, 8).astype("f") * 0.5,
              "b1": rs.randn(8).astype("f") * 0.1,
              "w2": rs.randn(8, 3).astype("f") * 0.5}
    jspecs = {"w1": JP(None, "tp"), "b1": JP("tp"), "w2": JP("tp", None)}
    tspecs = {"w1": tmesh.PartitionSpec(None, "tp"),
              "b1": tmesh.PartitionSpec("tp"),
              "w2": tmesh.PartitionSpec("tp", None)}
    jm = jmesh.make_mesh({"dp": 2, "tp": 2}, jax.devices()[:4])
    tm = tmesh.make_mesh({"dp": 2, "tp": 2}, [mt.cpu()] * 4)

    def jloss(p, b):
        h = jax.numpy.tanh(b[0] @ p["w1"] + p["b1"])
        return jax.numpy.mean((h @ p["w2"] - b[1]) ** 2)

    def tloss(p, b):
        h = torch.tanh(b[0] @ p["w1"] + p["b1"])
        return torch.mean((h @ p["w2"] - b[1]) ** 2)

    def jupd(p, g, s, lr):
        s = jax.tree_util.tree_map(lambda m, d: 0.9 * m + d, s, g)
        return jax.tree_util.tree_map(lambda w, m: w - lr * m, p, s), s

    def tupd(p, g, s, lr):
        s = {k: 0.9 * s[k] + g[k] for k in s}
        return {k: p[k] - lr * s[k] for k in p}, s

    jstep = jdp.make_data_parallel_step(jloss, jupd, jm, param_specs=jspecs)
    tstep = tdp.make_data_parallel_step(tloss, tupd, tm, param_specs=tspecs)
    jp = {k: jax.device_put(v, jax.sharding.NamedSharding(jm, jspecs[k]))
          for k, v in params.items()}
    js = jax.tree_util.tree_map(jax.numpy.zeros_like, jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = {k: torch.zeros_like(v) for k, v in tp.items()}
    for x, y in zip(XS, YS):
        b = (x[:, :6], y[:, :3])
        jp, js, jl = jstep(jp, js, tuple(jax.numpy.asarray(a) for a in b),
                           0.05)
        tp, ts, tl = tstep(tp, ts, tuple(torch.from_numpy(a.copy())
                                         for a in b), 0.05)
        onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl), rtol=1e-5)
    for k in params:
        onp.testing.assert_allclose(tp[k].numpy(), onp.asarray(jp[k]),
                                    rtol=1e-5, atol=1e-6, err_msg=k)
    bad = tdp.make_data_parallel_step(
        tloss, tupd, tm, param_specs={"w1": tmesh.PartitionSpec(("dp", "tp"))})
    with pytest.raises(tmesh.ShardingError,
                       match=r"parameter w1 with shape \(6, 8\)"):
        bad(tp, ts, (torch.zeros(4, 6), torch.zeros(4, 3)), 0.1)


def test_other_updates_under_a_plan_and_state_files(tmp_path):
    """Under dp=2,fsdp=2,tp=2 through Trainer.step, bit for bit with the
    unplaced run: AdamW with clip_global_norm (the norm over the logical
    gradients, then K3's plain version block by block) and LAMB (its trust
    ratios need the whole weight: the logical update, written through);
    every block stays its slice; the placed trainer's state file loads
    into an unplaced one."""
    from mxnet_tpu_torch.gluon import _sharded

    jnet = _jax_net()
    for opt, kw in (("adamw", {"learning_rate": 0.01, "wd": 0.01,
                               "clip_global_norm": 0.5}),
                    ("lamb", {"learning_rate": 0.01})):
        outs = []
        for planned in (True, False):
            net = _port_net(jnet)
            plan = TPlan.from_layout("dp=2,fsdp=2,tp=2", net=net,
                                     devices=[mt.cpu()] * 8) \
                if planned else None
            tr = mt.gluon.Trainer(net.collect_params(), opt, dict(kw),
                                  sharding_plan=plan)
            for x, y in zip(XS, YS):
                with mt.autograd.record():
                    L = mt.gluon.loss.L2Loss()(net(torch.from_numpy(x)),
                                               torch.from_numpy(y))
                mt.autograd.backward(L)
                tr.step(BATCH)
            outs.append((net, tr))
        (pnet, ptr), (rnet, rtr) = outs
        for (n, p), q in zip(pnet.collect_params().items(),
                             rnet.collect_params().values()):
            assert torch.equal(p._tensor(), q._tensor()), (opt, n)
            for blk, shard in zip(p.placement.layout.blocks,
                                  p.placement.shards):
                assert torch.equal(shard, p._tensor().detach()[
                    tuple(slice(a, b) for a, b in blk)]), (opt, n)
        for a, b in zip(ptr._states, rtr._states):
            for x, y in zip(_sharded._leaves(_sharded.full_state(a)),
                            _sharded._leaves(b)):
                assert torch.equal(x, y), opt
    ptr.save_states(str(tmp_path / "s"))
    fresh = mt.gluon.Trainer(_port_net(jnet).collect_params(), "lamb",
                             {"learning_rate": 0.01})
    fresh.load_states(str(tmp_path / "s"))
    for a, b in zip(fresh._states, rtr._states):
        for x, y in zip(_sharded._leaves(a), _sharded._leaves(b)):
            assert torch.equal(x, y)
