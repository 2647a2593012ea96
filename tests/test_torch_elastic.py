"""Elastic training (mxnet_tpu_torch/elastic, the checkpoint manager's plan
gate, tools/ckpt.py's reshard and verify --mesh) against the JAX package's
on the 8 virtual CPU devices of tests/conftest.py, the port on CPU
positions: plan world sizes and compatibility verdicts; a checkpoint the
JAX package writes under fsdp=4 (its ZeRO state a quarter a device)
restored in the port under dp=2,fsdp=2 and under no plan, and the other
way round, bit for bit (``verify_parity`` against the checkpoint's own
arrays, and every placed block against its slice); the PlanMismatch gate
and ``resharded_restore``; ``reshard_checkpoint`` and the CLI's exit codes
beside the JAX tool's; ``reenter`` from dp=4 to dp=2 with the linear LR
rule (its report and the next losses against the JAX package's reenter);
``RestartPolicy.decide`` and the ``RestartLedger`` file both ways."""
import importlib.util
import json
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.checkpoint import manager as jmgr_mod
from mxnet_tpu_torch.checkpoint import manager as tmgr_mod
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.tools import ckpt as tckpt

REPO = os.path.join(os.path.dirname(__file__), "..")
BATCH, FEATS, OUT = 16, 12, 4
R = onp.random.RandomState(3)
XS = [R.standard_normal((BATCH, FEATS)).astype("f") for _ in range(6)]
YS = [R.standard_normal((BATCH, OUT)).astype("f") for _ in range(6)]
JE, TE = mx.elastic, mt.elastic


@pytest.fixture(autouse=True)
def _isolate_jax_globals():
    """The JAX package's plans stamp its flight identity and reenter()
    bumps both packages' generation: restore them."""
    from mxnet_tpu.elastic import reentry
    from mxnet_tpu.observability import flight
    from mxnet_tpu_torch.elastic import reentry as treentry

    ident = dict(flight._identity)
    gen, tgen = reentry._generation[0], treentry._generation[0]
    yield
    flight._identity.clear()
    flight._identity.update(ident)
    reentry._generation[0] = gen
    treentry._generation[0] = tgen


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


def _n(axes):
    n = 1
    for part in axes.split(","):
        n *= int(part.split("=")[1])
    return n


def _jax_trainer(axes, steps, layout=True, whole=True):
    """A JAX trainer under ``axes`` (None: no plan) after ``steps`` steps
    of its TrainStep (phased with ``whole=False``)."""
    net = _jax_net()
    plan = None
    if axes:
        plan = (mx.sharding.ShardingPlan.from_layout(axes, net=net)
                if layout else mx.sharding.ShardingPlan(axes))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9},
                          kvstore="tpu_dist" if plan else None,
                          sharding_plan=plan)
    step = mx.gluon.TrainStep(net, mx.gluon.loss.L2Loss(), tr)
    losses = [_jax_call(step, k, whole) for k in range(steps)]
    return net, tr, step, losses


def _jax_call(step, k, whole):
    if not whole:
        os.environ["MXTPU_WHOLE_STEP"] = "0"
    try:
        return step(mx.np.array(XS[k]), mx.np.array(YS[k])).asnumpy()
    finally:
        os.environ.pop("MXTPU_WHOLE_STEP", None)


def _port_trainer(axes, steps, jnet=None, layout=True):
    net = _port_net(jnet if jnet is not None else _jax_net())
    plan = None
    if axes:
        kw = dict(devices=[mt.cpu()] * _n(axes))
        plan = (mt.sharding.ShardingPlan.from_layout(axes, net=net, **kw)
                if layout else mt.sharding.ShardingPlan(axes, **kw))
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9},
                          sharding_plan=plan)
    step = mt.gluon.TrainStep(net, mt.gluon.loss.L2Loss(), tr)
    losses = [step(torch.from_numpy(XS[k]), torch.from_numpy(YS[k])).numpy()
              for k in range(steps)]
    return net, tr, step, losses


def _arrays(mgr_mod, directory, step):
    d = os.path.join(str(directory), mgr_mod._STEP_FMT.format(step))
    return mgr_mod._read_checkpoint(d)[0]


def _blocks_are_slices(tr):
    """Every placed block of every weight and state leaf is that slice of
    the logical value."""
    from mxnet_tpu_torch.gluon import _sharded

    for p, st in zip(tr._params, tr._states):
        for placed in [p.placement] + _sharded.placed_leaves(st):
            whole = placed.full()
            for blk, shard in zip(placed.layout.blocks, placed.shards):
                assert torch.equal(
                    shard, whole[tuple(slice(a, b) for a, b in blk)])


def test_plan_world_size_and_compatibility(monkeypatch):
    for m in (None, {"axes": [["dp", 4]]},
              {"axes": [["dp", 2], ["fsdp", 2], ["tp", 2]]}):
        assert TE.plan_world_size(m) == JE.plan_world_size(m)
    monkeypatch.setenv("MXTPU_ZERO", "1")
    saved = mt.sharding.ShardingPlan.from_layout("dp=2,fsdp=4")
    assert saved.to_manifest() == \
        mx.sharding.ShardingPlan.from_layout("dp=2,fsdp=4").to_manifest()
    for a, b in (("dp=4", "dp=4"), ("dp=4", "dp=2,fsdp=2"),
                 ("dp=4", "dp=2"), ("dp=4", None), (None, None),
                 (saved.to_manifest(), "dp=4")):
        assert TE.plan_compatibility(a, b) == JE.plan_compatibility(a, b)
    assert tmgr_mod.plan_compatibility is TE.plan_compatibility


def test_checkpoints_cross_packages_and_plans(tmp_path):
    """JAX fsdp=4 -> port dp=2,fsdp=2 (same world: placed silently) and
    no plan; port dp=2,fsdp=2 -> JAX fsdp=4 and no plan: every restore
    bit for bit against the checkpoint's arrays."""
    jnet, jtr, _, _ = _jax_trainer("fsdp=4", 3)
    jdir = tmp_path / "jax"
    jm = mx.checkpoint.CheckpointManager(jdir, jtr)
    jm.save(step=3)
    jm.flush()
    arrays = _arrays(tmgr_mod, jdir, 3)
    assert json.loads((jdir / "step-00000003" / "MANIFEST.json")
                      .read_text())["meta"]["sharding_plan"]["axes"] == \
        [["fsdp", 4]]
    for axes in ("dp=2,fsdp=2", None):
        _, ttr, _, _ = _port_trainer(axes, 1)
        res = mt.checkpoint.CheckpointManager(jdir, ttr).restore()
        assert res.step == 3
        assert TE.verify_parity(ttr, arrays) == 8
        if axes:
            _blocks_are_slices(ttr)
            st = ttr._states[ttr._param_names.index("0.weight")]
            assert [tuple(s.shape) for s in st.shards] == [(16, 6)] * 4
    # the port writes under dp=2,fsdp=2: the JAX package restores it
    _, ttr, _, _ = _port_trainer("dp=2,fsdp=2", 3)
    tdir = tmp_path / "port"
    tm = mt.checkpoint.CheckpointManager(tdir, ttr)
    tm.save(step=3)
    tm.flush()
    tarrays = _arrays(jmgr_mod, tdir, 3)
    for axes in ("fsdp=4", None):
        _, jtr2, _, _ = _jax_trainer(axes, 1)
        assert mx.checkpoint.CheckpointManager(tdir, jtr2).restore() \
            .step == 3
        assert JE.verify_parity(jtr2, tarrays) == 8
    # another world size: the gate, then the front door
    _, ttr8, _, _ = _port_trainer("dp=2,fsdp=2,tp=2", 1)
    with pytest.raises(mt.checkpoint.PlanMismatch,
                       match="allow_reshard") as e:
        mt.checkpoint.CheckpointManager(jdir, ttr8).restore()
    assert e.value.saved_plan["axes"] == [["fsdp", 4]]
    assert e.value.target_plan["axes"] == [["dp", 2], ["fsdp", 2],
                                           ["tp", 2]]
    res, compat = TE.resharded_restore(
        mt.checkpoint.CheckpointManager(jdir, ttr8))
    assert compat["verdict"] == "reshard" and res.step == 3
    assert TE.verify_parity(ttr8, arrays) == 8
    _blocks_are_slices(ttr8)


def test_reshard_checkpoint_and_the_cli(tmp_path, capsys):
    """reshard_checkpoint and the CLI's verify --mesh / reshard: the
    same reports and exit codes as the JAX tool on the same checkpoint;
    the output restores as an exact plan match."""
    spec = importlib.util.spec_from_file_location(
        "_jckpt", os.path.join(REPO, "tools", "ckpt.py"))
    jckpt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jckpt)
    _, ttr, _, _ = _port_trainer("dp=2,fsdp=2", 2)
    src = tmp_path / "src"
    mgr = mt.checkpoint.CheckpointManager(src, ttr)
    mgr.save(step=2)
    mgr.flush()
    report = TE.reshard_checkpoint(src, tmp_path / "dst", "dp=4",
                                   target_world=2, mode="sharded")
    assert report["compatibility"]["verdict"] == "replace"
    check = mt.checkpoint.verify_checkpoint(tmp_path / "dst")
    assert check["ok"] and check["sharding_plan"]["axes"] == [["dp", 4]]
    _, tr4, _, _ = _port_trainer("dp=4", 1, layout=False)
    mt.checkpoint.CheckpointManager(tmp_path / "dst", tr4).restore()
    assert TE.verify_parity(tr4, _arrays(tmgr_mod, src, 2)) == 8

    def both(argv):
        out = []
        for tool in (tckpt, jckpt):
            rc = tool.main(argv)
            text = capsys.readouterr().out
            out.append((rc, json.loads(text) if "--json" in argv else None))
        return out

    (trc, trep), (jrc, jrep) = both(["verify", str(src), "--mesh",
                                     "dp=2,fsdp=2,tp=2", "--json"])
    assert trc == jrc == 0 and trep["plan"] == jrep["plan"]
    assert trep["plan"]["verdict"] == "reshard"
    for argv in (["verify", str(tmp_path / "nowhere")],
                 ["verify", str(src), "--step", "9"]):
        assert [rc for rc, _ in both(argv)] == [2, 2]
    (trc, trep), (jrc, jrep) = both(
        ["reshard", str(src), "--dest", str(tmp_path / "d2"), "--mesh",
         "replicated", "--json"])
    assert trc == jrc == 0
    assert trep["compatibility"] == jrep["compatibility"]
    # a damaged payload: 1 from both tools
    payload = tmp_path / "d2" / "step-00000002" / "arrays.npz"
    payload.write_bytes(payload.read_bytes()[:-64])
    assert [rc for rc, _ in both(["verify", str(tmp_path / "d2")])] == \
        [1, 1]


def test_reenter_dp4_to_dp2_against_jax():
    """reenter() a live trainer and TrainStep from dp=4 to dp=2 with the
    linear LR rule: the same report as the JAX package's reenter, one new
    capture, and the next losses within 1e-6 of the JAX package's (its
    phased steps: its shard_map whole step scales the gradients by the
    axis size under this jax, ROADMAP.md queue 3)."""
    jnet, jtr, jstep, jl = _jax_trainer("dp=4", 2, layout=False,
                                        whole=False)
    tnet, ttr, tstep, tl = _port_trainer("dp=4", 2, jnet=_jax_net(),
                                         layout=False)
    for a, b in zip(tl, jl):
        onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    g0 = TE.world_generation()
    captures = tstep.jit_trace_count()
    tinfo = TE.reenter(ttr, mt.sharding.ShardingPlan(
        "dp=2", devices=[mt.cpu()] * 2), train_step=tstep,
        lr_rescale="linear")
    jinfo = JE.reenter(jtr, mx.sharding.ShardingPlan("dp=2"),
                       train_step=jstep, lr_rescale="linear")
    assert {k: tinfo[k] for k in jinfo if k != "generation"} == \
        {k: jinfo[k] for k in jinfo if k != "generation"}
    assert (tinfo["old_world"], tinfo["new_world"], tinfo["lr_factor"]) \
        == (4, 2, 0.5)
    assert tinfo["generation"] == g0 + 1 == TE.world_generation()
    assert ttr.learning_rate == jtr.learning_rate == 0.05
    assert all(len(p.placement.shards) == 2 for p in ttr._params)
    for k in range(2, 5):
        jloss = _jax_call(jstep, k, whole=False)
        tloss = tstep(torch.from_numpy(XS[k]), torch.from_numpy(YS[k]))
        onp.testing.assert_allclose(tloss.numpy(), jloss, rtol=1e-6,
                                    atol=1e-7)
    assert tstep.jit_trace_count() == captures + 1
    assert tstep.last_path == "whole_step"
    for n, p in tnet.collect_params().items():
        onp.testing.assert_allclose(
            p._tensor().detach().numpy(),
            jnet.collect_params()[n].data().asnumpy(), rtol=1e-6,
            atol=1e-7, err_msg=n)
    _blocks_are_slices(ttr)
    assert TE.rescale_factor(4, 2, "sqrt") == JE.rescale_factor(4, 2,
                                                                 "sqrt")
    with pytest.raises(ValueError, match="linear"):
        TE.rescale_factor(4, 2, "cubic")


def test_restart_policy_and_ledger(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_CKPT_PREEMPT_EXIT_CODE", "42")
    for kw in (dict(max_restarts=2, backoff_s=0.5, backoff_max_s=10), {},
               dict(max_restarts=-1, backoff_s=0.0)):
        tp, jp = TE.RestartPolicy(**kw), JE.RestartPolicy(**kw)
        assert (tp.max_restarts, tp.backoff_s, tp.backoff_max_s,
                tp.clean_exit_codes) == (jp.max_restarts, jp.backoff_s,
                                         jp.backoff_max_s,
                                         jp.clean_exit_codes)
        for codes in ({0: 0, 1: 0}, {0: None, 1: -9}, {0: -9}, [42, 0],
                      {0: -9}, [1], [1]):
            assert tp.decide(codes) == jp.decide(codes), (kw, codes)
    TE.RestartLedger(tmp_path / "a").append(event="launch", generation=0,
                                            world=2)
    JE.RestartLedger(str(tmp_path / "a")).append(
        event="restart", generation=0, world=2, dead_ranks=[1])
    got = TE.RestartLedger(tmp_path / "a").entries()
    assert [e["event"] for e in got] == ["launch", "restart"]
    assert got == JE.RestartLedger(str(tmp_path / "a")).entries()
    assert TE.LEDGER_NAME == JE.LEDGER_NAME
    monkeypatch.setenv("MXTPU_ELASTIC_GENERATION", "3")
    assert TE.current_generation() == JE.current_generation() == 3
