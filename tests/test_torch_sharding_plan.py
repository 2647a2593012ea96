"""Sharding plans (mxnet_tpu_torch/sharding: ShardingPlan, SpecLayout,
the recipes) against the JAX package's (mxnet_tpu/sharding) on the 8
virtual CPU devices of tests/conftest.py, the port's plans over CPU
positions: the axis spellings, ``mode``/``resolve_plan`` under the env
variables (``MXTPU_SPEC_LAYOUT=0`` too), spec precedence, every parameter's spec and ZeRO state spec of
a small BERT (2 layers, 64 units, 4 heads) under ``from_layout``, plan
manifests read by the other package, the recipes, the ``ShardingError``
messages, and what ``apply`` records. Specs are compared by their text
(both print as ``jax.sharding.PartitionSpec`` does)."""
import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu_torch import telemetry as ttelemetry
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.telemetry import instruments as ti

J, T = mx.sharding, mt.sharding
CPU8 = [mt.cpu()] * 8
SMALL = dict(num_layers=2, units=64, hidden_size=128, num_heads=4)


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


@pytest.fixture(scope="module")
def berts():
    jnet = jbert.BERTForQA(jbert.bert_12_768_12(**SMALL))
    jnet.initialize()
    tnet = tbert.BERTForQA(tbert.bert_12_768_12(**SMALL))
    tnet.initialize(device=mt.cpu())
    return jnet, tnet


def _err(fn, *a, **kw):
    with pytest.raises(Exception) as e:
        fn(*a, **kw)
    return type(e.value).__name__, str(e.value)


def test_parse_axes_mode_and_resolve_plan(monkeypatch):
    for spec in ("dp=4,tp=2", "dp=4, tp=2", {"dp": 4, "tp": 2},
                 (("dp", 4), ("tp", 2)), "dp=-1"):
        assert T.parse_axes(spec) == J.parse_axes(spec)
    for bad in ("dp", "dp=x", "dp=2,dp=2", "", "dp=0"):
        assert _err(T.parse_axes, bad) == _err(J.parse_axes, bad)
    for raw in ("off", "0", "false", "none", "", "auto", "1", "on", "AUTO",
                "plan", "explicit", "sideways"):
        monkeypatch.setenv("MXTPU_SHARDING", raw)
        if raw == "sideways":
            assert _err(T.mode) == _err(J.mode)
        else:
            assert T.mode() == J.mode(), raw
    monkeypatch.setenv("MXTPU_SHARDING", "off")
    assert T.resolve_plan((("dp", -1),)) is None
    monkeypatch.setenv("MXTPU_SHARDING", "auto")
    assert T.resolve_plan(None) is None
    monkeypatch.setenv("MXTPU_MESH", "dp=4,tp=2")
    assert T.resolve_plan(None).axes == J.resolve_plan(None).axes
    assert T.resolve_plan("dp=-1").axes == (("dp", -1),)
    monkeypatch.setenv("MXTPU_MESH", "dp=2,fsdp=2,tp=2")
    for side in (T, J):    # an env mesh naming fsdp/tp takes the layout
        assert side.ShardingPlan.from_env().layout is not None
    # MXTPU_SPEC_LAYOUT=0, the layout's switch: the env plan keeps its
    # axes and places no parameter, in both packages
    monkeypatch.setenv("MXTPU_SPEC_LAYOUT", "0")
    tbare, jbare = T.ShardingPlan.from_env(), J.ShardingPlan.from_env()
    assert tbare.layout is None and jbare.layout is None
    assert tbare.axes == jbare.axes
    pairs = [("bert.encoder.layers.0.ffn.ffn_1.weight", (3072, 768)),
             ("bert.word_embed.weight", (30522, 768))]
    for name, shape in pairs:
        assert str(tbare.spec_for(name, shape)) == \
            str(jbare.spec_for(name, shape)) == "PartitionSpec()"
    assert tbare.shards_params(pairs) is jbare.shards_params(pairs) is False
    monkeypatch.delenv("MXTPU_SPEC_LAYOUT")
    monkeypatch.setenv("MXTPU_SHARDING", "plan")
    assert T.resolve_plan(None) is None
    assert T.resolve_plan("dp=2").axes == (("dp", 2),)
    monkeypatch.setenv("MXTPU_SHARDING", "auto")
    wrapped = T.resolve_plan(tmesh.make_mesh({"data": -1}, CPU8))
    assert wrapped.axis_sizes() == {"data": 8}
    assert wrapped.batch_axis == "data"


def test_spec_precedence_and_predicates():
    def plans(side, spec):
        return side.ShardingPlan(
            "dp=4,tp=2", rules=[(r".*weight", ("tp", None)), (r".*", None)],
            spec_fn=lambda name, shape: spec(None, "tp")
            if "special" in name else None)

    tp = plans(T, tmesh.PartitionSpec)
    jp = plans(J, jmesh.PartitionSpec)
    for name, shape in (("special.weight", (8, 4)), ("dense0.weight",
                                                      (8, 4)),
                        ("dense0.bias", (8,))):
        assert str(tp.spec_for(name, shape)) == str(jp.spec_for(name, shape))
    assert str(T.ShardingPlan("dp=-1").spec_for("x", (3,))) == \
        str(J.ShardingPlan("dp=-1").spec_for("x", (3,)))
    for pairs in ([("dense0.weight", (8, 4))], [("dense0.bias", (8,))]):
        assert tp.shards_params(pairs) == jp.shards_params(pairs)
    assert tp.data_spec() == tmesh.PartitionSpec("dp")
    assert _err(T.ShardingPlan, "dp=-1", batch_axis="sp") == \
        _err(J.ShardingPlan, "dp=-1", batch_axis="sp")
    assert T.ShardingPlan("dp=-1", devices=CPU8).process_coords() == \
        {"dp": 0}


def test_bert_layout_specs_equal_the_jax_package(berts, monkeypatch):
    """Every parameter of a small BERT: the block walk's role, and under
    ``from_layout("dp=2,fsdp=2,tp=2")`` its spec and its ZeRO state spec,
    as the JAX package gives them; MXTPU_ZERO=0 drops the state specs to
    the weights' in both."""
    jnet, tnet = berts
    assert T.block_roles(tnet) == J.block_roles(jnet)
    jps, tps = jnet.collect_params(), tnet.collect_params()
    assert sorted(jps) == sorted(tps)
    for zero in ("1", "0"):
        monkeypatch.setenv("MXTPU_ZERO", zero)
        jp = J.ShardingPlan.from_layout("dp=2,fsdp=2,tp=2", net=jnet)
        tp = T.ShardingPlan.from_layout("dp=2,fsdp=2,tp=2", net=tnet,
                                        devices=CPU8)
        for n in jps:
            shape = jps[n].shape
            assert str(tp.spec_for(n, shape)) == str(jp.spec_for(n, shape))
            assert str(tp.state_spec_for(n, shape)) == \
                str(jp.state_spec_for(n, shape)), n
        pairs = [(n, jps[n].shape) for n in jps]
        assert tp.shards_params(pairs) == jp.shards_params(pairs)
        assert tp.shards_state(pairs) == jp.shards_state(pairs)
        assert tp.zero_axis() == jp.zero_axis()
    # names alone (an env plan that never sees the net)
    for n in jps:
        assert T.role_from_name(n, jps[n].shape) == \
            J.role_from_name(n, jps[n].shape)
    for spec, shape, sizes in (((), (8, 6), {"fsdp": 2}),
                               (("tp",), (8, 6), {"fsdp": 2, "tp": 2}),
                               (("fsdp",), (8,), {"fsdp": 2}),
                               ((), (3, 5), {"fsdp": 2})):
        assert str(T.zero_state_spec(tmesh.PartitionSpec(*spec), shape,
                                     sizes, "fsdp")) == \
            str(J.zero_state_spec(jmesh.PartitionSpec(*spec), shape,
                                  sizes, "fsdp"))


def test_manifests_cross_packages(berts):
    jnet, tnet = berts
    cases = [("dp=-1,tp=2", dict(rules=[(r".*weight", ("tp", None))])),
             ("dp=2,fsdp=2,tp=2", None)]
    for axes, kw in cases:
        if kw is None:
            jp = J.ShardingPlan.from_layout(axes, net=jnet)
            tp = T.ShardingPlan.from_layout(axes, net=tnet, devices=CPU8)
        else:
            jp = J.ShardingPlan(axes, **kw)
            tp = T.ShardingPlan(axes, devices=CPU8, **kw)
        assert tp.to_manifest() == jp.to_manifest()      # sizes as given
        jp.mesh, tp.mesh                                  # noqa: B018
        assert tp.to_manifest() == jp.to_manifest()      # sizes resolved
        jback = J.ShardingPlan.from_manifest(tp.to_manifest())
        tback = T.ShardingPlan.from_manifest(jp.to_manifest(),
                                             devices=CPU8)
        assert tback.axes == jback.axes and tback.layout == tp.layout
        for n, p in jnet.collect_params().items():
            assert str(tback.spec_for(n, p.shape)) == \
                str(jback.spec_for(n, p.shape))
    assert T.ShardingPlan.from_manifest(None) is None


def test_recipes_and_plan_recipe(berts):
    jnet, tnet = berts
    assert T.RECIPES == J.RECIPES
    for name in sorted(J.RECIPES):
        tp = T.plan_recipe(name, net=tnet)
        jp = J.plan_recipe(name, net=jnet)
        assert tp.axes == jp.axes and (tp.layout is None) == \
            (jp.layout is None), name
    assert _err(T.plan_recipe, "nope") == _err(J.plan_recipe, "nope")
    assert T.DEFAULT_LAYOUT.model_axes() == J.DEFAULT_LAYOUT.model_axes()


def test_sharding_error_messages():
    """The divisibility and mesh errors name the parameter and the spec
    in the JAX package's words; a plan naming no positions spans the
    cards and raises without one."""
    tm = tmesh.make_mesh({"dp": 4, "tp": 2}, CPU8)
    jm = J.ShardingPlan("dp=4,tp=2").mesh
    tnet = mt.gluon.nn.Dense(6, in_units=5)
    tnet.initialize(device=mt.cpu())
    jnet = mx.gluon.nn.Dense(6, in_units=5)
    jnet.initialize()
    for tspec, jspec in (
            (lambda n, s: ("dp",) if "weight" in n else None,
             lambda n, s: jmesh.PartitionSpec("dp") if "weight" in n
             else None),
            (lambda n, s: ("nope",), lambda n, s: jmesh.PartitionSpec(
                "nope"))):
        assert _err(tmesh.shard_params, tnet.collect_params(), tm,
                    spec_fn=tspec) == \
            _err(jmesh.shard_params, jnet.collect_params(), jm,
                 spec_fn=jspec)
    assert _err(lambda: T.ShardingPlan("dp=3,tp=-1", devices=CPU8).mesh) \
        == _err(lambda: J.ShardingPlan("dp=3,tp=-1").mesh)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError, match="CUDA"):
            T.ShardingPlan("dp=-1").mesh    # noqa: B018


def test_apply_records_the_plan_table_and_telemetry():
    jnet = mx.gluon.nn.Dense(8, in_units=4)
    jnet.initialize()
    tnet = mt.gluon.nn.Dense(8, in_units=4)
    tnet.initialize(device=mt.cpu())
    jplan = J.ShardingPlan("dp=4,tp=2", rules=[(r"weight", ("tp", None))])
    tplan = T.ShardingPlan("dp=4,tp=2", rules=[(r"weight", ("tp", None))],
                           devices=CPU8)
    jtelemetry.enable()
    ttelemetry.enable()
    try:
        before = ti.sharding_plan_applied_total.labels("test").value
        assert tplan.apply(dict(tnet.collect_params()),
                           label="test") is tplan.mesh
        jplan.apply(dict(jnet.collect_params()), label="test")
        assert ti.sharding_plan_applied_total.labels("test").value == \
            before + 1
        assert ti.sharding_mesh_axis_size.labels("tp").value == 2
    finally:
        jtelemetry.disable()
        ttelemetry.disable()
    tla, jla = T.last_applied(), J.last_applied()
    assert tla == jla
    w = tnet.collect_params()["weight"]
    assert [tuple(s.shape) for s in w.placement.shards] == [(4, 4)] * 8
    onp.testing.assert_array_equal(w.placement.full().numpy(),
                                   w._tensor().detach().numpy())
