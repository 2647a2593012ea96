"""``amp`` of the PyTorch port against the JAX package's, on the CPU: the
op lists, ``init``, ``init_trainer``, ``scale_loss``, ``unscale`` and
``LossScaler`` (its overflow check included), the op-list arguments of
``convert_hybrid_block``, and a tiny BERTForQA trained by LAMB through
MXNet's AMP loop in bf16 with f32 masters.

Tolerances: gradients after ``unscale`` equal the JAX package's bit for
bit (the same numpy gradients times the same rounded scalar); the BERT
steps as tests/test_torch_train_bert.py holds its bf16 steps, each step
from the JAX side's weights and states: the loss within 0.1 (bf16 logits
near 2 ln 37), f32 masters within 1e-4, each bf16 weight its master
rounded, and within one bf16 ulp (2e-3) plus 1e-4 of the JAX weight.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ops import optimizer_ops as jops
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch.convert import (load_jax_params,
                                     load_jax_trainer_states, to_tensor)
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.ops import optimizer_ops as tops


@pytest.fixture(autouse=True)
def _amp_target():
    """Each test starts from bf16 and leaves both packages there."""
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    yield
    jamp.init("bfloat16")
    tamp.init("bfloat16")


def _dense_pair(dtype="float32"):
    mx.seed(2)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(6, in_units=5), mx.gluon.nn.Dense(3,
                                                                 in_units=6))
    jnet.initialize()
    tnet = tnn.HybridSequential(tnn.Dense(6, in_units=5),
                                tnn.Dense(3, in_units=6))
    tnet.initialize(device=mt.cpu())
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    if dtype != "float32":
        jnet.cast(dtype)
        tnet.cast(dtype)
    return jnet, tnet


def _set_grads(jnet, tnet, values):
    for (k, jp), tp in zip(jnet.collect_params().items(),
                           tnet.collect_params().values()):
        g = jnp.asarray(values[k]).astype(jp.grad()._data.dtype)
        jp.grad()._data = g
        tp._grad = to_tensor(onp.asarray(g))


def test_op_lists_equal_the_reference():
    for target in ("bfloat16", "float16"):
        for fn in ("list_lp16_ops", "list_fp32_ops", "list_lp16_fp32_ops",
                   "list_conditional_fp32_ops", "list_widest_type_cast",
                   "list_loss_output_functions",
                   "list_lp16_use_fp32_params"):
            assert getattr(tamp, fn)(target) == getattr(jamp, fn)(target), \
                (fn, target)
    for mod in ("symbol_bf16", "symbol_fp16"):
        jm, tm = getattr(jamp.lists, mod), getattr(tamp.lists, mod)
        names = [n for n in dir(jm) if n.isupper()]
        assert names and names == [n for n in dir(tm) if n.isupper()]
        for n in names:
            assert getattr(tm, n) == getattr(jm, n), (mod, n)
    assert sorted(tamp.__all__) == sorted(jamp.__all__)


def test_init_and_the_loss_scaler_schedule():
    """bf16 (and float16, which maps to it) keeps the scale at 1; another
    target starts at ``init_scale``; an overflow halves it (not below 1)
    and ``scale_window`` clean steps double it, as in the JAX package."""
    for target, want in (("bfloat16", 1.0), ("float16", 1.0),
                         ("float32", 2.0 ** 16)):
        jamp.init(target)
        tamp.init(target)
        assert tamp.LossScaler().loss_scale == jamp.LossScaler().loss_scale \
            == want, target
    jamp.init("float32")
    tamp.init("float32")
    js = jamp.LossScaler(init_scale=8.0, scale_factor=2.0, scale_window=3)
    ts = tamp.LossScaler(init_scale=8.0, scale_factor=2.0, scale_window=3)
    seq = [True, False, False, False, True, True, True, True, True, False]
    for overflow in seq:
        js.update_scale(overflow)
        ts.update_scale(overflow)
        assert ts.loss_scale == js.loss_scale, seq
    _, tnet = _dense_pair()
    tr = mt.gluon.Trainer(tnet.collect_params(), "sgd")
    assert tamp.init_trainer(tr) is tr
    assert isinstance(tr._amp_loss_scaler, tamp.LossScaler)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_loss_and_unscale(dtype):
    """``scale_loss`` yields the loss times the scale (the loss itself
    under bf16); ``unscale`` multiplies each gradient by 1/scale rounded as
    the JAX package rounds it into the gradient's dtype; a scale of 1
    leaves them untouched."""
    jnet, tnet = _dense_pair(dtype)
    r = onp.random.RandomState(3)
    grads = {k: r.standard_normal(p.shape).astype("f")
             for k, p in jnet.collect_params().items()}
    for target, scale in (("bfloat16", None), ("float32", 3.0)):
        jamp.init(target)
        tamp.init(target)
        jtr = jamp.init_trainer(mx.gluon.Trainer(jnet.collect_params(),
                                                 "sgd"))
        ttr = tamp.init_trainer(mt.gluon.Trainer(tnet.collect_params(),
                                                 "sgd"))
        if scale is not None:
            jtr._amp_loss_scaler.loss_scale = scale
            ttr._amp_loss_scaler.loss_scale = scale
        with jamp.scale_loss(mx.np.array([2.0]), jtr) as jl, \
                tamp.scale_loss(torch.tensor([2.0]), ttr) as tl:
            assert float(tl[0]) == float(jl.asnumpy()[0]) == 2.0 * (
                scale or 1.0)
        _set_grads(jnet, tnet, grads)
        jamp.unscale(jtr)
        tamp.unscale(ttr)
        for (k, jp), tp in zip(jnet.collect_params().items(),
                               tnet.collect_params().values()):
            jg = jp.grad()._data
            tg = tp.grad()
            assert str(tg.dtype) == f"torch.{jg.dtype}", k
            assert onp.array_equal(tg.float().numpy(),
                                   onp.asarray(jg.astype(jnp.float32))), \
                (k, target)


def test_has_overflow_and_multi_all_finite():
    jnet, tnet = _dense_pair()
    js, ts = jamp.LossScaler(), tamp.LossScaler()
    r = onp.random.RandomState(4)
    clean = {k: r.standard_normal(p.shape).astype("f")
             for k, p in jnet.collect_params().items()}
    cases = [("clean", None, None), ("inf", "1.weight", onp.inf),
             ("-inf", "0.bias", -onp.inf), ("nan", "0.weight", onp.nan)]
    for label, key, bad in cases:
        g = {k: v.copy() for k, v in clean.items()}
        if key is not None:
            g[key].flat[3] = bad
        _set_grads(jnet, tnet, g)
        jover = js.has_overflow(list(jnet.collect_params().values()))
        tover = ts.has_overflow(list(tnet.collect_params().values()))
        assert tover is jover is (key is not None), label
        arrays = [onp.asarray(v) for v in g.values()]
        want = jops.multi_all_finite(*[jnp.asarray(a) for a in arrays])
        got = tops.multi_all_finite(*[torch.from_numpy(a) for a in arrays])
        assert got.dtype == torch.float32 and got.shape == (1,)
        assert float(got[0]) == float(want[0]), label
    # a parameter with grad_req='null' is not read
    p = tnet.collect_params()["0.weight"]
    p.grad()[0, 0] = float("inf")
    p.grad_req = "null"
    assert not ts.has_overflow(list(tnet.collect_params().values()))
    assert ts.has_overflow([]) is False
    sq = tops.multi_sum_sq(*[torch.from_numpy(v) for v in clean.values()])
    jsq = jops.multi_sum_sq(*[jnp.asarray(v) for v in clean.values()])
    for a, b in zip(sq, jsq):
        onp.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_convert_hybrid_block_takes_the_op_lists():
    """The op-list arguments are accepted and ignored, as in the JAX
    package: the same parameters are cast (norm scale and shift stay f32,
    a parameter with neither shape nor value is skipped) and the net is
    returned; ``graph_pass=True`` still raises."""
    cfg = dict(vocab_size=100, max_length=64, num_layers=1, units=32,
               hidden_size=64, num_heads=2)
    lists = dict(target_dtype_ops=["FullyConnected"], fp32_ops=["softmax"],
                 conditional_fp32_ops=[("Activation", "act_type",
                                        ["softrelu"])],
                 excluded_sym_names=["bert.pooler"])
    jnet = jbert.BERTForQA(jbert.get_bert_model("bert_12_768_12", **cfg))
    jnet.initialize()
    tnet = tbert.BERTForQA(tbert.get_bert_model("bert_12_768_12", **cfg))
    tnet.initialize(device=mt.cpu())
    assert jamp.convert_hybrid_block(jnet, "float16", **lists) is jnet
    assert tamp.convert_hybrid_block(tnet, "float16", **lists) is tnet
    jd = {k: str(p.dtype) for k, p in jnet.collect_params().items()}
    td = {k: str(p.dtype).replace("torch.", "")
          for k, p in tnet.collect_params().items()}
    assert td == jd
    assert td["bert.embed_layer_norm.gamma"] == "float32"
    assert "bfloat16" in td.values()
    tok = torch.randint(0, 100, (2, 9), dtype=torch.int32)
    s, _ = tnet(tok, torch.zeros_like(tok))
    assert s.dtype == torch.bfloat16
    # a parameter with no shape and no value keeps its dtype in both
    jp = mx.gluon.Parameter("w", shape=None, allow_deferred_init=True)
    tp = mt.gluon.Parameter("w", shape=None, allow_deferred_init=True)
    jb, tb = mx.gluon.HybridBlock(), mt.gluon.HybridBlock()
    jb.w, tb.w = jp, tp
    jamp.convert_hybrid_block(jb, fp32_ops=["softmax"])
    tamp.convert_hybrid_block(tb, fp32_ops=["softmax"])
    assert str(tp.dtype) == f"torch.{jp.dtype}" == "torch.float32"
    with pytest.raises(NotImplementedError, match="graph_pass"):
        tamp.convert_hybrid_block(tnet, graph_pass=True)


CFG = dict(vocab_size=100, max_length=64, num_layers=2, units=64,
           hidden_size=128, num_heads=4, dropout=0.0)
B, S = 4, 37


def _amp_step(pkg, net, tr, data, wrap):
    """One step of MXNet's AMP loop; returns the loss and the verdict."""
    tok, seg, y0, y1 = (wrap(a) for a in data)
    lf = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record():
        s, e = net(tok, seg)
        loss = lf(s, y0) + lf(e, y1)
        with pkg.amp.scale_loss(loss, tr) as scaled:
            pkg.autograd.backward(scaled)
    pkg.amp.unscale(tr)
    overflow = tr._amp_loss_scaler.has_overflow(tr._params)
    if not overflow:
        tr.step(B)
    tr._amp_loss_scaler.update_scale(overflow)
    return onp.asarray(getattr(loss, "asnumpy", lambda: loss.detach().float()
                               .numpy())(), "f"), overflow


def _np_state(state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_np_state(s) for s in state)
    return state.asnumpy()


def test_bert_lamb_amp_loop_matches_jax():
    """A tiny BERTForQA, Xavier-initialized, bf16 with f32 masters, 3 LAMB
    steps (wd, the global-norm clip) through the AMP loop in each package:
    no overflow and a scale of 1 in both; each step from the JAX side's
    weights and states within the module's tolerances."""
    mx.seed(21)
    jnet = jbert.BERTForQA(jbert.get_bert_model("bert_12_768_12", **CFG))
    jnet.initialize(init=mx.initializer.Xavier())
    tnet = tbert.BERTForQA(tbert.get_bert_model("bert_12_768_12", **CFG))
    tnet.initialize(init=mt.initializer.Xavier(), device=mt.cpu())
    params = lambda: {k: p.data().asnumpy()  # noqa: E731
                      for k, p in jnet.collect_params().items()}
    load_jax_params(tnet, params())
    for pkg, net in ((mx, jnet), (mt, tnet)):
        pkg.amp.init()
        pkg.amp.convert_hybrid_block(net)
    opt = dict(learning_rate=2e-5, wd=0.01, clip_global_norm=1.0,
               multi_precision=True)
    jtr = jamp.init_trainer(mx.gluon.Trainer(jnet.collect_params(), "lamb",
                                             dict(opt)))
    ttr = tamp.init_trainer(mt.gluon.Trainer(tnet.collect_params(), "lamb",
                                             dict(opt)))
    names = sorted(jnet.collect_params())
    rs = onp.random.RandomState(5)
    data = (rs.randint(0, 100, (B, S)).astype("int32"),
            rs.randint(0, 2, (B, S)).astype("int32"),
            rs.randint(0, S, (B,)).astype("int32"),
            rs.randint(0, S, (B,)).astype("int32"))
    for step in range(3):
        load_jax_params(tnet, params())
        if step:
            opt_j = jtr.optimizer
            load_jax_trainer_states(ttr, {
                "states": {n: _np_state(s) for n, s in zip(names,
                                                           jtr._states)},
                "index_update_count": {names[i]: t for i, t in
                                       opt_j._index_update_count.items()},
                "num_update": opt_j.num_update})
        jl, jover = _amp_step(mx, jnet, jtr, data, mx.np.array)
        tl, tover = _amp_step(mt, tnet, ttr, data, torch.from_numpy)
        assert not jover and not tover, step
        assert ttr._amp_loss_scaler.loss_scale == 1.0 == \
            jtr._amp_loss_scaler.loss_scale
        onp.testing.assert_allclose(tl, jl, atol=0.1, rtol=0)
        for i, name in enumerate(names):
            p = tnet.collect_params()[name]
            if p._tensor().dtype != torch.bfloat16:
                continue
            master = ttr._states[i][0]
            onp.testing.assert_allclose(
                master.numpy(), jtr._states[i][0].asnumpy(), atol=1e-4,
                rtol=0, err_msg=f"step {step} {name}")
            assert torch.equal(p._tensor().detach(),
                               master.to(torch.bfloat16)), name
            jw = to_tensor(jnet.collect_params()[name].data().asnumpy())
            diff = (p._tensor().detach().float() - jw.float()).abs().max()
            assert diff <= 2e-3 + 1e-4, (step, name)
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == 3
