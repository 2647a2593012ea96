"""The PyTorch port's training plumbing on the CPU: Parameter gradient
buffers with MXNet's ``grad_req``, ``autograd.backward`` / ``grad`` /
``mark_variables``, the loss layers, ``amp.convert_hybrid_block``, and the
Trainer, against the JAX package on the same numpy data.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import nn as tnn


def _dense_pair(seed=2):
    """A 2-layer Dense net in both packages with the same weights."""
    mx.seed(seed)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(16, activation="relu", in_units=8),
             mx.gluon.nn.Dense(4, in_units=16))
    jnet.initialize()
    tnet = tnn.HybridSequential(
        tnn.Dense(16, activation="relu", in_units=8),
        tnn.Dense(4, in_units=16))
    tnet.initialize(device=mt.cpu())
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    return jnet, tnet


def _loss_of(tnet, x, scale=1.0):
    with mt.autograd.record():
        return (tnet(x) * scale).sum(dim=1)       # a vector head


def test_grad_req_write_add_null_and_zero_grad():
    _, tnet = _dense_pair()
    x = torch.from_numpy(onp.random.RandomState(0).randn(5, 8).astype("f"))
    w = tnet[0].weight
    assert w.grad_req == "write" and w.grad().abs().max() == 0
    mt.autograd.backward(_loss_of(tnet, x))
    g1 = w.grad().clone()
    assert g1.abs().max() > 0 and w._grad_version == 1
    assert w._tensor().grad is None          # torch's own .grad stays empty
    mt.autograd.backward(_loss_of(tnet, x, 2.0))
    torch.testing.assert_close(w.grad(), 2 * g1)      # replaced, not summed
    w.grad_req = "add"
    assert w.grad().abs().max() == 0      # 'add' starts from fresh zeros
    mt.autograd.backward(_loss_of(tnet, x))
    mt.autograd.backward(_loss_of(tnet, x, 2.0))
    torch.testing.assert_close(w.grad(), 3 * g1)
    v = w._grad_version
    tnet.zero_grad()
    assert w.grad().abs().max() == 0 and w._grad_version == v + 1
    w.grad_req = "null"
    assert not w._tensor().requires_grad
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        w.grad()
    mt.autograd.backward(_loss_of(tnet, x))     # the others still train
    assert tnet[1].weight.grad().abs().max() > 0
    assert tnet.trainable_param_names() == ["0.bias", "1.bias", "1.weight"]
    with pytest.raises(ValueError, match="grad_req"):
        w.grad_req = "sometimes"
    # a non-differentiable parameter stays 'null'
    ln = tnn.LayerNorm(in_channels=4, scale=False)
    ln.gamma.grad_req = "write"
    assert ln.gamma.grad_req == "null"


def test_backward_vector_heads_lists_and_grad():
    x = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    buf = torch.zeros(3)
    mt.autograd.mark_variables(x, buf)
    with mt.autograd.record():
        y = x * x                      # vector head: head gradient of ones
        z = 3 * x
    mt.autograd.backward([y, z], retain_graph=True)   # summed in one pass
    assert torch.equal(buf, torch.tensor([5.0, 7.0, 9.0]))
    assert x.grad is None
    mt.autograd.backward(y, head_grads=torch.tensor([1.0, 0.0, 2.0]),
                         retain_graph=True)
    assert torch.equal(buf, torch.tensor([2.0, 0.0, 12.0]))    # 'write'
    mt.autograd.mark_variables([x], [buf], "add")
    mt.autograd.backward(z, retain_graph=True)
    assert torch.equal(buf, torch.tensor([5.0, 3.0, 15.0]))
    # grad(): returned, not written; zeros for an unused variable
    u = torch.ones(2, requires_grad=True)
    gx, gu = mt.autograd.grad(y, [x, u], retain_graph=True)
    assert torch.equal(gx, 2 * x.detach()) and torch.equal(gu,
                                                           torch.zeros(2))
    assert torch.equal(buf, torch.tensor([5.0, 3.0, 15.0]))
    (g2,) = mt.autograd.grad((x ** 3).sum(), x, create_graph=True)
    assert g2.requires_grad
    with pytest.raises(ValueError, match="record"):
        mt.autograd.backward(torch.ones(2))
    # MXNet semantics against the JAX package on the same numbers
    jx = mx.np.array([1.0, 2.0, 3.0])
    jx.attach_grad()
    with mx.autograd.record():
        jy = jx * jx
    jy.backward()
    assert onp.array_equal(jx.grad.asnumpy(), [2.0, 4.0, 6.0])


def test_loss_layers_match_jax():
    rs = onp.random.RandomState(1)
    pred = rs.randn(6, 5, 7).astype("f")
    lab = rs.randint(0, 7, (6, 5)).astype("int32")
    dense = rs.rand(6, 5, 7).astype("f")
    sw = rs.rand(6, 5).astype("f")
    cases = [
        (dict(), (pred, lab)),
        (dict(weight=0.5), (pred, lab, sw)),
        (dict(sparse_label=False), (pred, dense)),
        (dict(from_logits=True), (pred, lab)),
        (dict(axis=1, batch_axis=0), (pred.transpose(0, 2, 1), lab)),
    ]
    for kw, args in cases:
        want = mx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
            *(mx.np.array(a) for a in args)).asnumpy()
        got = mt.gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
            *(torch.from_numpy(onp.ascontiguousarray(a)) for a in args))
        assert got.shape == (6,)                  # per sample, no batch mean
        onp.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    want = mx.gluon.loss.L2Loss()(mx.np.array(pred),
                                  mx.np.array(dense)).asnumpy()
    got = mt.gluon.loss.L2Loss()(torch.from_numpy(pred),
                                 torch.from_numpy(dense))
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    from mxnet_tpu.ops import tensor as jtensor
    from mxnet_tpu_torch.ops import nn as tops
    want = onp.asarray(jtensor.softmax_cross_entropy(
        mx.np.array(pred[:, 0])._data, mx.np.array(lab[:, 0])._data))
    got = tops.softmax_cross_entropy(torch.from_numpy(pred[:, 0]),
                                     torch.from_numpy(lab[:, 0]))
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # bf16 logits: the sum and the log are taken in f32
    lp = tops.log_softmax(torch.from_numpy(pred).bfloat16())
    assert lp.dtype == torch.bfloat16
    torch.testing.assert_close(
        lp.float(), torch.log_softmax(torch.from_numpy(pred).bfloat16()
                                      .float(), -1), atol=2e-2, rtol=2e-2)


def test_dense_net_three_sgd_steps_match_jax():
    """LeNet-free whole loop: record, per-sample loss, backward, step(B)."""
    jnet, tnet = _dense_pair()
    opt = dict(learning_rate=0.1, momentum=0.9, wd=1e-3)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(opt))
    rs = onp.random.RandomState(4)
    jlf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tlf = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(3):
        x = rs.randn(6, 8).astype("f")
        y = rs.randint(0, 4, (6,)).astype("int32")
        with mx.autograd.record():
            jl = jlf(jnet(mx.np.array(x)), mx.np.array(y))
        jl.backward()
        jtr.step(6)
        with mt.autograd.record():
            tl = tlf(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        mt.autograd.backward(tl)
        ttr.step(6)
        onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                    rtol=1e-5, atol=1e-6)
    for k, p in jnet.collect_params().items():
        onp.testing.assert_allclose(
            tnet.collect_params()[k]._tensor().detach().numpy(),
            p.data().asnumpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_step_rescales_by_batch_size_and_set_learning_rate():
    p = mt.gluon.Parameter("w", shape=(3,), init="ones")
    p.initialize(device=mt.cpu())
    tr = mt.gluon.Trainer([p], "sgd", {"learning_rate": 1.0})
    with mt.autograd.record():
        loss = (p._tensor() * torch.tensor([4.0, 8.0, 12.0]))
    mt.autograd.backward(loss)
    tr.step(4)
    assert tr.optimizer.rescale_grad == 0.25
    assert torch.equal(p._tensor().detach(), torch.tensor([0.0, -1.0, -2.0]))
    tr.set_learning_rate(0.5)
    assert tr.learning_rate == 0.5
    mt.autograd.backward((p._tensor() * 4.0).sum().reshape(1))
    tr.update(2)                                  # update(): rescales too
    assert torch.equal(p._tensor().detach(), torch.tensor([-1.0, -2.0, -3.0]))
    sched = mt.lr_scheduler.FactorScheduler(step=1, factor=0.5, base_lr=1.0)
    tr2 = mt.gluon.Trainer({"w": p}, "sgd", {"lr_scheduler": sched})
    with pytest.raises(ValueError, match="lr_scheduler"):
        tr2.set_learning_rate(0.1)


def test_stale_gradients_are_skipped_on_request():
    _, tnet = _dense_pair()
    tr = mt.gluon.Trainer(tnet.collect_params(), "sgd",
                          {"learning_rate": 0.1, "wd": 0.1})
    x = torch.from_numpy(onp.random.RandomState(0).randn(5, 8).astype("f"))
    mt.autograd.backward(_loss_of(tnet, x))
    tr.step(5)
    w0 = tnet[0].weight._tensor().detach().clone()
    # only the second layer gets a new gradient
    with mt.autograd.record():
        loss = tnet[1](torch.ones(2, 16)).sum(dim=1)
    mt.autograd.backward(loss)
    w1 = tnet[1].weight._tensor().detach().clone()
    tr.step(2, ignore_stale_grad=True)
    assert torch.equal(tnet[0].weight._tensor(), w0)         # stale: skipped
    assert not torch.equal(tnet[1].weight._tensor(), w1)
    assert tr.optimizer._index_update_count[
        tr._param_names.index("0.weight")] == 1
    tr.step(2)             # without the flag a stale gradient is applied
    assert not torch.equal(tnet[0].weight._tensor(), w0)
    tr.zero_grad()
    assert all(p.grad().abs().max() == 0 for p in tr._params)


def test_arguments_that_wait_raise():
    _, tnet = _dense_pair()
    params = tnet.collect_params()
    # meshes and plans (tests/test_torch_sharding_*.py): a plan that names
    # no positions spans the cards and raises without one; a plan that is
    # no axes spelling raises; a built mesh of CPU positions places
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError, match="CUDA"):
            mt.gluon.Trainer(params, "sgd", mesh=(("dp", -1),))
    with pytest.raises(TypeError):
        mt.gluon.Trainer(params, "sgd", sharding_plan=object())
    _, placed_net = _dense_pair()
    tr = mt.gluon.Trainer(placed_net.collect_params(), "sgd",
                          mesh=mt.parallel.make_mesh({"dp": 2},
                                                     [mt.cpu()] * 2))
    assert tr.sharding_plan.axis_sizes() == {"dp": 2}
    assert all(len(p.placement.shards) == 2 for p in tr._params)
    # the store's arguments are ported (tests/test_torch_trainer_kvstore.py)
    for kw in (dict(kvstore="tpu_dist"), dict(kvstore="dist_sync"),
               dict(kvstore="local", compression_params={"type": "2bit"}),
               dict(kvstore="local", update_on_kvstore=True)):
        mt.gluon.Trainer(params, "sgd", **kw)
    with pytest.raises(ValueError, match="requires a kvstore"):
        mt.gluon.Trainer(params, "sgd", compression_params={"type": "2bit"})
    for kv in (None, "device", "local"):
        mt.gluon.Trainer(params, "sgd", kvstore=kv)
    tr = mt.gluon.Trainer(params, "sgd")
    # amp's loss scaler and op-list arguments are ported; the graph-level
    # cast pass still waits
    assert mt.amp.LossScaler().loss_scale == 1.0
    assert mt.amp.convert_hybrid_block(tnet, fp32_ops=["x"]) is tnet
    with pytest.raises(NotImplementedError, match="not ported yet"):
        mt.amp.convert_hybrid_block(tnet, graph_pass=True)
    with pytest.raises(ValueError, match="Parameter"):
        mt.gluon.Trainer([torch.ones(1)], "sgd")
    with pytest.raises(ValueError, match="dict/list"):
        mt.gluon.Trainer(params["0.weight"], "sgd")


def test_amp_convert_casts_all_but_norm_parameters():
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

    net = tbert.BERTForQA(tbert.get_bert_model(
        "bert_12_768_12", vocab_size=50, max_length=16, num_layers=1,
        units=16, hidden_size=32, num_heads=2, dropout=0.0))
    net.initialize(device=mt.cpu())
    assert mt.amp.convert_hybrid_block(net, "bfloat16") is net
    for name, p in net.collect_params().items():
        norm = name.endswith((".gamma", ".beta"))
        assert p._tensor().dtype == (torch.float32 if norm
                                  else torch.bfloat16), name
        assert p.dtype == p._tensor().dtype
    tok = torch.zeros((2, 8), dtype=torch.int32)
    with mt.autograd.record():
        s, e = net(tok, tok)
    assert s.dtype == torch.bfloat16
    mt.autograd.backward(s.float().sum(dim=1) + e.float().sum(dim=1))
    w = net.collect_params()["bert.encoder.layers.0.attention.qkv.weight"]
    assert w.grad().dtype == torch.bfloat16 and w.grad().abs().max() > 0
    # cast() carries the gradient buffer along, and float inputs are cast
    net.cast("float32")
    assert w._tensor().dtype == w.grad().dtype == torch.float32
    d = tnn.Dense(3, in_units=4)
    d.initialize(device=mt.cpu())
    mt.amp.convert_hybrid_block(d)
    assert d(torch.ones(2, 4)).dtype == torch.bfloat16
