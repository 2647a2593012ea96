"""The Block, HybridBlock and Parameter methods of the port's second Gluon
slice against the JAX package on the CPU: ``register_child``, ``params``,
``setattr``, ``share_parameters`` (data and gradients shared),
``summary``'s rows, ``register_op_hook``'s block and tensor names,
``reset_device``, ``HybridBlock.infer_shape``, and on ``Parameter``
``name``, ``data_for``, ``logical_data``, ``list_data``, ``list_ctx`` /
``list_device``, ``reset_ctx`` / ``reset_device``; ``gluon.Constant``,
``gluon.ParameterDict`` and ``gluon.DeferredInitializationError``.

Weights are carried from the JAX package by ``convert.load_jax_params``;
values and gradients agree within 1e-6 relative (f32).
"""
import contextlib
import io

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import block as tblock


def _close(got, want, msg=""):
    onp.testing.assert_allclose(onp.asarray(got, "f"), onp.asarray(want, "f"),
                                rtol=1e-6, atol=1e-7, err_msg=msg)


def _x(shape, seed=0):
    return onp.random.RandomState(seed).standard_normal(shape).astype("f")


def _net(pkg):
    """A nested net: a HybridSequential holding a Dense, a
    ``register_child``-ed block of two layers and an Activation."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(6, activation="relu"))
    inner = nn.HybridSequential()
    inner.add(nn.Dense(5), nn.BatchNorm())
    net.register_child(inner)
    net.register_child(nn.Activation("tanh"), name="act")
    return net


def _pair(x):
    jmx.seed(1)
    jn, tn = _net(jmx), _net(mt)
    jn.initialize()
    jn(jmx.np.array(x))
    tn.initialize(device=mt.cpu())
    tn(torch.from_numpy(x))
    load_jax_params(tn, {k: p.data().asnumpy()
                         for k, p in jn.collect_params().items()})
    return jn, tn


def test_register_child_params_and_setattr():
    """Children named by count or by name; ``params`` holds a block's own
    parameters only; ``setattr`` reaches every parameter."""
    x = _x((4, 3))
    jn, tn = _pair(x)
    assert list(tn.collect_params()) == list(jn.collect_params())
    assert list(tn._modules) == list(jn._children) == ["0", "1", "act"]
    assert tn.params == {} == jn.params
    assert sorted(tn[0].params) == sorted(jn[0].params) == ["bias", "weight"]
    tn.setattr("grad_req", "null")
    jn.setattr("grad_req", "null")
    assert {p.grad_req for p in tn.collect_params().values()} == {"null"}
    tn.setattr("lr_mult", 0.5)
    assert all(p.lr_mult == 0.5 for p in tn.collect_params().values())


def test_share_parameters_shares_data_and_gradients():
    """A second net takes the first's Dense weight and bias by name: the
    same Parameter objects, so a forward through both nets in one record
    sums both uses into the one gradient, as in the JAX package; names the
    first net lacks keep their own parameters."""
    x = _x((4, 3), 1)
    nets = {}
    jmx.seed(2)
    for pkg in (jmx, mt):
        nn = pkg.gluon.nn
        a, b = nn.Dense(5, in_units=3), nn.HybridSequential()
        b.add(nn.Dense(5, in_units=3))
        dev = {} if pkg is jmx else {"device": mt.cpu()}
        a.initialize(**dev)
        b.initialize(**dev)
        shared = {"0." + k: v for k, v in a.collect_params().items()}
        shared["0.nothing"] = shared["0.weight"]
        b.share_parameters(shared)
        assert b[0].weight is a.weight and b[0].bias is a.bias
        nets[pkg] = (a, b)
    (ja, jb), (ta, tb) = nets[jmx], nets[mt]
    load_jax_params(ta, {k: p.data().asnumpy()
                         for k, p in ja.collect_params().items()})
    assert torch.equal(tb[0].weight._tensor(), ta.weight._tensor())
    jx = jmx.np.array(x)
    with jmx.autograd.record():
        jl = (ja(jx) * 2 + jb(jx) * 3).sum()
    jl.backward()
    with mt.autograd.record():
        tl = (ta(torch.from_numpy(x)) * 2 + tb(torch.from_numpy(x)) * 3).sum()
    mt.autograd.backward(tl)
    _close(ta.weight.grad().numpy(), ja.weight.grad().asnumpy(), "weight")
    _close(tb[0].bias.grad().numpy(), jb[0].bias.grad().asnumpy(), "bias")
    with pytest.raises(ValueError):
        tb.share_parameters([1])


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        total = fn()
    return buf.getvalue(), total


def test_summary_rows():
    """``summary`` prints the same rows (dotted names, types, parameter
    counts) and returns the same total."""
    x = _x((4, 3), 2)
    jn, tn = _pair(x)
    jtext, jtotal = _printed(lambda: jn.summary(jmx.np.array(x)))
    ttext, ttotal = _printed(lambda: tn.summary(torch.from_numpy(x)))
    assert ttext == jtext and ttotal == jtotal == 6 * 3 + 6 + 5 * 6 + 5 + 20


def _hooked(net, x, monitor_all, array):
    seen = []
    net.register_op_hook(lambda b, t, v: seen.append(
        (b, t, onp.asarray(v.asnumpy(), "f"))), monitor_all=monitor_all)
    net(array(x))
    return seen


@pytest.mark.parametrize("monitor_all", [False, True])
def test_register_op_hook_names(monitor_all):
    """The callback sees the same (block name, tensor name) sequence, and
    the same values, as the JAX package's: each block after its forward,
    inputs first with ``monitor_all``; a hybridized net reports for itself
    alone. A CUDA graph would skip it, so the graph entry points refuse
    a hooked net."""
    x = _x((4, 3), 3)
    jn, tn = _pair(x)
    jseen = _hooked(jn, x, monitor_all, jmx.np.array)
    tseen = _hooked(tn, x, monitor_all, torch.from_numpy)
    assert [s[:2] for s in tseen] == [s[:2] for s in jseen]
    assert ("1.1", "1.1_output0") in [s[:2] for s in tseen]
    for t, j in zip(tseen, jseen):
        _close(t[2], j[2], str(t[:2]))
    with pytest.raises(RuntimeError, match="op hook"):
        tblock.check_no_op_hooks(tn, "a CUDA graph")
    jn, tn = _pair(x)
    jn.hybridize()
    tn.hybridize()
    jseen = _hooked(jn, x, monitor_all, jmx.np.array)
    tseen = _hooked(tn, x, monitor_all, torch.from_numpy)
    assert [s[:2] for s in tseen] == [s[:2] for s in jseen]
    assert {s[0] for s in tseen} == {"HybridSequential"}


def test_parameter_device_methods_and_reset():
    """``name``, ``data_for``, ``logical_data``, ``list_data``,
    ``list_ctx``/``list_device`` and ``reset_ctx``/``reset_device`` on one
    device; ``Block.reset_device`` moves every parameter, replaces its
    tensor and zeroes its gradient; two devices raise."""
    x = _x((4, 3), 4)
    jn, tn = _pair(x)
    jp, tp = jn[0].weight, tn[0].weight
    assert tp.name == jp.name == "weight"
    tp.name = "w2"
    assert tp.name == "w2" and repr(tp).startswith("Parameter w2")
    for got, want in ((tp.data_for(None), jp.data_for(None)),
                      (tp.logical_data(), jp.logical_data()),
                      (tp.list_data()[0], jp.list_data()[0])):
        _close(got.asnumpy(), want.asnumpy())
    assert tp.list_ctx() == tp.list_device() == [torch.device("cpu")]
    assert len(jp.list_ctx()) == 1
    with mt.autograd.record():
        out = tn(torch.from_numpy(x)).sum()
    mt.autograd.backward(out)
    before = tp._tensor()
    tn.reset_device(mt.cpu())
    jn.reset_device(jmx.cpu())
    assert tp._tensor() is not before
    _close(tp.data().asnumpy(), jp.data().asnumpy())
    assert float(tp.grad().abs().sum()) == 0.0
    tp.reset_ctx([mt.cpu()])
    with pytest.raises(ValueError, match="one device"):
        tp.reset_device([torch.device("cpu"), torch.device("meta")])
    with pytest.raises(RuntimeError, match="not initialized on"):
        tp.data(device="meta")


def test_infer_shape_constant_parameter_dict_and_deferred_error():
    """``infer_shape`` completes deferred shapes without recording and
    with op hooks silent; ``Constant`` holds its value with no gradient;
    ``ParameterDict`` is a dict; a deferred parameter's data raises
    ``gluon.DeferredInitializationError`` in both packages."""
    x = _x((2, 7), 5)
    jd, td = jmx.gluon.nn.Dense(3), mt.gluon.nn.Dense(3)
    jd.initialize()
    td.initialize(device=mt.cpu())
    for d, err in ((jd, jmx.gluon.DeferredInitializationError),
                   (td, mt.gluon.DeferredInitializationError)):
        with pytest.raises(err):
            d.weight.data()
    seen = []
    td.register_op_hook(lambda *a: seen.append(a))
    td.infer_shape(torch.from_numpy(x))
    jd.infer_shape(jmx.np.array(x))
    assert td.weight.shape == jd.weight.shape == (3, 7) and not seen
    value = _x((2, 3), 6)
    jc, tc = jmx.gluon.Constant(value), mt.gluon.Constant(value)
    jc.initialize(device=jmx.cpu())
    tc.initialize(device=mt.cpu(), default_init=mt.initializer.One())
    assert tc.grad_req == jc.grad_req == "null"
    assert tc.shape == jc.shape and tc.dtype == torch.float32
    _close(tc.data().asnumpy(), jc.data().asnumpy(), "Constant")
    pd = mt.gluon.ParameterDict(a=tc)
    assert isinstance(pd, dict) and pd["a"] is tc
