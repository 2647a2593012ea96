"""The PyTorch port's initializers (mxnet_tpu_torch/initializer.py) against
the JAX package's, on the CPU.

The two random streams differ (threefry against torch's), so the
initializers that draw are held to the reference's distribution: the
Xavier and MSRA bound and standard deviation within 2 % over 295 k draws
(a sampling error of about 0.2 %), and the orthogonality of Orthogonal's
matrix within 1e-5. Everything that does not draw is held to the
reference's values exactly: Zero, One, Constant, Bilinear, LSTMBias,
Mixed and Load over constants and saved arrays, InitDesc's declared init,
the suffix table, ``create`` and ``dumps``.
"""
import math

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import initializer as jinit
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert


def _port(init, name, shape, explicit=True, dtype=torch.float32, seed=0):
    return init.init_array(name, shape, dtype, torch.device("cpu"),
                           torch.Generator().manual_seed(seed),
                           explicit=explicit).float().numpy()


def _ref(init, name, shape, explicit=True, dtype="float32"):
    out = init.init_array(name, shape, dtype, explicit=explicit)
    return onp.asarray(jnp.asarray(out._data, jnp.float32))


def _nets():
    """A 2-layer Dense net with LayerNorm in each package."""
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(6, in_units=5), mx.gluon.nn.LayerNorm(
        in_channels=6), mx.gluon.nn.Dense(3, in_units=6))
    tnet = tnn.HybridSequential(tnn.Dense(6, in_units=5),
                                tnn.LayerNorm(in_channels=6),
                                tnn.Dense(3, in_units=6))
    return jnet, tnet


def _values(net):
    return {k: p.data().asnumpy().astype("f")
            for k, p in net.collect_params().items()}


def test_structured_initializers_equal_the_reference():
    cases = [("Zero", {}, (3, 4)), ("One", {}, (5,)),
             ("Constant", dict(value=0.25), (2, 3, 4)),
             ("Constant", dict(value=-3.0), (7,)),
             ("Bilinear", {}, (2, 3, 4, 4)), ("Bilinear", {}, (1, 1, 5, 7)),
             ("LSTMBias", dict(forget_bias=1.5), (24,)),
             ("LSTMBias", {}, (8,))]
    for name, kw, shape in cases:
        for dtype in ("float32", "bfloat16"):
            got = _port(getattr(tinit, name)(**kw), "w", shape,
                        dtype=getattr(torch, dtype))
            want = _ref(getattr(jinit, name)(**kw), "w", shape, dtype=dtype)
            assert got.shape == want.shape, (name, kw, dtype)
            assert onp.array_equal(got, want), (name, kw, dtype)


def test_suffix_table_declared_init_and_explicit():
    """Without ``explicit`` a name's suffix decides (bias, beta, running or
    moving mean: 0; gamma, running or moving var: 1; else the draw); a
    declared init in ``InitDesc.attrs['__init__']`` wins over both."""
    for name in ("fc_bias", "ln_beta", "bn_running_mean", "bn_moving_mean",
                 "ln_gamma", "bn_running_var", "bn_moving_var"):
        got = _port(tinit.Constant(0.5), name, (4,), explicit=False)
        want = _ref(jinit.Constant(0.5), name, (4,), explicit=False)
        assert onp.array_equal(got, want), name
        assert got[0] in (0.0, 1.0), name
        got = _port(tinit.Constant(0.5), name, (4,), explicit=True)
        assert (got == 0.5).all(), name
    for declared in ("ones", "zeros", tinit.Constant(2.0)):
        jd = declared if isinstance(declared, str) else jinit.Constant(2.0)
        tdesc = tinit.InitDesc("fc_bias", {"__init__": declared})
        jdesc = jinit.InitDesc("fc_bias", {"__init__": jd})
        assert isinstance(tdesc, str) and tdesc == "fc_bias"
        assert tdesc.attrs["__init__"] is declared
        got = _port(tinit.Constant(0.5), tdesc, (3,), explicit=False)
        want = _ref(jinit.Constant(0.5), jdesc, (3,), explicit=False)
        assert onp.array_equal(got, want), declared
    # a tensor or an NDArray is initialized in place
    t = torch.empty(2, 3)
    assert tinit.Constant(4.0)("w", t, explicit=True) is t
    assert (t == 4.0).all()
    with mt.cpu():
        a = mt.np.zeros((2, 2))
    tinit.One()("w", a, explicit=True)
    assert (a.asnumpy() == 1).all()


def test_create_dumps_and_registry():
    names = sorted(set(jinit._REG.list()) - {"rnnfused"})
    for name in names:
        for spelling in (name, name.upper()):
            t, j = tinit.create(spelling), jinit.create(spelling)
            assert type(t).__name__ == type(j).__name__, spelling
    for t, j in ((tinit.Xavier("gaussian", "in", 2),
                  jinit.Xavier("gaussian", "in", 2)),
                 (tinit.MSRAPrelu("out", 0.1), jinit.MSRAPrelu("out", 0.1)),
                 (tinit.Constant(0.3), jinit.Constant(0.3)),
                 (tinit.Uniform(0.2), jinit.Uniform(0.2))):
        assert t.dumps() == j.dumps()
        back = tinit.create(j.dumps())
        assert type(back) is type(t) and back.dumps() == t.dumps()
    assert tinit.create("[\"constant\", {\"value\": 7.0}]").value == 7.0
    init = tinit.Normal()
    assert tinit.create(init) is init
    with pytest.raises(KeyError):
        tinit.create("nope")
    with pytest.raises(TypeError):
        tinit.create(3)
    assert mt.initializer is tinit


def test_xavier_and_msra_bound_and_std():
    shape = (256, 128, 3, 3)
    for rnd in ("uniform", "gaussian"):
        for factor in ("avg", "in", "out"):
            for mag in (3, 2.34):
                t = _port(tinit.Xavier(rnd, factor, mag), "w", shape)
                j = _ref(jinit.Xavier(rnd, factor, mag), "w", shape)
                fan = {"avg": (128 * 9 + 256 * 9) / 2, "in": 128 * 9,
                       "out": 256 * 9}[factor]
                scale = math.sqrt(mag / fan)
                what = (rnd, factor, mag)
                if rnd == "uniform":
                    assert onp.abs(t).max() <= scale, what
                    assert onp.abs(j).max() <= scale, what
                    assert onp.abs(t).max() > 0.99 * scale, what
                onp.testing.assert_allclose(t.std(), j.std(), rtol=0.02,
                                            err_msg=str(what))
                assert abs(t.mean()) < 0.01 * scale, what
    for slope in (0.25, 0.0):
        t = _port(tinit.MSRAPrelu("in", slope), "w", shape)
        j = _ref(jinit.MSRAPrelu("in", slope), "w", shape)
        want = math.sqrt(2.0 / (1 + slope ** 2) / (128 * 9))
        for x in (t, j):
            onp.testing.assert_allclose(x.std(), want, rtol=0.02)


def test_orthogonal():
    for shape, scale in (((16, 64), 1.414), ((64, 4, 4), 0.5),
                         ((8, 2, 3, 3), 1.0)):
        rows = shape[0]
        cols = int(onp.prod(shape[1:]))
        for w in (_port(tinit.Orthogonal(scale), "w", shape),
                  _ref(jinit.Orthogonal(scale), "w", shape)):
            assert w.shape == shape
            m = w.reshape(rows, cols).astype("float64")
            gram = m @ m.T if rows <= cols else m.T @ m
            onp.testing.assert_allclose(
                gram, scale ** 2 * onp.eye(min(rows, cols)), atol=1e-5)


def test_mixed_and_load_through_block_initialize(tmp_path):
    """``net.initialize(init=Mixed(...))`` and ``init=Load(...)`` drive
    every parameter by its collect_params() name, declared inits
    included, and give the JAX package's values."""
    jnet, tnet = _nets()
    pats, vals = [".*bias", ".*gamma", ".*"], [0.1, 0.2, 0.3]
    jnet.initialize(init=jinit.Mixed(pats, [jinit.Constant(v)
                                            for v in vals]))
    tnet.initialize(init=tinit.Mixed(pats, [tinit.Constant(v)
                                            for v in vals]),
                    device=mt.cpu())
    jv, tv = _values(jnet), _values(tnet)
    assert list(jv) == list(tv)
    for k in jv:
        assert onp.array_equal(jv[k], tv[k]), k
    assert (tv["1.beta"] == 0.3).all() and (tv["1.gamma"] == 0.2).all()
    with pytest.raises(ValueError, match="did not match any pattern"):
        tinit.Mixed(["x"], ["zeros"])("w", torch.empty(2), True)

    r = onp.random.RandomState(4)
    saved = {k: r.standard_normal(v.shape).astype("f")
             for k, v in jv.items() if k != "2.weight"}
    fname = str(tmp_path / "w.npz")
    mt.nd.save(fname, {f"arg:{k}" if k.endswith("weight") else k:
                       torch.from_numpy(v) for k, v in saved.items()})
    for source in (saved, fname):
        jnet, tnet = _nets()
        jnet.initialize(init=jinit.Load(source, jinit.Constant(-1.0)))
        tnet.initialize(init=tinit.Load(source, tinit.Constant(-1.0)),
                        device=mt.cpu())
        jv, tv = _values(jnet), _values(tnet)
        for k in jv:
            assert onp.array_equal(jv[k], tv[k]), (source, k)
        assert (tv["2.weight"] == -1.0).all()
        assert onp.array_equal(tv["0.weight"], saved["0.weight"])
    with pytest.raises(ValueError, match="no default initializer"):
        tinit.Load({})("w", torch.empty(2))
    with pytest.raises(ValueError, match="shape mismatch"):
        tinit.Load({"w": onp.zeros(3, "f")})("w", torch.empty(2))


def test_bert_initialize_with_xavier():
    """``net.initialize(init=Xavier())`` on a tiny BERTForQA: the
    parameters that declare an init keep it (biases and betas 0, gammas
    1), as in the JAX package, and the others take Xavier's draw within
    its bound; the same seed gives the same weights on each call."""
    cfg = dict(vocab_size=100, max_length=64, num_layers=2, units=64,
               hidden_size=128, num_heads=4)
    mx.seed(3)
    jnet = jbert.BERTForQA(jbert.get_bert_model("bert_12_768_12", **cfg))
    jnet.initialize(init=jinit.Xavier())
    nets = []
    for _ in range(2):
        tnet = tbert.BERTForQA(tbert.get_bert_model("bert_12_768_12", **cfg))
        tnet.initialize(init=mt.initializer.Xavier(), device=mt.cpu(),
                        generator=torch.Generator().manual_seed(5))
        nets.append(_values(tnet))
    jv, tv = _values(jnet), nets[0]
    assert list(jv) == list(tv)
    for k in jv:
        assert onp.array_equal(tv[k], nets[1][k]), k
        j, t = jv[k], tv[k]
        constant = j.size > 1 and (j == j.flat[0]).all()
        if constant:   # a declared init: zeros or ones
            assert onp.array_equal(t, j), k
        else:
            fan = max(tinit._fans(t.shape, "avg"), 1.0)
            assert onp.abs(t).max() <= math.sqrt(3 / fan), k
            assert onp.abs(t).max() > 0, k
