"""``Block.save_parameters`` / ``load_parameters`` between the JAX package
and the PyTorch port, on the CPU.

A file written by either package loads into the other: a tiny
``BERTForQA`` (2 layers, units 64, 4 heads, vocab 100) in f32 and in bf16,
and a narrow ResNet whose BatchNorm running statistics are set to random
values before the save. Weights come back bit for bit; f32 forwards of the
two packages on the same numpy inputs agree within 1e-5 (logits of order
1; the two frameworks sum in another order). The options keep the JAX
package's exceptions. The JAX package writes on an IO thread, so its saves
are followed by its ``waitall()`` before the port reads the file.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dtype_codec as codec
from mxnet_tpu_torch.gluon import parameter as tparameter
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

CFG = dict(vocab_size=100, max_length=64, num_layers=2, units=64,
           hidden_size=128, num_heads=4)
B, S = 3, 21
ATOL = 1e-5


def _jax_bert(seed, dtype=None):
    jmx.seed(seed)
    net = jbert.BERTForQA(jbert.get_bert_model("bert_12_768_12", **CFG))
    net.initialize()
    if dtype is not None:
        jamp.convert_hybrid_block(net, dtype)
    return net


def _port_bert(seed, dtype=None):
    net = tbert.BERTForQA(tbert.get_bert_model("bert_12_768_12", **CFG))
    net.initialize(device=mt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    if dtype is not None:
        mt.amp.convert_hybrid_block(net, dtype)
    return net


def _tokens():
    rs = onp.random.RandomState(5)
    return (rs.randint(0, CFG["vocab_size"], (B, S)).astype("int32"),
            rs.randint(0, 2, (B, S)).astype("int32"))


def _assert_same_weights(tnet, jnet):
    """Every parameter of both packages: the same names, dtype names and
    bytes."""
    tps, jps = tnet.collect_params(), jnet.collect_params()
    assert list(tps) == list(jps)
    for name, jp in jps.items():
        want = onp.asarray(jp.data().asnumpy())
        got, _ = codec.to_numpy(tps[name]._tensor())
        assert codec.dtype_name(tps[name].dtype) == str(want.dtype), name
        assert got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


def _assert_bert_forwards_agree(tnet, jnet):
    tok, seg = _tokens()
    js, je = jnet(jmx.np.array(tok), jmx.np.array(seg))
    with torch.no_grad():
        ts, te = tnet(torch.from_numpy(tok), torch.from_numpy(seg))
    onp.testing.assert_allclose(ts.numpy(), js.asnumpy(), atol=ATOL, rtol=0)
    onp.testing.assert_allclose(te.numpy(), je.asnumpy(), atol=ATOL, rtol=0)


def test_bert_qa_f32_files_cross_both_ways(tmp_path):
    """JAX -> port, then port -> JAX, into nets built from other seeds so
    that each load overwrites everything."""
    jnet = _jax_bert(11)
    jnet.save_parameters(str(tmp_path / "jax.params"))
    jmx.waitall()
    tnet = _port_bert(3)
    tnet.load_parameters(str(tmp_path / "jax.params"))
    _assert_same_weights(tnet, jnet)
    _assert_bert_forwards_agree(tnet, jnet)

    with torch.no_grad():
        for p in tnet.collect_params().values():
            p._tensor().mul_(0.5)
    tnet.save_parameters(str(tmp_path / "port.params"))
    mt.waitall()   # the port writes on an IO thread too
    jback = _jax_bert(12)
    jback.load_parameters(str(tmp_path / "port.params"))
    _assert_same_weights(tnet, jback)
    _assert_bert_forwards_agree(tnet, jback)


def test_bert_qa_bf16_files_cross_both_ways(tmp_path):
    """bf16 weights (LayerNorm's f32) through the dtype sidecar, bit for
    bit each way."""
    jnet = _jax_bert(11, "bfloat16")
    jnet.save_parameters(str(tmp_path / "jax.params"))
    jmx.waitall()
    tnet = _port_bert(4, "bfloat16")
    assert any(p.dtype == torch.bfloat16
               for p in tnet.collect_params().values())
    tnet.load_parameters(str(tmp_path / "jax.params"))
    _assert_same_weights(tnet, jnet)

    with torch.no_grad():
        for p in tnet.collect_params().values():
            p._tensor().mul_(-2.0)
    tnet.save_parameters(str(tmp_path / "port.params"))
    mt.waitall()   # the port writes on an IO thread too
    jback = _jax_bert(12, "bfloat16")
    jback.load_parameters(str(tmp_path / "port.params"))
    _assert_same_weights(tnet, jback)


def _narrow(pkg):
    return pkg.ResNetV1(pkg.BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
                        classes=10, layout="NHWC", stem_s2d=True)


def test_resnet_with_batchnorm_statistics_crosses_both_ways(tmp_path):
    """BatchNorm's running mean and variance (grad_req 'null') are saved
    and loaded like any other parameter; the predict-mode forward, which
    reads them, agrees."""
    x = onp.random.RandomState(5).standard_normal((2, 32, 32, 3)).astype("f")
    jmx.seed(11)
    jnet = _narrow(jresnet)
    jnet.initialize()
    jnet(jmx.np.array(x))                   # the deferred shapes
    r = onp.random.RandomState(7)
    stats = [n for n in jnet.collect_params() if "running" in n]
    assert len(stats) >= 20
    for name in stats:
        p = jnet.collect_params()[name]
        v = r.uniform(0.5, 1.5, p.shape) if "var" in name \
            else r.standard_normal(p.shape) * 0.1
        p.set_data(jmx.np.array(v.astype("f")))
    jnet.save_parameters(str(tmp_path / "jax.params"))
    jmx.waitall()

    tnet = _narrow(tresnet)
    tnet.initialize(device=mt.cpu())
    tnet.load_parameters(str(tmp_path / "jax.params"))
    _assert_same_weights(tnet, jnet)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    want = jnet(jmx.np.array(x)).asnumpy()
    onp.testing.assert_allclose(got, want, atol=ATOL * onp.abs(want).max(),
                                rtol=ATOL)

    with torch.no_grad():
        for name in stats:
            tnet.collect_params()[name]._tensor().mul_(1.25)
    tnet.save_parameters(str(tmp_path / "port.params"))
    mt.waitall()   # the port writes on an IO thread too
    jmx.seed(12)
    jback = _narrow(jresnet)
    jback.initialize()
    jback(jmx.np.array(x))
    jback.load_parameters(str(tmp_path / "port.params"))
    _assert_same_weights(tnet, jback)


def _dense(pkg, in_units=4):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(5, in_units=in_units),
            pkg.gluon.nn.Dense(3, in_units=5))
    return net


def _pair_files(tmp_path):
    """A small Dense net saved by the JAX package, and its own net."""
    jmx.seed(2)
    jnet = _dense(jmx)
    jnet.initialize()
    path = str(tmp_path / "dense.params")
    jnet.save_parameters(path)
    jmx.waitall()
    return jnet, path


def test_allow_missing_and_ignore_extra(tmp_path):
    jnet, path = _pair_files(tmp_path)
    # a net with one layer more (a name the file lacks) and one with one
    # layer fewer (a name the net lacks), in both packages
    for pkg, init in ((jmx, {}), (mt, {"device": mt.cpu()})):
        more = _dense(pkg)
        more.add(pkg.gluon.nn.Dense(2, in_units=3))
        more.initialize(**init)
        with pytest.raises(KeyError, match="missing"):
            more.load_parameters(path)
        more.load_parameters(path, allow_missing=True)
        fewer = pkg.gluon.nn.HybridSequential()
        fewer.add(pkg.gluon.nn.Dense(5, in_units=4))
        fewer.initialize(**init)
        with pytest.raises(KeyError, match="extra"):
            fewer.load_parameters(path)
        fewer.load_parameters(path, ignore_extra=True)
        if pkg is mt:
            tmore, tfewer = more, fewer
    tnet = _dense(mt)
    tnet.initialize(device=mt.cpu())
    tnet.load_parameters(path)
    _assert_same_weights(tnet, jnet)
    for k in ("0.weight", "0.bias", "1.weight", "1.bias"):
        assert torch.equal(tmore.collect_params()[k]._tensor(),
                           tnet.collect_params()[k]._tensor())
    assert torch.equal(tfewer.collect_params()["0.weight"]._tensor(),
                       tnet.collect_params()["0.weight"]._tensor())


def test_cast_dtype_and_dtype_source(tmp_path):
    """A f32 file into a bf16 net: AssertionError in both packages without
    ``cast_dtype``; 'current' casts the values, 'saved' retypes the
    parameter and its gradient buffer (a new storage); another source
    raises ValueError."""
    jnet, path = _pair_files(tmp_path)
    outcomes = {}
    for pkg in (jmx, mt):
        def bf16_net(pkg=pkg):
            net = _dense(pkg)
            net.initialize(**({"device": mt.cpu()} if pkg is mt else {}))
            net.cast("bfloat16")
            return net
        with pytest.raises(AssertionError, match="cast_dtype"):
            bf16_net().load_parameters(path)
        with pytest.raises(ValueError, match="dtype_source"):
            bf16_net().load_parameters(path, cast_dtype=True,
                                       dtype_source="file")
        cur = bf16_net()
        cur.load_parameters(path, cast_dtype=True)
        saved = bf16_net()
        saved.load_parameters(path, cast_dtype=True, dtype_source="saved")
        outcomes[pkg.__name__] = (cur, saved)
    (jcur, jsaved), (tcur, tsaved) = outcomes["mxnet_tpu"], \
        outcomes["mxnet_tpu_torch"]
    _assert_same_weights(tcur, jcur)
    _assert_same_weights(tsaved, jsaved)
    _assert_same_weights(tsaved, jnet)
    w = tsaved.collect_params()["0.weight"]
    assert w.dtype == torch.float32 and w.grad().dtype == torch.float32
    assert tcur.collect_params()["0.weight"].dtype == torch.bfloat16


def test_load_copies_in_place_and_a_retype_moves_storage(tmp_path):
    """An initialized net takes the file's values in its own tensors: no
    address moves and storage_epoch stands still (a captured graph keeps
    replaying); a retype by dtype_source='saved' moves it."""
    jnet, path = _pair_files(tmp_path)
    tnet = _dense(mt)
    tnet.initialize(device=mt.cpu())
    before = [(id(p._tensor()), p._tensor().data_ptr())
              for p in tnet.collect_params().values()]
    epoch = tparameter.storage_epoch()
    tnet.load_parameters(path)
    assert tparameter.storage_epoch() == epoch
    assert before == [(id(p._tensor()), p._tensor().data_ptr())
                      for p in tnet.collect_params().values()]
    _assert_same_weights(tnet, jnet)
    tnet.cast("bfloat16")
    epoch = tparameter.storage_epoch()
    tnet.load_parameters(path, cast_dtype=True, dtype_source="saved")
    assert tparameter.storage_epoch() != epoch
    _assert_same_weights(tnet, jnet)


def test_deferred_init_takes_shapes_from_the_file(tmp_path):
    """``Dense(5)`` with its input width unknown, initialized and never
    run, takes its shape and values from the file; a net never initialized
    lands on the device given."""
    jnet, path = _pair_files(tmp_path)
    deferred = _dense(mt, in_units=0)
    deferred.initialize(device=mt.cpu())
    assert deferred[0].weight._is_deferred
    deferred.load_parameters(path)
    _assert_same_weights(deferred, jnet)
    x = onp.random.RandomState(0).standard_normal((2, 4)).astype("f")
    with torch.no_grad():
        got = deferred(torch.from_numpy(x)).numpy()
    onp.testing.assert_allclose(got, jnet(jmx.np.array(x)).asnumpy(),
                                atol=ATOL, rtol=ATOL)
    fresh = _dense(mt, in_units=0)
    fresh.load_parameters(path, device=mt.cpu())
    _assert_same_weights(fresh, jnet)
    assert fresh.device == torch.device("cpu")


def test_npz_suffix_lookup_and_names_kept(tmp_path):
    """Both packages write the file under the name given (through an open
    file, so numpy adds no ``.npz``); a name without the suffix finds the
    ``.npz`` file."""
    jmx.seed(2)
    jnet = _dense(jmx)
    jnet.initialize()
    jnet.save_parameters(str(tmp_path / "j.npz"))
    jmx.waitall()
    tnet = _dense(mt)
    tnet.initialize(device=mt.cpu())
    tnet.load_parameters(str(tmp_path / "j"))
    _assert_same_weights(tnet, jnet)
    tnet.save_parameters(str(tmp_path / "t.params"))
    mt.waitall()   # the port writes on an IO thread too
    assert sorted(p.name for p in tmp_path.iterdir()) == ["j.npz",
                                                          "t.params"]
    tnet.save_parameters(str(tmp_path / "t2.npz"))
    mt.waitall()   # the port writes on an IO thread too
    jback = _dense(jmx)
    jback.initialize()
    jback.load_parameters(str(tmp_path / "t2"))
    _assert_same_weights(tnet, jback)
