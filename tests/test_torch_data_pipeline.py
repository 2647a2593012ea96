"""The input pipeline's host side, held bit for bit against the JAX
package on the CPU: samplers (every ``last_batch`` mode, the random order
from numpy's global RNG), datasets and their methods, the batchify
functions (dtypes kept: uint8 images, int32 labels) and the synthetic
MNIST/CIFAR bytes."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

jdata, tdata = jmx.gluon.data, mt.gluon.data


def _np(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return onp.asarray(x.asnumpy()) if hasattr(x, "asnumpy") else x


def _equal(got, want, tag):
    got, want = _np(got), _np(want)
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), tag
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, (tag, i))
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), tag
        for k in want:
            _equal(got[k], want[k], (tag, k))
    elif isinstance(want, onp.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (tag, got.dtype, want.dtype, got.shape, want.shape)
        assert got.tobytes() == want.tobytes(), tag
    else:
        assert got == want, (tag, got, want)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_and_batch_sampler_modes(last_batch):
    for n, bs in ((10, 3), (12, 4), (5, 7)):
        onp.random.seed(7)
        jb = jdata.BatchSampler(jdata.RandomSampler(n), bs, last_batch)
        want = [list(jb) for _ in range(2)]
        onp.random.seed(7)
        tb = tdata.BatchSampler(tdata.RandomSampler(n), bs, last_batch)
        got = [list(tb) for _ in range(2)]
        assert got == want, (n, bs)
        jb = jdata.BatchSampler(jdata.SequentialSampler(n, 2), bs, last_batch)
        tb = tdata.BatchSampler(tdata.SequentialSampler(n, 2), bs, last_batch)
        assert [list(tb), len(tb), list(tb)] == [list(jb), len(jb), list(jb)]
    for rollover in (True, False):
        j = jdata.IntervalSampler(10, 3, rollover)
        t = tdata.IntervalSampler(10, 3, rollover)
        assert (list(t), len(t)) == (list(j), len(j))
    ds = list(range(12))
    j = jdata.FilterSampler(lambda s: s % 3 == 0, ds)
    t = tdata.FilterSampler(lambda s: s % 3 == 0, ds)
    assert (list(t), len(t)) == (list(j), len(j))


def test_datasets_and_their_methods():
    r = onp.random.RandomState(0)
    x = r.randint(0, 255, (11, 4, 4, 1)).astype("uint8")
    y = r.randint(0, 10, (11,)).astype("int32")
    jd, td = jdata.ArrayDataset(x, y), tdata.ArrayDataset(x, y)
    assert len(jd) == len(td) == 11
    cases = [
        ("item", lambda d: d[3]),
        ("transform", lambda d: d.transform(lambda a, b: (a * 2, b + 1))[4]),
        ("transform eager", lambda d: d.transform(
            lambda a, b: (a[:2], b), lazy=False)[5]),
        ("transform_first", lambda d: d.transform_first(lambda a: a.T)[6]),
        ("filter", lambda d: [s[1] for s in d.filter(lambda s: s[1] > 4)]),
        ("shard", lambda d: [d.shard(3, 1)[i][1]
                             for i in range(len(d.shard(3, 1)))]),
        ("take", lambda d: (len(d.take(4)), d.take(4)[3], len(d.take(None)))),
    ]
    for tag, fn in cases:
        _equal(fn(td), fn(jd), tag)
    jsamp = jd.sample(jdata.IntervalSampler(11, 4))
    tsamp = td.sample(tdata.IntervalSampler(11, 4))
    _equal([tsamp[i] for i in range(len(tsamp))],
           [jsamp[i] for i in range(len(jsamp))], "sample")
    with pytest.raises(TypeError):
        td.sample([1, 2])
    _equal(tdata.SimpleDataset([1, 5, 2])[1], jdata.SimpleDataset([1, 5, 2])[1],
           "simple")
    _equal(tdata.ArrayDataset(x)[2], jdata.ArrayDataset(x)[2], "one array")


def test_batchify_functions_keep_dtypes():
    r = onp.random.RandomState(1)
    imgs = [r.randint(0, 255, (3, 2)).astype("uint8") for _ in range(4)]
    labels = [onp.int32(i) for i in range(4)]
    ragged = [onp.arange(n * 2).reshape(n, 2).astype("float32")
              for n in (1, 3, 2)]
    jb, tb = jdata.batchify, tdata.batchify
    with mt.cpu():
        cases = [
            ("default tuple", lambda b: b.default_batchify_fn(
                list(zip(imgs, labels)))),
            ("default ints", lambda b: b.default_batchify_fn([1, 2, 3])),
            ("default floats", lambda b: b.default_batchify_fn([1.5, 2.0])),
            ("default dict", lambda b: b.default_batchify_fn(
                [{"x": i, "y": lab} for i, lab in zip(imgs, labels)])),
            ("stack", lambda b: b.Stack()(imgs)),
            ("pad", lambda b: b.Pad(val=-1)(ragged)),
            ("pad dtype", lambda b: b.Pad(dtype="int32")(ragged)),
            ("append", lambda b: b.Append()(ragged)),
            ("append flat", lambda b: b.Append(expand=False)(ragged)),
            ("group", lambda b: b.Group(b.Stack(), b.Pad())(
                list(zip(imgs, ragged + ragged[:1])))),
            ("aslist", lambda b: b.Group([b.Stack(), b.AsList()])(
                list(zip(labels, ["a", "b", "c", "d"])))),
        ]
        for tag, fn in cases:
            _equal(fn(tb), fn(jb), tag)
        batch = tb.default_batchify_fn(list(zip(imgs, labels)))
    assert batch[0].dtype == onp.uint8 and batch[1].dtype == onp.int32
    assert batch[0]._data.device.type == "cpu"


def test_vision_datasets_hold_the_same_bytes(tmp_path):
    for name in ("MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"):
        for train in (True, False):
            j = getattr(jdata.vision, name)(train=train, synthetic=True)
            t = getattr(tdata.vision, name)(train=train, synthetic=True)
            assert len(t) == len(j)
            _equal(t._data, j._data, (name, train))
            _equal(t._label, j._label, (name, train))
            _equal(t[5], j[5], (name, train, 5))
    # idx files and CIFAR binary batches under root are read, in both
    r = onp.random.RandomState(2)
    img = r.randint(0, 255, (6, 28, 28)).astype("uint8")
    lab = r.randint(0, 10, (6,)).astype("uint8")
    import struct
    (tmp_path / "train-images-idx3-ubyte").write_bytes(
        struct.pack(">IIII", 2051, 6, 28, 28) + img.tobytes())
    (tmp_path / "train-labels-idx1-ubyte").write_bytes(
        struct.pack(">II", 2049, 6) + lab.tobytes())
    j, t = jdata.vision.MNIST(str(tmp_path)), tdata.vision.MNIST(str(tmp_path))
    _equal(t._data, j._data, "idx")
    _equal(t._label, j._label, "idx labels")
    cifar = tmp_path / "cifar"
    cifar.mkdir()
    for i in range(1, 6):
        rec = onp.concatenate([r.randint(0, 10, (3, 1)),
                               r.randint(0, 255, (3, 3072))], 1)
        rec.astype("uint8").tofile(cifar / f"data_batch_{i}.bin")
    j, t = jdata.vision.CIFAR10(str(cifar)), tdata.vision.CIFAR10(str(cifar))
    _equal(t._data, j._data, "cifar bin")
    _equal(t._label, j._label, "cifar bin labels")
    assert t._data.shape == (15, 32, 32, 3)
