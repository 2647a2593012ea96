"""RecordIO files written by each package and read by the other, byte for
byte, through the record readers, ``RecordFileDataset`` and the
DataLoader's fork workers; and the ``mx.io`` iterators against the JAX
package's on the same files and arrays (CPU)."""
import multiprocessing as mp

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt


def _records():
    r = onp.random.RandomState(3)
    out = []
    for i in range(9):
        label = float(i) if i % 2 else r.rand(3).astype("f")
        payload = r.bytes(int(r.randint(0, 23)))
        out.append(((0, label, i + 100, 0), payload))
    return out


def _write(module, path):
    recs = _records()
    w = module.recordio.MXIndexedRecordIO(str(path.with_suffix(".idx")),
                                          str(path), "w")
    for key, (hdr, payload) in enumerate(recs):
        w.write_idx(key * 3, module.recordio.pack(hdr, payload))
    w.close()
    s = module.recordio.MXRecordIO(str(path) + ".seq", "w")
    for hdr, payload in recs:
        s.write(module.recordio.pack(hdr, payload))
    s.write(b"")
    s.write("text")
    s.close()


def _read(module, path):
    r = module.recordio.MXIndexedRecordIO(str(path.with_suffix(".idx")),
                                          str(path), "r")
    indexed = [module.recordio.unpack(r.read_idx(k)) for k in r.keys[::-1]]
    r.close()
    s = module.recordio.MXRecordIO(str(path) + ".seq", "r")
    seq = []
    while (rec := s.read()) is not None:
        seq.append(rec)
    s.close()
    return indexed, seq


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recordio_files_cross_both_ways(tmp_path, writer, monkeypatch):
    monkeypatch.setenv("MXTPU_MP_START", "fork")
    src, dst = (jmx, mt) if writer == "jax" else (mt, jmx)
    path = tmp_path / "data.rec"
    _write(src, path)
    other = tmp_path / "other.rec"
    _write(dst, other)
    for name in ("{}.rec", "{}.idx", "{}.rec.seq"):
        assert (tmp_path / name.format("data")).read_bytes() == \
            (tmp_path / name.format("other")).read_bytes(), name
    (gi, gs), (wi, ws) = _read(dst, path), _read(src, path)
    assert gs == ws and len(gs) == 11
    for (gh, gp), (wh, wp) in zip(gi, wi):
        assert gp == wp and gh.flag == wh.flag and gh.id == wh.id
        onp.testing.assert_array_equal(gh.label, wh.label)
    # RecordFileDataset by position, in the caller and in fork workers
    ds = mt.gluon.data.RecordFileDataset(str(path))
    jds = jmx.gluon.data.RecordFileDataset(str(path))
    assert len(ds) == len(jds) == 9
    assert [ds[i] for i in range(9)] == [jds[i] for i in range(9)]
    dl = mt.gluon.data.DataLoader(ds, batch_size=3, num_workers=2,
                                  batchify_fn=mt.gluon.data.batchify.AsList(),
                                  timeout=20)
    try:
        with mt.cpu():
            got = [rec for batch in dl for rec in batch]
    finally:
        dl._shutdown_pool()
    assert got == [jds[i] for i in range(9)]
    assert not mp.active_children()


def _batches(it, n=None):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [lab.asnumpy() for lab in (b.label or [])], b.pad))
        if n and len(out) == n:
            break
    return out


def _same(got, want):
    assert len(got) == len(want) and want
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_ndarray_csv_mnist_resize_and_prefetching_iters(tmp_path):
    r = onp.random.RandomState(4)
    x = r.rand(11, 3).astype("f")
    y = r.randint(0, 4, (11,)).astype("int32")
    onp.savetxt(tmp_path / "d.csv", x, delimiter=",")
    onp.savetxt(tmp_path / "l.csv", y, delimiter=",")

    def iters(m):
        return {
            "pad": lambda: m.io.NDArrayIter(x, y, 4),
            "discard": lambda: m.io.NDArrayIter(
                {"a": x, "b": x * 2}, y, 4, last_batch_handle="discard"),
            "roll_over": lambda: m.io.NDArrayIter(
                [x, x], None, 4, shuffle=True, last_batch_handle="roll_over"),
            "csv": lambda: m.io.CSVIter(str(tmp_path / "d.csv"), (3,),
                                        str(tmp_path / "l.csv"), (1,), 5),
            "mnist": lambda: m.io.MNISTIter(batch_size=100, shuffle=True,
                                            flat=True, path_root=str(
                                                tmp_path / "none")),
        }

    for name in iters(jmx):
        onp.random.seed(9)
        jit = iters(jmx)[name]()
        want = _batches(jit)
        jit.reset()
        want += _batches(jit)
        onp.random.seed(9)
        with mt.cpu():
            tit = iters(mt)[name]()
            got = _batches(tit)
            tit.reset()
            got += _batches(tit)
            assert tit.provide_data == jit.provide_data
            assert [d.dtype for d in tit.provide_data] == \
                [d.dtype for d in jit.provide_data]
        _same(got, want)
    with mt.cpu():
        got = _batches(mt.io.ResizeIter(mt.io.NDArrayIter(x, y, 4), 5))
        pre = mt.io.PrefetchingIter(mt.io.NDArrayIter(x, y, 4))
        got_pre = _batches(pre)
        pre.reset()
        got_pre += _batches(pre)
    _same(got, _batches(jmx.io.ResizeIter(jmx.io.NDArrayIter(x, y, 4), 5)))
    jpre = jmx.io.PrefetchingIter(jmx.io.NDArrayIter(x, y, 4))
    want_pre = _batches(jpre)
    jpre.reset()
    _same(got_pre, want_pre + _batches(jpre))
    assert mt.io.io.NDArrayIter is mt.io.NDArrayIter


def test_libsvm_iter(tmp_path):
    path = tmp_path / "d.libsvm"
    path.write_text("1 0:1.5 3:2\n0 2:-1\n\n1 1:0.5 2:4 4:1\n2 0:3\n")
    j = jmx.io.LibSVMIter(str(path), (5,), batch_size=3)
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in j]
    with mt.cpu():
        t = mt.io.LibSVMIter(str(path), (5,), batch_size=3)
        got = [(b.data[0], b.label[0].asnumpy(), b.pad) for b in t]
        assert t.provide_data == j.provide_data
    assert len(got) == len(want) == 2
    for (g, gl, gp), (w, wl, wp) in zip(got, want):
        assert g.stype == "csr" and g.shape == (3, 5)
        onp.testing.assert_array_equal(g.asnumpy(), w)
        onp.testing.assert_array_equal(g.tostype("default").asnumpy(), w)
        assert gl.tobytes() == wl.tobytes() and gp == wp
