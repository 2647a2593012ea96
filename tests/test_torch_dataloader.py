"""The DataLoader held against the JAX package's on the CPU: its batches
bit for bit and in its order in every worker mode (in the caller, fork
workers, a thread pool, with the device-prefetch stage), its counters
and spans, collation onto the consumer's device scope, and no worker
process left behind. Worker tests run 2 workers with ``timeout=20`` and
shut their pools down in ``finally``; fork workers are asked for by
``MXTPU_MP_START=fork`` in both packages (spawn would import both
packages again in every worker)."""
import contextlib
import multiprocessing as mp
import threading
import time

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu.diagnostics import spans as jspans
from mxnet_tpu.telemetry import instruments as jinst
from mxnet_tpu_torch.diagnostics import spans as tspans
from mxnet_tpu_torch.telemetry import instruments as tinst

N, BATCH = 38, 6


def _dataset(module):
    r = onp.random.RandomState(5)
    x = r.randint(0, 255, (N, 5, 5, 3)).astype("uint8")
    y = r.randint(0, 10, (N,)).astype("int32")
    return module.gluon.data.ArrayDataset(x, y)


def _epochs(module, dataset=None, epochs=2, **kw):
    """The batches of ``epochs`` epochs as numpy (x, y) pairs with their
    dtypes; the pool is shut down after."""
    onp.random.seed(11)
    dl = module.gluon.data.DataLoader(
        dataset if dataset is not None else _dataset(module),
        batch_size=BATCH, shuffle=True, timeout=20, **kw)
    out = []
    try:
        for _ in range(epochs):
            for x, y in dl:
                out.append((x.asnumpy(), y.asnumpy()))
    finally:
        dl._shutdown_pool()
    return out


def _same_batches(got, want):
    assert len(got) == len(want) and len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        for g, w in ((gx, wx), (gy, wy)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


@pytest.fixture(autouse=True)
def _fork_and_no_children(monkeypatch):
    monkeypatch.setenv("MXTPU_MP_START", "fork")
    yield
    deadline = time.time() + 10
    while mp.active_children() and time.time() < deadline:
        time.sleep(0.05)
    assert not mp.active_children(), "a worker process was left alive"


MODES = {
    "caller": {},
    "fork": {"num_workers": 2},
    "threads": {"num_workers": 2, "thread_pool": True},
    "prefetch": {"device_prefetch": 2},
    "fork_prefetch": {"num_workers": 2, "device_prefetch": 3,
                      "last_batch": "rollover"},
    "threads_discard": {"num_workers": 2, "thread_pool": True,
                        "last_batch": "discard", "prefetch": 1},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batches_bit_for_bit_and_in_order(mode):
    kw = MODES[mode]
    want = _epochs(jmx, **kw)
    with mt.cpu():
        got = _epochs(mt, **kw)
    _same_batches(got, want)
    assert got[0][0].dtype == onp.uint8 and got[0][1].dtype == onp.int32


def test_prefetch_counters_spans_and_the_consumer_device():
    """``data_prefetch_total`` counts the delivered batches and
    ``transfer_bytes_total{h2d}`` their bytes, as in the JAX package; one
    ``dataloader_next`` span a ``next`` (the last one ends the epoch).
    Thread-pool batches land on the consumer's device scope, and outside
    a scope the port's loader raises instead of falling back to the CPU
    (no card here)."""
    counts = {}
    for name, module, inst, spans in (("jax", jmx, jinst, jspans),
                                      ("port", mt, tinst, tspans)):
        # earlier tests in the same process may have switched either off
        was = (module.telemetry.enabled(), spans.enabled())
        module.telemetry.enable()
        spans.enable()
        before = (inst.data_prefetch_total.value,
                  inst.transfer_bytes_total.labels("h2d").value)
        t0 = time.perf_counter()
        dl = module.gluon.data.DataLoader(_dataset(module), batch_size=BATCH,
                                          device_prefetch=2)
        try:
            with mt.cpu() if module is mt else contextlib.nullcontext():
                batches = list(dl)
        finally:
            if not was[0]:
                module.telemetry.disable()
            if not was[1]:
                spans.disable()
        nbytes = sum(x.asnumpy().nbytes + y.asnumpy().nbytes
                     for x, y in batches)
        ours = [r["name"] for r in spans.records() if r["t0"] >= t0]
        counts[name] = (
            len(batches), inst.data_prefetch_total.value - before[0],
            inst.transfer_bytes_total.labels("h2d").value - before[1],
            nbytes, ours.count("dataloader_next"),
            ours.count("device_prefetch"))
    assert counts["port"] == counts["jax"]
    n = counts["port"][0]
    assert counts["port"][1:] == (n, counts["port"][3], counts["port"][3],
                                  n + 1, n)
    seen = []

    class Where(mt.gluon.data.Dataset):
        def __getitem__(self, i):
            seen.append(threading.current_thread().name)
            return onp.float32(i)

        def __len__(self):
            return 8

    dl = mt.gluon.data.DataLoader(Where(), batch_size=4, num_workers=2,
                                  thread_pool=True, timeout=20)
    with mt.cpu():
        batches = list(dl)
    assert [b._data.device.type for b in batches] == ["cpu", "cpu"]
    assert seen and all(s.startswith("mxtpu-data") for s in seen)
    if not mt.num_gpus():
        with pytest.raises(mt.MXNetError):
            list(dl)


def test_user_batchify_runs_in_the_consumer_and_tensor_data_takes_threads():
    """A batchify function of the user's runs whole in the consumer's
    thread (its device scope); a dataset that yields NDArrays takes the
    thread path even without ``thread_pool`` (no process is forked)."""
    where = []

    def batchify(samples):
        where.append(threading.current_thread() is threading.main_thread())
        return mt.np.array(onp.stack([s[0] for s in samples]))

    with mt.cpu():
        dl = mt.gluon.data.DataLoader(_dataset(mt), batch_size=BATCH,
                                      batchify_fn=batchify, num_workers=2,
                                      thread_pool=True, timeout=20)
        out = list(dl)
        assert len(out) == 7 and all(where)
        nd = mt.gluon.data.SimpleDataset(
            [mt.np.array([float(i)]) for i in range(10)])
        dl = mt.gluon.data.DataLoader(nd, batch_size=4, num_workers=2,
                                      timeout=20)
        got = [b.asnumpy() for b in dl]
    assert dl._mp_pool is None and not mp.active_children()
    assert [g.ravel().tolist() for g in got] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_a_worker_that_hangs_times_out():
    class Slow(mt.gluon.data.Dataset):
        def __getitem__(self, i):
            time.sleep(1.5)
            return onp.float32(i)

        def __len__(self):
            return 4

    dl = mt.gluon.data.DataLoader(Slow(), batch_size=2, num_workers=1,
                                  thread_pool=True, timeout=0.2)
    with mt.cpu(), pytest.raises(Exception) as err:
        list(dl)
    assert "Timeout" in type(err.value).__name__
