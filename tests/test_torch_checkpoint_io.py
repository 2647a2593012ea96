"""The port's checkpoint IO chain and manager on the CPU, port only
(the flows of the JAX package's tests/test_checkpoint_manager.py).

``_checkpoint_io`` runs each path's ops on an IO thread of its own, in the
order queued, and keeps the first failure with its original exception and
traceback; the manager's save returns while its write is held open, a
re-save of one step serializes its tmp reset, a partial tmp is reaped and a
corrupt latest falls back; multi-worker saves meet the same three fences on
every rank; ``save_parameters`` writes on the IO chain and its readers
barrier; and a net with Dropout 0.5 restored from a checkpoint draws the
masks an uninterrupted run draws.
"""
import os
import threading
import time
import traceback

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _checkpoint_io as cio
from mxnet_tpu_torch.checkpoint import (CheckpointCorrupt, CheckpointManager,
                                        verify_checkpoint)
from mxnet_tpu_torch.checkpoint import manager as mgr_mod

BATCH, FEATS = 8, 6


def _build(seed=7, dropout=0.0):
    net = mt.gluon.nn.Sequential()
    net.add(mt.gluon.nn.Dense(16, activation="relu", in_units=FEATS))
    if dropout:
        net.add(mt.gluon.nn.Dropout(dropout))
    net.add(mt.gluon.nn.Dense(1, in_units=16))
    net.initialize(device=mt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    return net, mt.gluon.Trainer(net.collect_params(), "adam",
                                 {"learning_rate": 1e-2})


def _train_one(net, trainer, step):
    rs = onp.random.RandomState(1000 + step)
    with mt.cpu():
        x = mt.np.array(rs.standard_normal((BATCH, FEATS)).astype("f"))
        y = mt.np.array(rs.standard_normal((BATCH, 1)).astype("f"))
        with mt.autograd.record():
            loss = mt.gluon.loss.L2Loss()(net(x), y)
        loss.backward()
        trainer.step(BATCH)
    return loss.asnumpy()


def _params_of(trainer):
    return [p._tensor().detach().clone() for p in trainer._params]


@pytest.fixture
def hook():
    """Sets ``manager._WRITE_BEGIN_HOOK`` for one test; always cleared."""
    def set_hook(fn):
        mgr_mod._WRITE_BEGIN_HOOK = fn
    yield set_hook
    mgr_mod._WRITE_BEGIN_HOOK = None


def test_io_chain_order_and_first_error(tmp_path):
    """Ops on one path run in the order queued, one at a time; the FIRST
    failure is kept as the original object with its IO-thread traceback
    (a later failure does not replace it, later ops still run);
    wait_for_path raises it once; flush_all drains every path and raises
    the first failure while the good path lands."""
    path = str(tmp_path / "chain")
    seen, gate = [], threading.Event()

    def op(i):
        def run():
            if i == 0:
                gate.wait(10)
            seen.append(i)
        return run

    def fail_first():
        raise FileNotFoundError("first")

    def fail_second():
        raise OSError("second")

    for i in range(3):
        cio.async_run(path, op(i))
    cio.async_run(path, fail_first)
    cio.async_run(path, fail_second)
    cio.async_run(path, op(3))
    time.sleep(0.05)
    assert seen == []       # op 0 holds the chain: nothing overtakes it
    gate.set()
    with pytest.raises(FileNotFoundError, match="first") as e:
        cio.wait_for_path(path)
    assert seen == [0, 1, 2, 3]
    frames = traceback.extract_tb(e.value.__traceback__)
    assert any(f.name == "fail_first" for f in frames)
    cio.wait_for_path(path)   # consumed: a later wait is clean

    good = str(tmp_path / "ok.npz")
    bad = str(tmp_path / "missing_dir" / "bad.npz")
    cio.async_save_npz(good, {"a": onp.arange(4.0)})
    cio.async_save_npz(bad, {"b": onp.arange(4.0)})
    with pytest.raises(FileNotFoundError) as e:
        cio.flush_all()
    assert any(f.name == "write" and f.filename.endswith("_checkpoint_io.py")
               for f in traceback.extract_tb(e.value.__traceback__))
    assert onp.load(good)["a"].shape == (4,)
    cio.flush_all()


def test_save_returns_while_the_write_is_held(tmp_path, hook):
    """save() returns after the snapshot, not after the write: with the
    write held open on the IO thread, training steps keep completing and
    nothing commits until it is released."""
    net, trainer = _build()
    _train_one(net, trainer, 1)
    mgr = CheckpointManager(tmp_path, trainer, async_save=True)
    want = _params_of(trainer)
    started, release = threading.Event(), threading.Event()

    def hold(path):  # noqa: ARG001 - on the IO thread
        started.set()
        release.wait(30)

    hook(hold)
    try:
        t0 = time.perf_counter()
        mgr.save(step=1)
        assert time.perf_counter() - t0 < 5.0
        assert started.wait(10), "the write never started"
        for s in range(2, 5):
            _train_one(net, trainer, s)
        assert mgr.steps() == []
    finally:
        release.set()
    mgr.flush()
    assert mgr.steps() == [1]
    assert verify_checkpoint(tmp_path, step=1)["ok"]
    # the checkpoint holds the values at save(), not the later steps'
    mgr.restore()
    assert all(torch.equal(a, b) for a, b in zip(_params_of(trainer), want))


def test_resave_of_a_step_serializes_its_tmp_reset(tmp_path, hook):
    net, trainer = _build()
    _train_one(net, trainer, 1)
    mgr = CheckpointManager(tmp_path, trainer, async_save=True)
    started, release, calls = threading.Event(), threading.Event(), []

    def hold_first(path):
        calls.append(path)
        if len(calls) == 1:
            started.set()
            release.wait(30)

    hook(hold_first)
    mgr.save(step=1)
    assert started.wait(10), "the first write never started"
    mgr.save(step=1)           # re-save while the first write is held
    release.set()
    mgr.flush()
    assert len(calls) == 2     # both writes ran, in order
    assert mgr.steps() == [1]
    assert verify_checkpoint(tmp_path, step=1)["ok"]


def test_partial_tmp_reaped_and_corrupt_latest_falls_back(tmp_path):
    net, trainer = _build()
    _train_one(net, trainer, 1)
    mgr = CheckpointManager(tmp_path, trainer)
    mgr.save(step=1, sync=True)
    good = _params_of(trainer)
    stale = tmp_path / ".tmp-step-00000009"
    stale.mkdir()
    (stale / "arrays.npz").write_bytes(b"partial garbage")
    orphan = tmp_path / "step-00000008"
    orphan.mkdir()
    (orphan / "arrays.npz").write_bytes(b"no manifest")
    assert mgr.steps() == [1]
    CheckpointManager(tmp_path, trainer)   # a new manager reaps tmp dirs
    assert not stale.exists()

    _train_one(net, trainer, 2)
    mgr.save(step=2, sync=True)
    npz = os.path.join(mgr.step_dir(2), "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(step=2)     # an explicit step never substitutes
    with pytest.warns(UserWarning, match="corrupt"):
        assert mgr.restore().step == 1
    assert all(torch.equal(a, b) for a, b in zip(_params_of(trainer), good))


class _FakeKV:
    """A two-worker kvstore stand-in: a threading.Barrier plays the
    collective, so a rank that skips or adds a fence breaks the barrier
    (BrokenBarrierError at the timeout) instead of passing."""

    def __init__(self, rank, world, gate):
        self.rank = rank
        self.num_workers = world
        self._gate = gate
        self.barrier_calls = 0

    def barrier(self):
        self.barrier_calls += 1
        self._gate.wait(timeout=60)


@pytest.mark.parametrize("mode", ["replicated", "sharded"])
def test_multiworker_saves_meet_the_same_fences(tmp_path, mode):
    net, trainer = _build()
    _train_one(net, trainer, 1)
    want = _params_of(trainer)
    gate = threading.Barrier(2)
    kvs = [_FakeKV(r, 2, gate) for r in range(2)]
    mgrs = [CheckpointManager(tmp_path, trainer, kvstore=kvs[r], mode=mode)
            for r in range(2)]
    errs = []

    def rank(r):
        try:
            mgrs[r].save(step=1)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append((r, e))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and not errs, errs
    assert kvs[0].barrier_calls == kvs[1].barrier_calls == 3
    assert verify_checkpoint(tmp_path, step=1)["ok"]
    files = sorted(os.listdir(mgrs[0].step_dir(1)))
    if mode == "replicated":
        assert files == ["MANIFEST.json", "arrays.npz"]
    else:
        assert {"shard-00000.npz", "shard-00001.npz"} <= set(files)
    for p in trainer._params:
        p.set_data(torch.zeros(p.shape))
    assert CheckpointManager(tmp_path, trainer).restore(step=1).step == 1
    assert all(torch.equal(a, b) for a, b in zip(_params_of(trainer), want))


def test_failed_async_write_surfaces_and_never_commits(tmp_path, hook):
    """A failed payload write is raised, as the original exception, by
    flush(), by restore() and by flush_all(), and never committed on."""
    net, trainer = _build()
    _train_one(net, trainer, 1)

    def explode(path):  # noqa: ARG001
        raise OSError("disk on fire")

    hook(explode)
    for barrier in ("flush", "restore", "flush_all"):
        d = tmp_path / barrier
        mgr = CheckpointManager(d, trainer, async_save=True)
        mgr.save(step=1)
        with pytest.raises(OSError, match="disk on fire") as e:
            if barrier == "flush_all":
                cio.flush_all()
            else:
                getattr(mgr, barrier)()
        assert any(f.name == "explode"
                   for f in traceback.extract_tb(e.value.__traceback__))
        assert mgr.steps() == [] and not list(d.glob("step-*"))


def test_save_parameters_async_with_barriers(tmp_path):
    """save_parameters returns with the write queued (here behind a held
    op on the same path) and the values it had at the call; load_parameters
    and waitall wait for it; nd.save is complete on return and nd.load
    waits too."""
    net, _ = _build()
    path = str(tmp_path / "net.params")
    want = [p._tensor().detach().clone()
            for p in net.collect_params().values()]
    release = threading.Event()
    cio.async_run(path, lambda: release.wait(30))
    net.save_parameters(path)
    assert not os.path.exists(path)
    with torch.no_grad():
        for p in net.collect_params().values():
            p._tensor().add_(1.0)     # training goes on
    threading.Timer(0.2, release.set).start()
    other, _ = _build(seed=3)
    other.load_parameters(path)       # barriers on the queued write
    assert all(torch.equal(p._tensor(), w) for p, w in
               zip(other.collect_params().values(), want))

    release = threading.Event()
    path2 = str(tmp_path / "net2.params")
    cio.async_run(path2, lambda: release.wait(30))
    net.save_parameters(path2)
    threading.Timer(0.2, release.set).start()
    mt.waitall()
    assert os.path.getsize(path2) > 0

    with mt.cpu():
        arr = mt.np.arange(6).reshape(2, 3)
    fname = str(tmp_path / "a.npz")
    release = threading.Event()
    cio.async_run(fname, lambda: release.wait(30))
    threading.Timer(0.2, release.set).start()
    mt.nd.save(fname, {"a": arr})      # ordered after the held op
    assert "a" in onp.load(fname)
    assert mt.nd.load(fname, device=mt.cpu())["a"].shape == (2, 3)


def test_dropout_resume_draws_the_same_masks(tmp_path):
    """A net with Dropout 0.5: the losses of steps 4-7 after a restore of
    step 3 equal those of the uninterrupted run bit for bit, in this
    process and in a net built from another seed (its generators are set
    in place from the checkpoint)."""
    net, trainer = _build(dropout=0.5)
    for s in range(1, 4):
        _train_one(net, trainer, s)
    mgr = CheckpointManager(tmp_path, trainer)
    mgr.save(step=3)
    gen = net[1].generator
    want = [_train_one(net, trainer, s) for s in range(4, 8)]
    after = _params_of(trainer)
    assert mgr.restore().step == 3
    assert net[1].generator is gen     # set in place, not replaced
    got = [_train_one(net, trainer, s) for s in range(4, 8)]
    assert all(onp.array_equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(_params_of(trainer), after))

    net2, trainer2 = _build(seed=11, dropout=0.5)
    CheckpointManager(tmp_path, trainer2).restore()
    got2 = [_train_one(net2, trainer2, s) for s in range(4, 8)]
    assert all(onp.array_equal(a, b) for a, b in zip(got2, want))
    # without the generators' states the masks differ: the check can fail
    net3, trainer3 = _build(seed=11, dropout=0.5)
    CheckpointManager(tmp_path, trainer3).restore()
    net3[1].generator.manual_seed(5)
    assert not onp.array_equal(_train_one(net3, trainer3, 4), want[0])
