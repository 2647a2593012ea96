"""The port's checkpoint manager across processes, on the CPU, port only
(the flows of the JAX package's tests/test_checkpoint_manager.py:390-490;
no JAX here).

This file is also the worker (``python tests/test_torch_checkpoint_process.py
MODE OUTDIR CKDIR``): a deterministic training loop of an MLP with Dropout
0.5 whose batches are a pure function of the step index, so a restored
process regenerates the batches, and (from the checkpoint's generator
states) the dropout masks, of an uninterrupted run. Modes:

  kill          commit a checkpoint at step CKPT_STEP, train on, start an
                async save that the write-begin hook holds open, take one
                more step while it is held, touch OUTDIR/write_held, sleep:
                the parent SIGKILLs it in the middle of the write;
  resume        restore (the latest committed step must be CKPT_STEP and
                the killed write's tmp dir reaped), train to TOTAL, write
                every loss and the final parameters;
  preempt       install the PreemptionHandler, touch OUTDIR/ready, train
                until SIGTERM: the handler saves synchronously and exits
                with MXTPU_CKPT_PREEMPT_EXIT_CODE;
  preempt_fail  the same with a manager that has no trainer bound, so the
                emergency save raises and the process must exit 1;
  exit_fail     queue a slow good write and a failing one, then return 0:
                the exit drains both, the good file lands, and the
                failure nobody waited for turns the exit code into 1.

A preempted worker blocks the preemption signals before anything starts a
thread (numpy's import may), so every thread inherits the mask and no other
thread takes the signal; its main thread unblocks them for an instant
between two steps (``signal.pthread_sigmask`` runs a pending signal's
handler before it returns), so the handler, which Python would otherwise
run at any bytecode of the main thread, snapshots between steps. The
uninterrupted baseline runs in the test process itself. The three workers
start together, once for the file.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

SIGNALS = (signal.SIGTERM, signal.SIGUSR1)
if __name__ == "__main__" and sys.argv[1].startswith("preempt"):
    signal.pthread_sigmask(signal.SIG_BLOCK, SIGNALS)

import numpy as onp  # noqa: E402
import pytest  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TOTAL = 8         # steps in the uninterrupted run
CKPT_STEP = 4     # the last step committed before the kill
BATCH, FEATS = 8, 6
EXIT_CODE = 17    # the preempted worker's configured clean exit code


def build(mt, torch):
    net = mt.gluon.nn.Sequential()
    net.add(mt.gluon.nn.Dense(16, activation="relu", in_units=FEATS))
    net.add(mt.gluon.nn.Dropout(0.5))
    net.add(mt.gluon.nn.Dense(1, in_units=16))
    net.initialize(device=mt.cpu(),
                   generator=torch.Generator().manual_seed(42))
    return net, mt.gluon.Trainer(net.collect_params(), "adam",
                                 {"learning_rate": 1e-2})


def train_one(mt, net, trainer, step):
    rs = onp.random.RandomState(1000 + step)
    with mt.cpu():
        x = mt.np.array(rs.standard_normal((BATCH, FEATS)).astype("f"))
        y = mt.np.array(rs.standard_normal((BATCH, 1)).astype("f"))
        with mt.autograd.record():
            loss = mt.gluon.loss.L2Loss()(net(x), y)
        loss.backward()
        trainer.step(BATCH)
    return loss.asnumpy()


def final_state(net, losses):
    out = {f"loss/{s}": v for s, v in losses.items()}
    for i, p in enumerate(net.collect_params().values()):
        out[f"param/{i}"] = p._tensor().detach().numpy().copy()
    return out


def _touch(outdir, name, text=""):
    Path(outdir, name).write_text(text)


def worker(mode, outdir, ckdir):
    import torch

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.checkpoint import manager as mgr_mod

    net, trainer = build(mt, torch)
    losses = {}
    if mode == "kill":
        mgr = mt.checkpoint.CheckpointManager(ckdir, trainer)
        for step in range(1, CKPT_STEP + 1):
            losses[step] = train_one(mt, net, trainer, step)
        mgr.save(step=CKPT_STEP)
        mgr.flush()                      # committed: the resume target
        for step in range(CKPT_STEP + 1, CKPT_STEP + 3):
            losses[step] = train_one(mt, net, trainer, step)
        held = []

        def hold(path):                  # on the IO thread
            held.append(path)
            time.sleep(120)              # the parent SIGKILLs us first

        mgr_mod._WRITE_BEGIN_HOOK = hold
        mgr.save(step=CKPT_STEP + 2)
        while not held:
            time.sleep(0.01)
        train_one(mt, net, trainer, CKPT_STEP + 3)   # the write is held
        _touch(outdir, "write_held", held[0])
        time.sleep(120)                  # killed here
        return 1
    if mode == "resume":
        mgr = mt.checkpoint.CheckpointManager(ckdir, trainer)
        leftovers = [n for n in os.listdir(ckdir) if n.startswith(".tmp-")]
        result = mgr.restore()
        for step in range(result.step + 1, TOTAL + 1):
            losses[step] = train_one(mt, net, trainer, step)
        onp.savez(Path(outdir, "resume.npz"), **final_state(net, losses))
        _touch(outdir, "resume.json", json.dumps(
            {"step": result.step, "tmp_left": leftovers}))
        return 0
    if mode in ("preempt", "preempt_fail"):
        mgr = mt.checkpoint.CheckpointManager(
            ckdir, trainer if mode == "preempt" else None)
        done = [0]
        mt.checkpoint.install_preemption_handler(
            mgr, exit_code=EXIT_CODE,
            user_state_fn=lambda: {"next_step": done[0] + 1})
        _touch(outdir, "ready")
        for step in range(1, 100000):    # SIGTERM arrives long before
            train_one(mt, net, trainer, step % TOTAL + 1)
            done[0] = step
            # between two steps: a pending signal's handler runs here
            signal.pthread_sigmask(signal.SIG_UNBLOCK, SIGNALS)
            signal.pthread_sigmask(signal.SIG_BLOCK, SIGNALS)
        return 3
    if mode == "exit_fail":
        from mxnet_tpu_torch import _checkpoint_io as cio

        def slow_write():
            time.sleep(0.5)
            Path(outdir, "landed").write_text("yes")

        cio.async_run(Path(outdir, "landed"), slow_write)
        cio.async_save_npz(Path(ckdir, "missing", "x.npz"),
                           {"a": onp.zeros(3)})
        return 0
    raise SystemExit(f"unknown mode {mode!r}")


def _start(mode, tmp):
    outdir, ckdir = tmp / mode / "out", tmp / mode / "ck"
    outdir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, __file__, mode, str(outdir), str(ckdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return proc, outdir, ckdir


def _wait_for(proc, marker, timeout=120):
    deadline = time.time() + timeout
    while not marker.exists():
        if proc.poll() is not None:
            raise AssertionError(proc.stderr.read()[-2000:])
        assert time.time() < deadline, f"the worker never wrote {marker}"
        time.sleep(0.02)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """The kill, both preempt and the exit workers, started together."""
    tmp = tmp_path_factory.mktemp("ckpt_workers")
    procs = {m: _start(m, tmp)
             for m in ("kill", "preempt", "preempt_fail", "exit_fail")}
    yield tmp, procs
    for proc, _, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=60)


def _baseline():
    import torch

    import mxnet_tpu_torch as mt

    net, trainer = build(mt, torch)
    losses = {s: train_one(mt, net, trainer, s)
              for s in range(1, TOTAL + 1)}
    return final_state(net, losses)


def test_sigkill_mid_write_then_bitwise_resume(workers):
    tmp, procs = workers
    proc, outdir, ckdir = procs["kill"]
    _wait_for(proc, outdir / "write_held")
    proc.kill()                     # SIGKILL in the middle of the write
    proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL
    from mxnet_tpu_torch.checkpoint import verify_checkpoint

    assert verify_checkpoint(ckdir, step=CKPT_STEP)["ok"]
    assert not (ckdir / f"step-{CKPT_STEP + 2:08d}").exists()
    assert (ckdir / f".tmp-step-{CKPT_STEP + 2:08d}").exists()

    routdir = tmp / "resume"
    routdir.mkdir()
    out = subprocess.run(
        [sys.executable, __file__, "resume", str(routdir), str(ckdir)],
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    info = json.loads((routdir / "resume.json").read_text())
    assert info == {"step": CKPT_STEP, "tmp_left": []}
    resumed = dict(onp.load(routdir / "resume.npz"))
    want = _baseline()
    assert sorted(resumed) == sorted(
        k for k in want if not k.startswith("loss/")
        or int(k[5:]) > CKPT_STEP)
    for k, v in resumed.items():
        onp.testing.assert_array_equal(v, want[k], err_msg=k)


def test_sigterm_preemption_commits_and_exits_clean(workers):
    _, procs = workers
    proc, outdir, ckdir = procs["preempt"]
    _wait_for(proc, outdir / "ready")
    time.sleep(0.2)                 # a few steps
    proc.send_signal(signal.SIGTERM)
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == EXIT_CODE, err[-2000:]

    from mxnet_tpu_torch.checkpoint import verify_checkpoint

    rep = verify_checkpoint(ckdir)
    assert rep["ok"], rep
    manifest = json.loads((ckdir / f"step-{rep['step']:08d}" /
                           "MANIFEST.json").read_text())
    assert manifest["reason"] == "preempt"
    nxt = manifest["meta"]["user_state"]["next_step"]
    assert manifest["meta"]["optimizer"]["num_update"] == nxt - 1 >= 1
    assert manifest["step"] == rep["step"] == nxt - 1   # the spans' step
    tool = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.ckpt", "verify",
         str(ckdir)], env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120)
    assert tool.returncode == 0 and tool.stdout.startswith("OK"), tool


def test_failed_emergency_save_exits_1(workers):
    _, procs = workers
    proc, outdir, _ = procs["preempt_fail"]
    _wait_for(proc, outdir / "ready")
    proc.send_signal(signal.SIGTERM)
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 1, (proc.returncode, err[-2000:])
    assert b"FAILED" in err, err[-2000:]



def test_unconsumed_write_failure_fails_the_exit(workers):
    _, procs = workers
    proc, outdir, _ = procs["exit_fail"]
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 1, (proc.returncode, err[-2000:])
    assert b"checkpoint IO failed at exit" in err, err[-2000:]
    assert b"FileNotFoundError" in err, err[-2000:]
    assert (outdir / "landed").read_text() == "yes"


if __name__ == "__main__":
    sys.exit(worker(*sys.argv[1:4]))
