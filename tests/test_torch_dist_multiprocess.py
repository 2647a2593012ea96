"""Data-parallel training across processes in the port, on the CPU over
gloo, launched by ``mxnet_tpu_torch/tools/launch.py`` (the counterpart of
tests/test_dist_multiprocess.py with tests/dist_worker.py).

The JAX package's single process trains ``dist_worker.py``'s MLP
(``Dense(32, relu) -> Dense(8)``, 3 SGD steps at lr 0.5 over a batch of
16) on the full batch in this test's process, after writing its initial
parameters to a file; 2 and 4 port ranks load them (``convert``), each
trains on its shard through ``Trainer(kvstore='tpu_dist')``, dividing by
the global batch, and writes what it ended with. The ranks must end bit
for bit equal, and within rtol 1e-5, atol 1e-6 of the JAX package's
process. The same holds for a row-sparse table
(``Embedding(16, 4, sparse_grad=True) -> Dense(3)``, SGD with momentum
and weight decay, lazy row updates): each rank's shard looks up rows that
the others' do not, and every rank must update the rows that any rank
touched, as the JAX package's single process on the full batch does,
while the rows no shard touches keep their values. The 4 ranks then push two rounds of 2-bit compression as
``tools/distributed_train.py --compress`` does: each rank's pulled sums
equal the sum of every rank's dequantized values, computed here by the
JAX package's ``GradientCompression``. One launch each of 2 and 4 ranks
serves every test.

Run as a script (``python tests/test_torch_dist_multiprocess.py OUTDIR
INIT``), this file is the rank's body; it imports the port alone. Every
launch has a time limit, so a hung rank fails its test.
"""
import concurrent.futures
import os
import subprocess
import sys

import numpy as onp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL_BATCH, STEPS, LR = 16, 3, 0.5
ROWS, UNTOUCHED = 16, 4           # the table's last 4 rows: no shard's
SPARSE_OPT = dict(learning_rate=LR, momentum=0.9, wd=0.01)


def _data():
    x = onp.random.RandomState(0).rand(GLOBAL_BATCH, 12).astype("f")
    y = onp.random.RandomState(1).randint(0, 8, (GLOBAL_BATCH,))
    return x, y


def _sparse_data():
    ids = onp.random.RandomState(2).randint(
        0, ROWS - UNTOUCHED, (GLOBAL_BATCH,)).astype("int32")
    y = onp.random.RandomState(3).randint(0, 3, (GLOBAL_BATCH,))
    return ids, y


def _sparse_net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Embedding(ROWS, 4, sparse_grad=True),
            pkg.gluon.nn.Dense(3))
    return net


def _train(pkg, net, trainer, x, y):
    lossfn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(STEPS):
        with pkg.autograd.record():
            loss = lossfn(net(x), y)
        loss.backward()
        trainer.step(GLOBAL_BATCH)


def rank_main(outdir, init):
    """One rank: dist_worker.py's training and the row-sparse table, in
    the port on the CPU; with 4 ranks also the compressed rounds of
    ``tools/distributed_train.py --compress``."""
    import torch

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.convert import load_jax_params

    kv = mt.kvstore.create("tpu_dist")
    rank, nw = kv.rank, kv.num_workers
    assert kv.backend == "gloo", kv.backend
    x_all, y_all = _data()
    ids_all, c_all = _sparse_data()
    shard = GLOBAL_BATCH // nw
    mine = slice(rank * shard, (rank + 1) * shard)
    with mt.cpu():
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Dense(32, activation="relu"),
                mt.gluon.nn.Dense(8))
        net.initialize()
        net(mt.np.array(x_all[:2]))
        init_np = dict(onp.load(init))
        load_jax_params(net, {k[4:]: v for k, v in init_np.items()
                              if k.startswith("mlp/")})
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": LR}, kvstore=kv)
        _train(mt, net, trainer, mt.np.array(x_all[mine]),
               mt.np.array(y_all[mine]))
        snet = _sparse_net(mt)
        snet.initialize()
        snet(mt.np.array(ids_all[:2], dtype="int32"))
        load_jax_params(snet, {k[7:]: v for k, v in init_np.items()
                               if k.startswith("sparse/")})
        strainer = mt.gluon.Trainer(snet.collect_params(), "sgd",
                                    dict(SPARSE_OPT), kvstore=kv)
        _train(mt, snet, strainer,
               mt.np.array(ids_all[mine], dtype="int32"),
               mt.np.array(c_all[mine]))
    onp.savez(os.path.join(outdir, f"params_rank{rank}.npz"),
              **{f"{tag}/{n}": p._tensor().detach().numpy()
                 for tag, m in (("mlp", net), ("sparse", snet))
                 for n, p in m.collect_params().items()})
    if nw == 4:
        from mxnet_tpu_torch.tools import distributed_train

        r1, r2 = distributed_train.compressed(kv, mt.cpu())
        torch.save({"round1": r1, "round2": r2, "nw": nw},
                   os.path.join(outdir, f"kv_rank{rank}.pt"))
    kv.barrier()
    assert torch.distributed.get_world_size() == nw


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(n, cmd):
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
         str(n), "--timeout", "240", *cmd],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(want, {n: directory})``: the JAX package's single process writes
    its initial parameters for the ranks, then trains on the full batch
    while one launch of n ranks, for n = 2 and 4 at once, trains from
    them; ``want`` is its parameters after training."""
    import mxnet_tpu as mx
    from mxnet_tpu import autograd, gluon

    mx.seed(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(32, activation="relu"), gluon.nn.Dense(8))
    net.initialize()
    x_all, y_all = _data()
    net(mx.np.array(x_all[:2]))
    snet = _sparse_net(mx)
    snet.initialize()
    ids_all, c_all = _sparse_data()
    snet(mx.np.array(ids_all[:2], dtype="int32"))
    nets = (("mlp", net), ("sparse", snet))

    def params():
        return {f"{tag}/{n}": onp.asarray(p.data().asnumpy())
                for tag, m in nets for n, p in m.collect_params().items()}

    init = str(tmp_path_factory.mktemp("init") / "init.npz")
    onp.savez(init, **params())
    dirs = {n: tmp_path_factory.mktemp(f"n{n}") for n in (2, 4)}
    body = os.path.join(REPO, "tests", os.path.basename(__file__))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(_launch, n, [sys.executable, body, str(d), init])
                for n, d in dirs.items()]
        _train(mx, net, gluon.Trainer(net.collect_params(), "sgd",
                                      {"learning_rate": LR},
                                      kvstore="tpu_dist"),
               mx.np.array(x_all), mx.np.array(y_all))
        _train(mx, snet, gluon.Trainer(snet.collect_params(), "sgd",
                                       dict(SPARSE_OPT), kvstore="tpu_dist"),
               mx.np.array(ids_all, dtype="int32"), mx.np.array(c_all))
        for job in jobs:
            job.result()
    return params(), dirs, dict(onp.load(init))


def _ranks_against(want, dirs, n, tag):
    """Every rank's ``tag/`` parameters bit for bit rank 0's, and within
    rtol 1e-5, atol 1e-6 of the JAX package's single process."""
    ranks = [{k: v for k, v in onp.load(dirs[n] / f"params_rank{r}.npz")
              .items() if k.startswith(tag + "/")} for r in range(n)]
    want = {k: v for k, v in want.items() if k.startswith(tag + "/")}
    assert sorted(ranks[0]) == sorted(want)
    for r in range(1, n):
        for k in ranks[0]:
            onp.testing.assert_array_equal(
                ranks[r][k], ranks[0][k], err_msg=f"{k}: rank {r}")
    for k in want:
        onp.testing.assert_allclose(ranks[0][k], want[k], rtol=1e-5,
                                    atol=1e-6, err_msg=k)
    return ranks[0]


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_match_jax_single_process(n, runs):
    want, dirs, _ = runs
    _ranks_against(want, dirs, n, "mlp")


@pytest.mark.parametrize("n", [2, 4])
def test_row_sparse_ranks_update_every_touched_row(n, runs):
    """Each rank updates the rows that any rank's shard looked up (their
    summed gradient is nonzero on every rank), so the ranks stay equal and
    match one process on the full batch; the untouched rows keep their
    initial values, as the lazy update leaves them."""
    want, dirs, init = runs
    ids, _ = _sparse_data()
    shard = GLOBAL_BATCH // n
    assert any(set(ids[r * shard:(r + 1) * shard]) - set(ids[:shard])
               for r in range(1, n))   # rows rank 0's shard never looks up
    got = _ranks_against(want, dirs, n, "sparse")
    table = next(k for k in got if k.endswith("weight")
                 and got[k].shape == (ROWS, 4))
    onp.testing.assert_array_equal(got[table][-UNTOUCHED:],
                                   init[table][-UNTOUCHED:])
    assert not onp.array_equal(got[table][:-UNTOUCHED],
                               init[table][:-UNTOUCHED])


def test_four_ranks_compressed_pushpull(runs):
    import torch

    from mxnet_tpu.kvstore.gradient_compression import GradientCompression

    got = [torch.load(runs[1][4] / f"kv_rank{r}.pt") for r in range(4)]
    assert all(g["nw"] == 4 for g in got)
    want = [onp.zeros((6, 5), "f"), onp.zeros((6, 5), "f")]
    for r in range(4):
        rs = onp.random.RandomState(100 + r)
        gc = GradientCompression(type="2bit", threshold=0.5)
        for i in range(2):
            g = rs.uniform(-1.2, 1.2, (6, 5)).astype("f")
            want[i] += onp.asarray(gc.compress_pipeline("w:0", g))
    for r in range(4):
        for i, key in enumerate(("round1", "round2")):
            onp.testing.assert_array_equal(got[r][key].numpy(),
                                           got[0][key].numpy())
            onp.testing.assert_allclose(got[r][key].numpy(), want[i],
                                        rtol=1e-6, atol=1e-6)


def test_launcher_kills_the_rest_and_returns_the_first_failure(tmp_path):
    """A rank that fails ends the job with its code; the rank left
    waiting is killed, and a job past its time limit gives 124."""
    from mxnet_tpu_torch.tools import launch

    code = ("import os, sys, time\n"
            "r = int(os.environ['RANK'])\n"
            "assert os.environ['WORLD_SIZE'] == '2'\n"
            "open(sys.argv[1] + f'/{r}', 'w').write(os.environ['MASTER_PORT'])"
            "\n"
            "while r == 1 and not os.path.exists(sys.argv[1] + '/0'):\n"
            "    time.sleep(0.01)\n"
            "sys.exit(3) if r == 1 else time.sleep(60)\n")
    assert launch.launch(2, [sys.executable, "-c", code, str(tmp_path)],
                         timeout=50) == 3
    assert (tmp_path / "0").read_text() == (tmp_path / "1").read_text()
    assert launch.launch(1, [sys.executable, "-c", "import time; "
                             "time.sleep(60)"], timeout=0.5) == 124


if __name__ == "__main__":
    rank_main(sys.argv[1], sys.argv[2])
