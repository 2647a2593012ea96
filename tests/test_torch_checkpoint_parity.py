"""The checkpoint manager (``mx.checkpoint``) between the JAX package and
the PyTorch port, on the CPU, both ways.

Two nets in each package from the same weights (carried by
``convert.load_jax_params``): the JAX package's own test MLP
(tests/test_checkpoint_manager.py:_build: Dense 16 relu, Dense 1, Adam) and
a bf16 Dense with f32 masters (Adam, ``multi_precision``). Each takes three
steps on the same batches in both packages. Then:

  * a tiny BERTForQA's Trainer names and orders its parameters alike in
    both packages, as the MLP's and the Dense's do (a restore checks each
    name);
  * the same state (the JAX trainer's, carried into the port's: three
    steps apart, the packages round f32 differently in the last place)
    gives the same checkpoint: array names, shapes, dtypes (``bfloat16``
    for the bf16 weight) and crc32 equal per array, the random-state
    arrays aside (``rng/key`` in the JAX package, ``torch_rng/*`` in the
    port: the streams differ); the same meta keys (the JAX package's
    ``rng_key_dtype`` aside, for the same reason) and values, and the same
    step directory;
  * a checkpoint either package writes restores in the other bit for bit
    (parameters, optimizer states, ``num_update`` and each parameter's t,
    loss scale, stale gradients); two more steps in each package then agree
    within 1e-6 relative (f32 leaves; the JAX package runs its update's
    scalars in float64 with 64-bit types on, the port in f32) and the bf16
    weights within one bf16 ulp;
  * ``verify_checkpoint`` and the two ``tools/ckpt.py verify`` agree on
    each other's directory, with exit codes 0 (ok), 1 (a flipped payload
    byte, ``CheckpointCorrupt`` on restore in both) and 2 (not found), and
    the two tools' ``list --json`` and ``inspect --json`` print the same;
  * keep-last and milestone retention keep the same steps;
  * the ``ckpt_*`` telemetry series have the same names, labels and
    outcomes after an ok save, a failed save and a restore.
"""
import importlib.util
import json
import os
from pathlib import Path

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu.checkpoint import manager as jmgr
from mxnet_tpu_torch.checkpoint import manager as tmgr
from mxnet_tpu_torch.convert import load_jax_params, load_jax_trainer_states
from mxnet_tpu_torch.tools import ckpt as tool

ROOT = Path(__file__).resolve().parent.parent
BATCH, FEATS = 8, 6
REL = 1e-6    # f32 leaves two steps after a cross-package restore
CASES = ("mlp", "bf16")


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_ckpt_tool",
                                                  ROOT / "tools" / "ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nets(pkg, case):
    g = pkg.gluon
    if case == "mlp":
        net = g.nn.Sequential()
        net.add(g.nn.Dense(16, activation="relu", in_units=FEATS))
        net.add(g.nn.Dense(1, in_units=16))
        return net, dict(learning_rate=1e-2)
    return (g.nn.Dense(8, in_units=FEATS, dtype="bfloat16"),
            dict(learning_rate=1e-2, multi_precision=True))


def _pair(case):
    """The case's net and Adam trainer in each package, same weights."""
    jmx.random.seed(7)
    jnet, opt = _nets(jmx, case)
    jnet.initialize()
    tnet, _ = _nets(mt, case)
    tnet.initialize(device=mt.cpu())
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    return (jnet, jmx.gluon.Trainer(jnet.collect_params(), "adam", opt),
            tnet, mt.gluon.Trainer(tnet.collect_params(), "adam", opt))


def _batch(case, s):
    rs = onp.random.RandomState(1000 + s)
    x = rs.standard_normal((BATCH, FEATS)).astype("float32")
    y = rs.standard_normal((BATCH, 8 if case == "bf16" else 1))
    return x, y.astype("float32")


def _grads(tr, s):
    """Step ``s``'s gradients for the parameters of ``tr``, the same numbers
    in both packages."""
    rs = onp.random.RandomState(2000 + s)
    return [rs.standard_normal(p.shape).astype("float32") for p in tr._params]


def _jax_step(case, net, tr, s, given=False):
    if given:
        for p, g in zip(tr._params, _grads(tr, s)):
            jg = p.grad()
            jg._data = jax.numpy.asarray(g).astype(jg._data.dtype)
            jg._version += 1
        tr.step(BATCH)
        return
    x, y = (jmx.np.array(a) for a in _batch(case, s))
    if case == "bf16":
        x = x.astype("bfloat16")
    with jmx.autograd.record():
        loss = jmx.gluon.loss.L2Loss()(net(x).astype("float32"), y)
    loss.backward()
    tr.step(BATCH)


def _port_step(case, net, tr, s, given=False):
    if given:
        for p, g in zip(tr._params, _grads(tr, s)):
            p._grad = torch.from_numpy(g).to(p.dtype)
            p._grad_version += 1
        tr.step(BATCH)
        return
    with mt.cpu():
        x, y = (mt.np.array(a) for a in _batch(case, s))
        if case == "bf16":
            x = x.astype("bfloat16")
        with mt.autograd.record():
            loss = mt.gluon.loss.L2Loss()(net(x).astype("float32"), y)
        loss.backward()
        tr.step(BATCH)


def _two_more(case, jnet, jtr, tnet, ttr):
    """Steps 4 and 5 in both packages. The bf16 net takes the same given
    gradients in both (as tests/test_torch_trainer_states.py does): the two
    frameworks' bf16 forwards and backwards round differently, which Adam
    magnifies past REL in two steps (measured: 2 bf16 ulps of a weight);
    the f32 MLP takes its own forward and backward."""
    for s in range(4, 6):
        _jax_step(case, jnet, jtr, s, given=case == "bf16")
        _port_step(case, tnet, ttr, s, given=case == "bf16")


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for y in s for x in _leaves(y)]
    return [s]


def _np(x):
    """A leaf of either package as numpy, bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(onp.uint16), "bfloat16"
        return x.numpy(), str(x.dtype).removeprefix("torch.")
    a = onp.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)
    if a.dtype.name == "bfloat16":
        return a.view(onp.uint16), "bfloat16"
    return a, a.dtype.name


def _state_of(tr):
    """Every value a restore must bring back, per trainer: weights, state
    leaves, bookkeeping, scale and stale gradients."""
    w = [_np(p._tensor() if isinstance(p, mt.gluon.Parameter)
             else p.data()) for p in tr._params]
    s = [[_np(x) for x in _leaves(st)] for st in tr._states]
    return dict(weights=w, states=s,
                opt=tr._optimizer.bookkeeping_state(), scale=tr._scale,
                stale=tr._stale_indices(), created=list(tr._states_created))


def _assert_bitwise(got, want):
    assert got["opt"] == want["opt"]
    assert got["scale"] == want["scale"]
    assert got["stale"] == want["stale"]
    assert got["created"] == want["created"]
    for (a, da), (b, db) in zip(got["weights"], want["weights"]):
        assert da == db and a.tobytes() == b.tobytes()
    assert [len(x) for x in got["states"]] == [len(x) for x in want["states"]]
    for sa, sb in zip(got["states"], want["states"]):
        for (a, da), (b, db) in zip(sa, sb):
            assert da == db and a.tobytes() == b.tobytes()


def _f32(a, dtype):
    if dtype == "bfloat16":
        return (a.astype(onp.uint32) << 16).view(onp.float32)
    return a.astype(onp.float32)


def _assert_close(got, want):
    """f32 leaves within REL relative; bf16 leaves within one bf16 ulp."""
    pairs = list(zip(got["weights"], want["weights"]))
    for sa, sb in zip(got["states"], want["states"]):
        pairs += list(zip(sa, sb))
    for (a, da), (b, db) in pairs:
        assert da == db
        a32, b32 = _f32(a, da), _f32(b, db)
        if da == "bfloat16":
            ulp = onp.maximum(onp.abs(b32), 2.0 ** -126) * 2.0 ** -7
            assert (onp.abs(a32 - b32) <= ulp).all()
        else:
            onp.testing.assert_allclose(a32, b32, rtol=REL, atol=REL)
    assert got["opt"] == want["opt"]


def _trained(case, steps=3):
    jnet, jtr, tnet, ttr = _pair(case)
    for s in range(1, steps + 1):
        _jax_step(case, jnet, jtr, s)
        _port_step(case, tnet, ttr, s)
    return jnet, jtr, tnet, ttr


def _carry(jnet, jtr, tnet, ttr):
    """The JAX trainer's state into the port's, exactly."""
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    names = jtr._param_names
    load_jax_trainer_states(ttr, dict(
        states={n: jax.tree_util.tree_map(
            lambda x: x.asnumpy(), s, is_leaf=lambda x: hasattr(x, "_data"))
            for n, s in zip(names, jtr._states)},
        index_update_count={names[i]: t for i, t in
                            jtr._optimizer._index_update_count.items()},
        num_update=jtr._optimizer.num_update))


def _manifest(d, step):
    with open(os.path.join(d, f"step-{step:08d}", "MANIFEST.json"),
              encoding="utf-8") as f:
        return json.load(f)


def _is_rng(name):
    return name == "rng/key" or name.startswith("torch_rng/")


def _bert_trainer_names(pkg):
    """(name, shape) of each parameter of a tiny BERTForQA's Trainer, in
    the trainer's order: what a checkpoint's ``param_names`` follow."""
    bert = pkg.gluon.model_zoo.bert
    net = bert.BERTForQA(bert.bert_12_768_12(
        num_layers=2, units=64, hidden_size=128, num_heads=4, vocab_size=100,
        max_length=64))
    net.initialize(**({"device": mt.cpu()} if pkg is mt else {}))
    tr = pkg.gluon.Trainer(net.collect_params(), "adamw",
                           {"multi_precision": True})
    return [(p.name, tuple(p.shape)) for p in tr._params]


@pytest.mark.parametrize("case", CASES)
def test_same_state_same_checkpoint(tmp_path, case):
    if case == "mlp":   # BERT's trainer orders and names alike too
        assert _bert_trainer_names(jmx) == _bert_trainer_names(mt)
    jnet, jtr, tnet, ttr = _trained(case)
    _carry(jnet, jtr, tnet, ttr)
    _assert_bitwise(_state_of(ttr), _state_of(jtr))
    user = {"epoch": 2, "cursor": [1, 2]}
    jmgr.CheckpointManager(tmp_path / "j", jtr).save(3, user, sync=True)
    tmgr.CheckpointManager(tmp_path / "t", ttr).save(3, user, sync=True)
    assert sorted(os.listdir(tmp_path / "j")) == \
        sorted(os.listdir(tmp_path / "t")) == ["step-00000003"]
    mj, mp = _manifest(tmp_path / "j", 3), _manifest(tmp_path / "t", 3)
    assert sorted(mj) == sorted(mp)
    aj = {k: v for k, v in mj["arrays"].items() if not _is_rng(k)}
    ap = {k: v for k, v in mp["arrays"].items() if not _is_rng(k)}
    assert aj == ap   # names, files, shapes, dtypes, crc32s, nbytes
    if case == "bf16":
        assert aj["param/1"]["dtype"] == "bfloat16"   # the weight
    assert "rng/key" in mj["arrays"] and "torch_rng/seed" in mp["arrays"]
    meta_j = {k: v for k, v in mj["meta"].items() if k != "rng_key_dtype"}
    assert meta_j == mp["meta"]
    for key in ("format_version", "world_size", "mode", "reason", "step",
                "user_meta", "library_version"):
        assert mj[key] == mp[key], key


@pytest.mark.parametrize("case", CASES)
def test_jax_writes_port_restores(tmp_path, case):
    jnet, jtr, tnet, ttr = _trained(case)
    mgr = jmgr.CheckpointManager(tmp_path, jtr)
    mgr.save(3)
    mgr.flush()
    want = _state_of(jtr)
    for s in range(4, 6):   # the port's state moves away from step 3
        _port_step(case, tnet, ttr, s)
    res = tmgr.CheckpointManager(tmp_path, ttr).restore()
    assert res.step == 3
    _assert_bitwise(_state_of(ttr), want)
    _two_more(case, jnet, jtr, tnet, ttr)
    _assert_close(_state_of(ttr), _state_of(jtr))


@pytest.mark.parametrize("case", CASES)
def test_port_writes_jax_restores(tmp_path, case):
    jnet, jtr, tnet, ttr = _trained(case)
    mgr = tmgr.CheckpointManager(tmp_path, ttr)
    mgr.save(3)
    mgr.flush()
    want = _state_of(ttr)
    for s in range(4, 6):
        _jax_step(case, jnet, jtr, s)
    assert jmgr.CheckpointManager(tmp_path, jtr).restore().step == 3
    _assert_bitwise(_state_of(jtr), want)
    _two_more(case, jnet, jtr, tnet, ttr)
    _assert_close(_state_of(ttr), _state_of(jtr))


def _flip_payload(d, step):
    npz = os.path.join(d, f"step-{step:08d}", "arrays.npz")
    with open(npz, "r+b") as f:
        # a 256-byte stretch, so the damage cannot hide in zip padding
        f.seek(os.path.getsize(npz) // 2)
        chunk = bytearray(f.read(256))
        f.seek(-len(chunk), os.SEEK_CUR)
        f.write(bytes(b ^ 0xFF for b in chunk))


def test_verification_agrees_both_ways(tmp_path, capsys):
    jnet, jtr, tnet, ttr = _trained("bf16", steps=1)
    dirs = {"jax": tmp_path / "j", "port": tmp_path / "t"}
    jmgr.CheckpointManager(dirs["jax"], jtr).save(1, sync=True)
    tmgr.CheckpointManager(dirs["port"], ttr).save(1, sync=True)
    jtool = _jax_tool()

    def verdicts(d, step=None):
        extra = [] if step is None else ["--step", str(step)]
        rj, rp = (jmgr.verify_checkpoint(d, step),
                  tmgr.verify_checkpoint(d, step))
        codes = (jtool.main(["verify", str(d), *extra]),
                 tool.main(["verify", str(d), *extra]))
        capsys.readouterr()
        assert (rj["ok"], rj["found"]) == (rp["ok"], rp["found"])
        assert codes[0] == codes[1]
        return codes[0]

    for d in dirs.values():
        for cmd in ("list", "inspect"):   # the same JSON from both tools
            codes = (jtool.main([cmd, str(d), "--json"]),
                     tool.main([cmd, str(d), "--json"]))
            out = capsys.readouterr().out
            half = len(out) // 2
            assert codes == (0, 0) and out[:half] == out[half:], cmd
        assert verdicts(d) == 0
        assert verdicts(d, step=9) == 2
        _flip_payload(d, 1)
        assert verdicts(d) == 1
    assert verdicts(tmp_path / "nowhere") == 2
    for mgr in (jmgr.CheckpointManager(dirs["port"], jtr),
                tmgr.CheckpointManager(dirs["jax"], ttr)):
        with pytest.raises(Exception) as e:
            mgr.restore(step=1)
        assert type(e.value).__name__ == "CheckpointCorrupt"


def test_retention_keeps_the_same_steps(tmp_path):
    _, jtr, _, ttr = _pair("mlp")
    kept = []
    for pkg, tr in ((jmgr, jtr), (tmgr, ttr)):
        mgr = pkg.CheckpointManager(tmp_path / pkg.__name__, tr, keep_last=2,
                                    keep_every_n_steps=4)
        for s in range(1, 10):
            mgr.save(s, sync=True)
        kept.append(mgr.steps())
    assert kept[0] == kept[1] == [4, 8, 9]


def _ckpt_series(dump):
    """``{name: {labels: count or value}}`` of the ``ckpt_*`` series."""
    out = {}
    for name, m in dump.items():
        if not name.startswith("ckpt_"):
            continue
        out[name] = {json.dumps(s["labels"], sort_keys=True):
                     s["count"] if "count" in s else s["value"] > 0
                     for s in m["samples"]}
    return out


def test_telemetry_series_match(tmp_path):
    jmx.telemetry.reset()
    mt.telemetry.reset()
    _, jtr, _, ttr = _pair("mlp")
    for pkg, tr in ((jmgr, jtr), (tmgr, ttr)):
        mgr = pkg.CheckpointManager(tmp_path / pkg.__name__, tr)
        mgr.save(1, sync=True)

        def explode(path):  # noqa: ARG001
            raise OSError("disk on fire")

        pkg._WRITE_BEGIN_HOOK = explode
        try:
            mgr.save(2)
            with pytest.raises(OSError, match="disk on fire"):
                mgr.flush()
        finally:
            pkg._WRITE_BEGIN_HOOK = None
        assert mgr.restore().step == 1
    jser = _ckpt_series(jmx.telemetry.dump())
    tser = _ckpt_series(mt.telemetry.dump())
    assert jser == tser
    assert set(tser["ckpt_save_total"]) == {
        json.dumps({"mode": "replicated", "outcome": o}, sort_keys=True)
        for o in ("ok", "error")}
    assert tser["ckpt_restore_total"] == {'{"outcome": "ok"}': True}
