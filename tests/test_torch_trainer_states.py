"""``Trainer.save_states`` / ``load_states`` and ``optimizer.Updater``
between the JAX package and the PyTorch port, on the CPU.

Three parameters of each package from the same numpy values (a (33, 5), a
(17,) with lr and wd multipliers, a (4, 4, 3)), and the same gradients.
One package takes a step and saves its trainer's states; the other loads
them, both take the next step, and the results agree within the
tolerances of tests/test_torch_optimizer.py: the JAX side's update is one
jitted program per bucket, so f32 leaves within rtol 2e-5 (XLA
reassociates products of scalars; Adam's ``1 - beta2 ** t`` cancels) and
bf16 leaves within one bf16 ulp. SGD with momentum, Adam and AdamW, each
in f32, in bf16 and in bf16 with f32 masters (``multi_precision``). Right
after a load the leaves are equal bit for bit in every mode.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.optimizer import optimizer as jopt
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _dtype_codec as codec
from mxnet_tpu_torch.convert import to_tensor
from mxnet_tpu_torch.optimizer import optimizer as topt

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(33, 5), (17,), (4, 4, 3)]
RULES = {"sgd": dict(learning_rate=0.05, momentum=0.9, wd=1e-4),
         "adam": dict(learning_rate=0.01, wd=1e-4),
         "adamw": dict(learning_rate=0.01, wd=0.01)}
MODES = {"f32": ("float32", False), "bf16": ("bfloat16", False),
         "bf16_mp": ("bfloat16", True)}
TOL = dict(rtol=2e-5, atol=2e-6)


def _flat(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for y in s for x in _flat(y)]
    return [s]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return onp.asarray(jnp.asarray(getattr(x, "_data", x), jnp.float32))


def _close(got, want, what):
    """bf16 within one ulp of each element, f32 within TOL."""
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for a, w in zip(got, want):
        a32, w32 = _f32(a), _f32(w)
        w_dt = str(getattr(w, "_data", w).dtype)
        assert str(a.dtype).removeprefix("torch.") == w_dt, what
        if w_dt == "bfloat16":
            ulp = onp.maximum(onp.abs(w32), 2.0 ** -126) * 2.0 ** -7
            assert (onp.abs(a32 - w32) <= ulp).all(), what
        else:
            onp.testing.assert_allclose(a32, w32, err_msg=what, **TOL)


def _jstates(jtr):
    return [jax.tree_util.tree_map(lambda x: x._data, s,
                                   is_leaf=lambda x: hasattr(x, "_data"))
            for s in jtr._states]


def _pair(rule, mode, sched=False):
    """Parameters p0..p2 and a Trainer in each package, same values."""
    dt, mp = MODES[mode]
    r = onp.random.RandomState(7)
    jps, tps = {}, {}
    for i, shape in enumerate(SHAPES):
        val = r.standard_normal(shape).astype("f")
        jp = jmx.gluon.Parameter(f"p{i}", shape=shape, dtype=dt)
        jp.initialize()
        jp.set_data(jmx.np.array(val).astype(dt))
        tp = mt.gluon.Parameter(f"p{i}", shape=shape, dtype=dt)
        tp.initialize(device=mt.cpu())
        tp.set_data(to_tensor(jp.data().asnumpy()))
        if i == 1:
            jp.lr_mult = tp.lr_mult = 0.5
            jp.wd_mult = tp.wd_mult = 0.0
        jps[f"p{i}"], tps[f"p{i}"] = jp, tp
    jkw = dict(RULES[rule], multi_precision=mp)
    tkw = dict(jkw)
    if sched:
        jkw["lr_scheduler"] = jmx.lr_scheduler.PolyScheduler(
            max_update=10, base_lr=0.05, pwr=1, warmup_steps=2)
        tkw["lr_scheduler"] = mt.lr_scheduler.PolyScheduler(
            max_update=10, base_lr=0.05, pwr=1, warmup_steps=2)
    return (jps, tps, jmx.gluon.Trainer(jps, rule, jkw),
            mt.gluon.Trainer(tps, rule, tkw))


def _grads(jps, tps, seed, names=None):
    """The same gradient into each package's parameters (fresh)."""
    r = onp.random.RandomState(seed)
    for name in names or sorted(jps):
        jp, tp = jps[name], tps[name]
        g = r.standard_normal(jp.shape).astype("f")
        jg = jp.grad()
        jg._data = jnp.asarray(g).astype(jg._data.dtype)
        jg._version += 1
        tp._grad = to_tensor(onp.asarray(jg._data))
        tp._grad_version += 1


def _carry_weights(src, dst):
    """Weights of one package's parameters into the other's, copied (XLA
    may alias an aligned numpy buffer, which the port then updates in
    place)."""
    for name, p in src.items():
        q = dst[name]
        if isinstance(p, mt.gluon.Parameter):
            value = p._tensor().detach().float().numpy().copy()
            q.set_data(jmx.np.array(value).astype(str(q.dtype)))
        else:
            q.set_data(to_tensor(p.data().asnumpy()))


def _compare(jps, tps, jtr, ttr, what, weights=True):
    for name in sorted(jps) if weights else ():
        _close(tps[name]._tensor(), jps[name].data()._data,
               f"{what} {name} weight")
    for i, s in enumerate(_jstates(jtr)):
        _close(ttr._states[i], s, f"{what} p{i} state")


def _assert_bitwise(tps, ttr, jtr, what):
    """The port's states equal the JAX package's bit for bit."""
    for i, s in enumerate(_jstates(jtr)):
        got, want = _flat(ttr._states[i]), _flat(s)
        assert len(got) == len(want), what
        for a, w in zip(got, want):
            w = onp.asarray(w)
            assert codec.to_numpy(a)[0].tobytes() == w.tobytes(), what


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_next_step_after_a_load_matches(tmp_path, direction):
    """Each rule and dtype mode: step 1 in one package, save, load in the
    other (weights carried across), step 2 in both."""
    for rule in RULES:
        for mode in MODES:
            jps, tps, jtr, ttr = _pair(rule, mode)
            what = f"{direction} {rule} {mode}"
            path = str(tmp_path / f"{rule}_{mode}.states")
            _grads(jps, tps, 1)
            if direction == "jax_to_port":
                jtr.step(4)
                jtr.save_states(path)
                _carry_weights(jps, tps)
                ttr.load_states(path)
            else:
                ttr.step(4)
                ttr.save_states(path)
                _carry_weights(tps, jps)
                jtr.load_states(path)
            _assert_bitwise(tps, ttr, jtr, what + " after the load")
            _grads(jps, tps, 2)
            jtr.step(4)
            ttr.step(4)
            _compare(jps, tps, jtr, ttr, what + " step 2")
            assert ttr.optimizer.num_update == jtr.optimizer.num_update == 2


def test_update_counts_and_schedule_cross(tmp_path):
    """``num_update`` and each parameter's ``t`` (one parameter skipped a
    step as stale) cross both ways, so the schedule's LR and Adam's bias
    correction continue."""
    for direction in ("jax_to_port", "port_to_jax"):
        jps, tps, jtr, ttr = _pair("adam", "f32", sched=True)
        src_tr = jtr if direction == "jax_to_port" else ttr
        dst_tr = ttr if src_tr is jtr else jtr
        _grads(jps, tps, 1)
        src_tr.step(4)
        _grads(jps, tps, 2, names=["p0", "p2"])
        src_tr.step(4, ignore_stale_grad=True)
        path = str(tmp_path / f"{direction}.states")
        src_tr.save_states(path)
        _carry_weights(jps if src_tr is jtr else tps,
                       tps if src_tr is jtr else jps)
        dst_tr.load_states(path)
        for tr in (jtr, ttr):
            assert tr.optimizer.num_update == 2, direction
            assert tr.optimizer._index_update_count == {0: 2, 1: 1, 2: 2}
        assert jtr.learning_rate == ttr.learning_rate
        _grads(jps, tps, 3)
        jtr.step(4)
        ttr.step(4)
        _compare(jps, tps, jtr, ttr, f"{direction} step 3")
        assert jtr.learning_rate == ttr.learning_rate


def test_stale_gradients_and_loss_scale_cross(tmp_path):
    """The stale indices and the loss scale carry both ways; stale marks
    are taken again against the loading process's gradient versions."""
    for direction in ("jax_to_port", "port_to_jax"):
        jps, tps, jtr, ttr = _pair("sgd", "f32")
        src_tr = jtr if direction == "jax_to_port" else ttr
        dst_tr = ttr if src_tr is jtr else jtr
        _grads(jps, tps, 1)
        src_tr.step(4)
        _grads(jps, tps, 2, names=["p1"])         # p0, p2 stay stale
        src_tr._scale = 0.125
        path = str(tmp_path / f"{direction}.states")
        src_tr.save_states(path)
        dst_tr.load_states(path)
        assert dst_tr._scale == 0.125
        assert src_tr._stale_indices() == dst_tr._stale_indices() == [0, 2]


def _jax_payload(tmp_path, rule="adam", mode="bf16"):
    jps, tps, jtr, ttr = _pair(rule, mode)
    _grads(jps, tps, 1)
    jtr.step(4)
    path = str(tmp_path / "jax.states")
    jtr.save_states(path)
    return jps, tps, jtr, ttr, path


def test_format_1_payload_loads(tmp_path):
    """A payload without the bookkeeping (format 1: states, created and
    num_update) loads its states and its ``num_update``."""
    jps, tps, jtr, ttr, path = _jax_payload(tmp_path, "adam", "f32")
    with open(path, "rb") as f:
        payload = pickle.load(f)
    old = {k: payload[k] for k in ("states", "created", "num_update")}
    old_path = str(tmp_path / "format1.states")
    with open(old_path, "wb") as f:
        pickle.dump(old, f)
    ttr.load_states(old_path)
    assert ttr.optimizer.num_update == 1
    for i, s in enumerate(_jstates(jtr)):
        _close(ttr._states[i], s, f"format 1 p{i}")


def test_payload_of_another_model_raises_and_touches_nothing(tmp_path):
    """Another parameter count or another dtype: ValueError; a pickle that
    names a callable beyond numpy's arrays: UnpicklingError, nothing
    called. The trainer's states, counts and scale stay as they were."""
    _, _, _, _, path = _jax_payload(tmp_path, "adam", "bf16")
    hostile = str(tmp_path / "hostile.states")
    with open(hostile, "wb") as f:
        pickle.dump({"states": [os.getcwd]}, f)
    tps = {f"p{i}": mt.gluon.Parameter(f"p{i}", shape=s, dtype="float32")
           for i, s in enumerate(SHAPES)}
    for p in tps.values():
        p.initialize(device=mt.cpu())
    for params in ({k: tps[k] for k in ("p0", "p1")}, tps):
        tr = mt.gluon.Trainer(params, "adam", {"learning_rate": 0.01})
        for p in params.values():
            p._grad = torch.ones_like(p._tensor())
        tr.step(1)
        before = [(id(s), [x.clone() for x in _flat(s)]) for s in tr._states]
        with pytest.raises(ValueError, match="payload"):
            tr.load_states(path)
        with pytest.raises(pickle.UnpicklingError, match="getcwd"):
            tr.load_states(hostile)
        assert tr.optimizer.num_update == 1 and tr._scale == 1.0
        for s, (sid, leaves) in zip(tr._states, before):
            assert id(s) == sid
            assert all(torch.equal(a, b) for a, b in zip(_flat(s), leaves))


def test_load_into_existing_states_keeps_the_objects(tmp_path):
    """Where the states exist with the same nesting, shapes and dtypes the
    load copies into them (what a captured TrainStep needs); where none
    exists it creates them."""
    jps, tps, jtr, ttr, path = _jax_payload(tmp_path, "adamw", "bf16_mp")
    ttr.load_states(path)                    # no states yet: created
    assert all(ttr._states_created)
    _compare(jps, tps, jtr, ttr, "created", weights=False)
    held = [(id(s), [(id(x), x.data_ptr()) for x in _flat(s)])
            for s in ttr._states]
    _grads(jps, tps, 5)
    ttr.step(4)                              # move the port's states
    ttr.load_states(path)                    # in place
    assert held == [(id(s), [(id(x), x.data_ptr()) for x in _flat(s)])
                    for s in ttr._states]
    _compare(jps, tps, jtr, ttr, "in place", weights=False)
    assert ttr.optimizer.num_update == 1


def test_bf16_payload_reads_without_ml_dtypes(tmp_path):
    """A JAX-written payload with bf16 leaves (Adam on bf16 weights) read
    by the port in a process where ``ml_dtypes`` (and JAX) cannot be
    imported; every leaf's bits equal the JAX package's."""
    _, _, jtr, _, path = _jax_payload(tmp_path, "adam", "bf16")
    out = str(tmp_path / "bits.npz")
    code = (
        "import sys\n"
        "for m in ('ml_dtypes', 'jax', 'jaxlib', 'mxnet_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "import mxnet_tpu_torch as mt\n"
        f"shapes = {SHAPES!r}\n"
        "ps = {f'p{i}': mt.gluon.Parameter(f'p{i}', shape=s, "
        "dtype='bfloat16') for i, s in enumerate(shapes)}\n"
        "for p in ps.values():\n"
        "    p.initialize(device=mt.cpu())\n"
        "tr = mt.gluon.Trainer(ps, 'adam', {'learning_rate': 0.01})\n"
        f"tr.load_states({path!r})\n"
        "leaves = [x for s in tr._states for x in s]\n"
        "assert all(x.dtype == torch.bfloat16 for x in leaves)\n"
        f"np.savez({out!r}, *[x.view(torch.int16).numpy() for x in "
        "leaves])\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    got = onp.load(out)
    want = [onp.asarray(x).view(onp.int16) for s in _jstates(jtr)
            for x in s]
    assert len(got.files) == len(want) == 6
    for k, w in zip(got.files, want):
        assert onp.array_equal(got[k], w), k


def test_updater_matches_the_reference():
    """``get_updater``'s Updater against the JAX package's: two updates of
    the same keys, its states through ``get_states``/``set_states`` (with
    the optimizer) into a fresh updater, a third update; a checkpoint's
    flat leaves grafted at a key's first update; a leaf count that differs
    raises ValueError."""
    r = onp.random.RandomState(3)
    kw = dict(learning_rate=0.01, wd=1e-4)
    w0 = [r.standard_normal(s).astype("f") for s in SHAPES[:2]]
    jw = [jmx.np.array(w) for w in w0]
    tw = [torch.from_numpy(w.copy()) for w in w0]
    jup = jopt.get_updater(jopt.create("adam", **kw))
    tup = topt.get_updater(topt.create("adam", **kw))
    assert isinstance(tup, topt.Updater)

    def update(jup, tup, seed):
        rr = onp.random.RandomState(seed)
        gs = [rr.standard_normal(w.shape).astype("f") for w in w0]
        jup([0, 1], [jmx.np.array(g) for g in gs], jw)
        tup([0, 1], [torch.from_numpy(g) for g in gs], tw)
        for k in (0, 1):
            _close(tw[k], jw[k]._data, f"seed {seed} weight {k}")
            js = jax.tree_util.tree_map(lambda x: x._data, jup.states[k],
                                        is_leaf=lambda x: hasattr(x, "_data"))
            _close(tup.states[k], js, f"seed {seed} state {k}")

    update(jup, tup, 1)
    update(jup, tup, 2)
    jfresh = jopt.get_updater(jopt.create("sgd"))
    jfresh.set_states(jup.get_states(dump_optimizer=True))
    tfresh = topt.get_updater(topt.create("sgd"))
    tfresh.set_states(tup.get_states(dump_optimizer=True))
    assert type(tfresh.optimizer) is topt.Adam
    assert tfresh.optimizer.num_update == 2
    update(jfresh, tfresh, 3)
    plain = topt.get_updater(topt.create("adam", **kw))
    plain.set_states(tup.get_states())
    assert sorted(plain.states) == [0, 1]

    # grafting: flat (m, v) leaves of a checkpoint at the key's first update
    m, v = (r.standard_normal(SHAPES[0]).astype("f") * 0.1 for _ in "mv")
    v = onp.abs(v)
    jg = jopt.get_updater(jopt.create("adam", **kw))
    tg = topt.get_updater(topt.create("adam", **kw))
    jg.pending_loaded[0] = [m, v]
    tg.pending_loaded["0"] = [m, v]
    jw, tw = [jmx.np.array(w0[0])], [torch.from_numpy(w0[0].copy())]
    g = onp.ones(SHAPES[0], "f")
    jg([0], [jmx.np.array(g)], jw)
    tg([0], [torch.from_numpy(g)], tw)
    _close(tw[0], jw[0]._data, "grafted weight")
    with pytest.raises(ValueError, match="leaves"):
        topt._graft_state((torch.zeros(2), torch.zeros(2)), [m])
    with pytest.raises(ValueError, match="leaves"):
        jopt._graft_state((jmx.np.zeros(2), jmx.np.zeros(2)), [m])
