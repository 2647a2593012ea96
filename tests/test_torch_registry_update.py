"""The legacy optimizer update ops (ops/optimizer_ops.py) against the JAX
package's, on the CPU: three steps of each from the same numpy weight,
gradient and states, the port through ``mx.nd`` on NDArrays with
``out=`` (the states of the stateful spellings written in place, the
weight into ``out``'s own storage), the JAX package through its pure op
(jitted once, its returned states fed back).

Tolerance: f32 within 1e-5 relative (plus 1e-6 absolute); the JAX package
computes its Python scalars in float64, the port in f32.
"""
import numpy as onp

import jax
import jax.numpy as jnp
import mxnet_tpu as mj
from mxnet_tpu.ops.registry import _OPS as JOPS
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import _sweep_cases as sc
from test_torch_registry_coverage import mismatch

#: op -> (number of states, kwargs); the states follow weight and grad
_UPDATES = {
    "sgd_update": (0, dict(lr=0.1, wd=0.01, clip_gradient=0.5)),
    "sgd_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=1e-4)),
    "nag_mom_update": (1, dict(lr=0.1, momentum=0.9, wd=0.01)),
    "signsgd_update": (0, dict(lr=0.05, wd=0.01)),
    "signum_update": (1, dict(lr=0.05, momentum=0.9, wd_lh=0.01)),
    "adam_update": (2, dict(lr=0.01, wd=0.01, rescale_grad=0.5)),
    "adamw_update": (2, dict(lr=0.01, wd=0.01, eta=0.9)),
    "_adamw_update": (2, dict(lr=0.01)),
    "lamb_update_phase1": (2, dict(t=3, wd=0.01)),
    "rmsprop_update": (1, dict(lr=0.01, clip_weights=0.9)),
    "rmspropalex_update": (3, dict(lr=0.01)),
    "ftrl_update": (2, dict(lr=0.1, lamda1=0.01, wd=0.01)),
    "adagrad_update": (1, dict(lr=0.1, wd=0.01)),
    "_sparse_adagrad_update": (1, dict(lr=0.1)),
    "adadelta_update": (2, dict(rho=0.9, wd=0.01)),
    "adabelief_update": (2, dict(lr=0.01, wd=0.01)),
    "_adabelief_update": (2, dict(lr=0.01)),
    "ftml_update": (3, dict(lr=0.1, t=2)),
    "group_adagrad_update": (1, dict(lr=0.1)),
    "_contrib_group_adagrad_update": (1, dict(lr=0.1, epsilon=1e-3)),
    "lans_update_phase1": (2, dict(t=2, wd=0.01)),
    "_multi_lans_update": (2, dict(t=2)),
    "_multi_mp_lans_update": (2, dict(t=1)),
    "lamb_update_phase2": (0, dict(lr=0.1)),
    "mp_lamb_update_phase2": (0, dict(lr=0.1, upper_bound=0.5)),
}
#: the update ops mx.nd writes its states back for (ndarray/__init__.py)
_STATEFUL = {"sgd_mom_update", "nag_mom_update", "signum_update",
             "adam_update", "adamw_update", "lamb_update_phase1",
             "rmsprop_update", "rmspropalex_update", "ftrl_update",
             "adagrad_update", "adadelta_update"}


def _operands(name, n_state, rs):
    w = rs.uniform(-1, 1, (3, 4)).astype("f")
    grads = [rs.uniform(-1, 1, (3, 4)).astype("f") for _ in range(3)]
    rows = name.startswith(("group", "_contrib_group"))
    states = [rs.uniform(0.01, 0.1, (3,) if rows else (3, 4)).astype("f")
              for _ in range(n_state)]
    if name.startswith(("lamb_update_phase2", "mp_lamb")):
        states = [onp.array([0.7], "f"), onp.array([1.3], "f")]
    return w, grads, states


def _jax_steps(operands):
    """The JAX package's three steps of every op, from ``operands``
    (name -> weight, grads, states): one ``jax.jit`` of a step of all
    ops, run three times, each op's returned states fed back (the trust
    ratio inputs of phase 2 stay as they are)."""
    names = list(_UPDATES)

    def step(ws, gs, states):
        out_w, out_s = [], []
        for name, w, g, st in zip(names, ws, gs, states):
            res = JOPS[name](w, g, *st, **_UPDATES[name][1])
            res = list(res) if isinstance(res, tuple) else [res]
            n_state = _UPDATES[name][0]
            out_w.append(res[0])
            out_s.append(res[-n_state:] if n_state else st)
        return out_w, out_s

    jstep = jax.jit(step)
    ws = [jnp.asarray(operands[n][0]) for n in names]
    states = [[jnp.asarray(s) for s in operands[n][2]] for n in names]
    history = []
    for k in range(3):
        ws, states = jstep(ws, [jnp.asarray(operands[n][1][k])
                                for n in names], states)
        history.append({n: (w, s) for n, w, s in zip(names, ws, states)})
    return history


def test_update_ops_three_steps():
    """Three steps of every update op; the weight NDArray passed as
    ``out`` and (for the stateful spellings) the states keep their
    tensors, which hold the JAX package's values after each step."""
    bad = []
    rs = onp.random.RandomState(0)
    operands = {name: _operands(name, n_state, rs)
                for name, (n_state, _) in _UPDATES.items()}
    want = _jax_steps(operands)
    for name, (n_state, kw) in _UPDATES.items():
        w, grads, states = operands[name]
        phase2 = name.endswith("lamb_update_phase2")
        with mt.cpu():
            tw = mt.np.array(w)
            tstates = [mt.np.array(s) for s in states]
            tensors = [tw._data] + [s._data for s in tstates]
            fn = getattr(mt.nd, name)
            for step, g in enumerate(grads):
                tg = mt.np.array(g)
                if name in _STATEFUL or n_state == 0 or phase2:
                    res = fn(tw, tg, *tstates, out=tw, **kw)
                    assert res is tw
                else:                # mx.nd returns the new states
                    res = fn(tw, tg, *tstates, **kw)
                    for dst, new in zip([tw] + tstates,
                                        [res[0]] + list(res[-n_state:])):
                        dst._data.copy_(new._data)
                jw, jstates = want[step][name]
                err = mismatch(f"{name} step {step}",
                               [jw] + list(jstates if not phase2 else []),
                               [tw] + list(tstates if not phase2 else []))
                if err:
                    bad.append(err)
                    break
            if [tw._data] + [s._data for s in tstates] != tensors:
                bad.append(f"{name}: a tensor was replaced")
    assert not bad, bad


def test_out_writes_into_a_parameter():
    """``sgd_mom_update(w, g, mom, ..., out=w)`` on a Parameter's data
    updates the Parameter's own tensor, the one a captured graph holds."""
    p = mt.gluon.Parameter("w", shape=(3, 4))
    p.initialize(device=mt.cpu())
    before = p.data()._data
    held = before.detach().clone()
    with mt.cpu():
        mom = mt.np.zeros((3, 4))
        g = mt.np.ones((3, 4))
        w = p.data()
        mt.nd.sgd_mom_update(w, g, mom, lr=0.1, momentum=0.9, wd=0.0,
                             out=w)
    assert p.data()._data is before
    assert onp.allclose(before.detach().numpy(), held.numpy() - 0.1)
    assert onp.allclose(mom.asnumpy(), -0.1)


#: (label, what runs inside record(): f(mx, x, w, y) with ``out=y``); y
#: is a fresh array, or one computed earlier inside the same record()
_RECORDED_OUT = (
    ("relu into a fresh array",
     lambda mx, x, w, y: mx.nd.relu(x, out=y)),
    ("sigmoid over an earlier result",
     lambda mx, x, w, y: mx.nd.sigmoid(x * w, out=x * 2.0)),
    ("FullyConnected, two inputs",
     lambda mx, x, w, y: mx.nd.FullyConnected(x, w, no_bias=True,
                                              num_hidden=3, out=y)),
    ("elemwise_mul into the earlier product",
     lambda mx, x, w, y: mx.nd.elemwise_mul(x, x, out=mx.nd.relu(x))),
)


def test_out_under_record_carries_the_gradient():
    """An op called with ``out=`` inside ``autograd.record()``:
    ``backward`` through the ``out`` array reaches the op's inputs with the
    JAX package's gradients (its ``_assign_from`` carries the tape entry
    over), also where ``out`` held an earlier recorded result, whose
    computation then takes no part. Outside ``record()`` a dtype that
    differs from ``out``'s raises."""
    rs = onp.random.RandomState(3)
    x = rs.uniform(-1, 1, (3, 3)).astype("f")
    w = rs.uniform(-1, 1, (3, 3)).astype("f")
    bad = []
    for label, f in _RECORDED_OUT:
        got = []
        for mx, scope in ((mj, mj.cpu), (mt, mt.cpu)):
            with scope():
                ax, aw = mx.nd.array(x), mx.nd.array(w)
                y = mx.nd.zeros((3, 3))
                ax.attach_grad()
                aw.attach_grad()
                with mx.autograd.record():
                    res = f(mx, ax, aw, y)
                res.backward()
                got.append([res, ax.grad, aw.grad])
        err = mismatch(label, *got)
        if err:
            bad.append(err)
    with mt.cpu():
        try:
            mt.nd.relu(mt.nd.array(x), out=mt.nd.zeros((3, 3),
                                                       dtype="float16"))
            bad.append("a float16 out= took a float32 result")
        except ValueError:
            pass
    assert not bad, bad


def test_overflow_checks_and_sums():
    data = sc.inputs(0)
    w, g = data["w"], data["g"].copy()
    with mt.cpu():
        tw, tg = mt.np.array(w), mt.np.array(g)
        assert float(mt.nd.all_finite(tw).asnumpy()[0]) == 1.0
        sums = mt.nd.multi_sum_sq(tw, tg)
        assert mismatch("multi_sum_sq", [onp.sum(w * w), onp.sum(g * g)],
                        sums, dtype=False) is None
        g[1, 2] = onp.inf
        assert float(mt.nd.multi_all_finite(
            tw, mt.np.array(g)).asnumpy()[0]) == 0.0
