"""The row-sparse training path against the JAX package on the CPU (64-bit
types on): two ``Embedding(sparse_grad=True)`` tables and a dense layer
trained 3 steps through the Trainer by SGD with momentum, Adam, AdaGrad
and LAMB in float32, the first three also with bfloat16 tables and
float32 masters (the forward in float32, so the tables differ only in
their update), eager, and Adam hybridized, from the JAX package's weights
(``convert.load_jax_params``).

Each batch's last sample has a zero mask: its user and item rows are
looked up (touched) but their gradient is exactly zero, so the lazy update
leaves them, and their states, as they were. Other rows no batch touches.
The JAX package's lazy update (``_sparse_jitted``) is one ``jax.jit`` a
call; it pads the touched rows to power-of-two buckets with an
out-of-range row, the port stores exactly the touched rows: the tests
compare the weights and every state tensor after each step (all rows),
within rtol 2e-5 plus 2e-5 of each tensor's largest value (a bf16 weight
within one bf16 ulp of its master's rounding), and the untouched and zero-gradient rows bit for bit against
their initial values where the update is lazy. LAMB (layer-wise norms)
and a hybridized forward (a trace in the JAX package, so no rows are
recorded) take the dense update over every row in both packages."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.tools import matrix_factorization as mf

U, IT, K, B = 14, 10, 4, 8
UNTOUCHED_U, UNTOUCHED_I = [10, 11, 12], [7, 8]
ZERO_U, ZERO_I = 13, 9
OPTIMIZERS = {
    "sgd": dict(learning_rate=0.1, momentum=0.9, wd=0.01),
    "adam": dict(learning_rate=0.05, wd=0.01),
    "adagrad": dict(learning_rate=0.1, wd=0.01),
    "lamb": dict(learning_rate=0.05, wd=0.01),
}


def _batches():
    r = onp.random.RandomState(5)
    out = []
    for _ in range(3):
        u = r.randint(0, 10, B).astype("int32")
        i = r.randint(0, 7, B).astype("int32")
        u[-1], i[-1] = ZERO_U, ZERO_I
        m = onp.ones(B, "float32")
        m[-1] = 0.0
        out.append((u, i, m, r.uniform(-1, 1, B).astype("float32")))
    return out


def _net(pkg):
    """Two sparse-gradient tables and a float32 Dense layer; the forward
    computes in float32 (the port's forward sees tensors, the JAX
    package's NDArrays), so bf16 tables differ only in their update."""
    nn = pkg.gluon.nn
    f32 = (lambda x: x.float()) if pkg is mt else (
        lambda x: x.astype("float32"))

    class Net(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.user = nn.Embedding(U, K, sparse_grad=True)
            self.item = nn.Embedding(IT, K, sparse_grad=True)
            self.proj = nn.Dense(1, in_units=K)

        def forward(self, u, i, m):
            eu = f32(self.user(u))
            return ((eu * f32(self.item(i))).sum(axis=-1)
                    + self.proj(eu).reshape(-1)) * m

    return Net()


def _host(x):
    if isinstance(x, (list, tuple)):
        return [h for v in x for h in _host(v)]
    if x is None:
        return []
    if hasattr(x, "asnumpy"):
        return [onp.asarray(x.asnumpy()).astype("float32")]
    return [x.detach().float().numpy()]


def _pair(optimizer, dtype, hybridize):
    """Both packages' nets and trainers from the JAX package's weights."""
    jnet = _net(jmx)
    jnet.initialize(jmx.initializer.Normal(0.5))
    params = {k: onp.asarray(p.data().asnumpy())
              for k, p in jnet.collect_params().items()}
    net = _net(mt)
    net.initialize(device=mt.cpu())
    convert.load_jax_params(net, params)
    kw = dict(OPTIMIZERS[optimizer])
    if dtype == "bfloat16":
        for n in (jnet, net):
            n.user.cast("bfloat16")
            n.item.cast("bfloat16")
        kw["multi_precision"] = True
    if hybridize:
        jnet.hybridize()
        net.hybridize()
    return ((net, mt.gluon.Trainer(net.collect_params(), optimizer, kw)),
            (jnet, jmx.gluon.Trainer(jnet.collect_params(), optimizer, kw)))


def _step(pkg, net, trainer, batch):
    u, i, m, y = batch
    if pkg is mt:
        with mt.cpu():
            args = [mt.np.array(a, dtype=a.dtype) for a in (u, i, m, y)]
    else:
        args = [jmx.np.array(a, dtype=a.dtype) for a in (u, i, m, y)]
    lossfn = pkg.gluon.loss.L2Loss()
    with pkg.autograd.record():
        loss = lossfn(net(*args[:3]), args[3])
    loss.backward()
    trainer.step(B)


def _close(got, want, dtype, tag, weight):
    """rtol 2e-5, and 2e-5 of the tensor's largest value (an element
    near 0); a bf16 weight within one bf16 ulp (its master's rounding may
    fall on either side)."""
    rtol = 2.0 ** -8 if weight and dtype == "bfloat16" else 2e-5
    onp.testing.assert_allclose(got, want, rtol=rtol,
                                atol=2e-5 * float(onp.abs(want).max()),
                                err_msg=str(tag))


def _compare(port, ref, dtype, tag):
    (net, tr), (jnet, jtr) = port, ref
    for name, p in net.collect_params().items():
        got = _host(p.data())[0]
        want = _host(jnet.collect_params()[name].data())[0]
        _close(got, want, dtype, (tag, name), True)
    for k, (s, js) in enumerate(zip(tr._states, jtr._states)):
        got, want = _host(s), _host(js)
        assert len(got) == len(want), (tag, k)
        for g, w in zip(got, want):
            _close(g, w, dtype, (tag, "state", k), False)


def _run(optimizer):
    """Every dtype and mode of ``optimizer``: 3 steps in both packages,
    compared after each; returns nothing, asserts all."""
    lazy = optimizer != "lamb"
    configs = [("float32", False)]
    if optimizer != "lamb":   # LAMB's update is dense in every form
        configs.append(("bfloat16", False))
    if optimizer == "adam":   # hybridized: dense, as LAMB's is
        configs.append(("float32", True))
    rows = {"user.weight": UNTOUCHED_U + [ZERO_U],
            "item.weight": UNTOUCHED_I + [ZERO_I]}
    for dtype, hybridize in configs:
        tag = (optimizer, dtype, "hybridized" if hybridize else "eager")
        port, ref = _pair(optimizer, dtype, hybridize)
        (net, tr), mp = port, dtype == "bfloat16"
        params = net.collect_params()
        before = {n: params[n]._tensor().detach()[r].clone()
                  for n, r in rows.items()}
        for step, batch in enumerate(_batches()):
            _step(mt, *port, batch)
            _step(jmx, *ref, batch)
            _compare(port, ref, dtype, tag + (step,))
        for name, r in rows.items():
            w = params[name]._tensor().detach()[r]
            state = _host(tr._states[tr._param_names.index(name)])
            if lazy and not hybridize:
                # untouched and zero-gradient rows keep their bits, their
                # states zero (a bf16 table's master: its initial value)
                assert w.dtype == before[name].dtype and bool(
                    (w == before[name]).all()), (tag, name)
                if mp:
                    assert onp.array_equal(state[0][r],
                                           before[name].float().numpy())
                for s in state[1 if mp else 0:]:
                    assert not s[r].any(), (tag, name)
            else:
                # the dense update moves every row (weight decay): the
                # weight, or a bf16 table's master
                moved = state[0][r] if mp else w.numpy()
                assert not onp.array_equal(
                    moved, before[name].float().numpy()), (tag, name)


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_lazy_row_updates_match_the_jax_package(optimizer):
    _run(optimizer)


def test_dense_update_without_lazy_update():
    """``lazy_update=False`` densifies the row-sparse gradient: every row
    moves, as in the JAX package."""
    port, ref = _pair("adam", "float32", False)
    port[1]._optimizer.lazy_update = False
    ref[1]._optimizer.lazy_update = False
    user = port[0].user.weight._tensor()
    before = user.detach()[UNTOUCHED_U].clone()
    for step, batch in enumerate(_batches()[:2]):
        _step(mt, *port, batch)
        _step(jmx, *ref, batch)
        _compare(port, ref, "float32", ("dense", step))
    assert not bool((user.detach()[UNTOUCHED_U] == before).any())


def test_parameters_layers_and_train_step():
    for pkg in (mt, jmx):
        with pytest.raises(ValueError):
            pkg.gluon.Parameter("w", shape=(2, 2), grad_stype="csr")
        e = pkg.gluon.nn.Embedding(5, 2, sparse_grad=True)
        assert e.weight.grad_stype == "row_sparse"
        assert pkg.gluon.nn.Embedding(5, 2).weight.grad_stype == "default"
    net = _net(mt)
    net.initialize(device=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "adam")
    step = mt.gluon.TrainStep(net, mt.gluon.loss.L2Loss(), tr, n_data=3)
    with mt.cpu():
        u, i, m, y = (mt.np.array(a, dtype=a.dtype) for a in _batches()[0])
        step(u, i, m, y)
    assert "sparse gradient" in step.ineligible_reason()
    # rows are recorded only while recording, and not in a hybridized one
    w = net.user.weight
    with mt.cpu():
        ids = mt.np.array(onp.array([1, 2], "int32"), dtype="int32")
        net.user(ids)
        assert w._sparse_row_hints == []
        with mt.autograd.record():
            net.user(ids)
        assert len(w._sparse_row_hints) == 1
        w.zero_grad()
        assert w._sparse_row_hints == []
        net.hybridize()
        with mt.autograd.record():
            net(ids, ids, mt.np.ones(2))
        assert w._sparse_row_hints == []


def test_matrix_factorization_example_from_the_jax_weights():
    """The port's tools/matrix_factorization.py against the example's own
    loop in the JAX package, at a tiny size, from the JAX weights: the
    same ratings and batches (one RandomState each), 3 Adam steps with
    lazy_update, weights and states after each and the rmse."""
    users, items, rank, batch = 12, 15, 4, 8
    rs_j, rs_t = onp.random.RandomState(0), onp.random.RandomState(0)
    u_true = rs_j.randn(users, rank).astype("f") / rank ** 0.5
    i_true = rs_j.randn(items, rank).astype("f") / rank ** 0.5
    noise = 0.05 * rs_j.randn(users, items).astype("f")
    ratings_j = u_true @ i_true.T + noise

    class JMF(jmx.gluon.nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.user = jmx.gluon.nn.Embedding(users, rank, sparse_grad=True)
            self.item = jmx.gluon.nn.Embedding(items, rank, sparse_grad=True)

        def forward(self, uid, iid):
            return (self.user(uid) * self.item(iid)).sum(axis=-1)

    jnet = JMF()
    jnet.initialize(jmx.initializer.Normal(1.0 / rank ** 0.5))
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                            {"learning_rate": 0.05, "lazy_update": True})
    jloss = jmx.gluon.loss.L2Loss()
    with mt.cpu():
        ratings = mf.Ratings(users, items, rank, rs_t, mt.cpu())
        onp.testing.assert_array_equal(ratings.matrix, ratings_j)
        net, tr, lossfn = mf.build_mf(users, items, rank, 0.05, mt.cpu())
        convert.load_jax_params(net, {
            k: onp.asarray(p.data().asnumpy())
            for k, p in jnet.collect_params().items()})
        for step in range(3):
            uid, iid, y = mf.draw_batch(ratings, rs_t, batch)
            mf.train_step(net, tr, lossfn, uid, iid, y)
            ju = rs_j.randint(0, users, batch)
            ji = rs_j.randint(0, items, batch)
            with jmx.autograd.record():
                loss = jloss(jnet(jmx.np.array(ju), jmx.np.array(ji)),
                             jmx.np.array(ratings_j[ju, ji]))
            loss.backward()
            jtr.step(batch)
            _compare((net, tr), (jnet, jtr), "float32", ("mf", step))
        got = mf.rmse(net, ratings)
    uid, iid = mf.eval_pairs(users, items)
    pred = jnet(jmx.np.array(uid), jmx.np.array(iid)).asnumpy()
    want = float(onp.sqrt(onp.mean((pred - ratings_j[uid, iid]) ** 2)))
    assert abs(got - want) <= 1e-5 * want
