"""The port's NDArray frontend (``mx.np``, ``mx.nd``, NDArray, autograd on
NDArrays) against the JAX package's, on the CPU, from the same numpy
inputs made from a seed.

Tolerance: 1e-6 relative in float32 (plus 1e-7 absolute for values near
zero: the two frameworks' transcendental functions may differ by an ulp),
integers and booleans equal, dtypes equal unless a case says otherwise.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.numpy import multiarray as tmulti

RTOL, ATOL = 1e-6, 1e-7


def _rs(seed=0):
    return onp.random.RandomState(seed)


def _inputs():
    r = _rs(0)
    f = r.uniform(0.1, 0.9, (3, 4)).astype("f")
    g = r.uniform(1.1, 2.0, (3, 4)).astype("f")
    i = r.randint(1, 9, (3, 4)).astype("int32")
    j = r.randint(1, 4, (3, 4)).astype("int32")
    h = f.copy()
    h[0, 0], h[1, 1], h[2, 2] = onp.nan, onp.inf, -onp.inf
    h2 = f.copy()
    h2[0, 1] = h2[2, 3] = onp.nan
    return dict(
        F=f, G=g, I=i, J=j, H=h, H2=h2,
        V=onp.sort(r.uniform(0.0, 1.0, 5).astype("f")),
        V2=r.uniform(0.0, 1.0, 4).astype("f"),
        M=r.uniform(-1, 1, (4, 4)).astype("f"),
        T3=r.uniform(-1, 1, (2, 3, 4)).astype("f"),
        A6=r.uniform(-1, 1, (6, 4)).astype("f"),
        P3=r.uniform(-1, 1, (4, 3)).astype("f"),
        Z=(i - 4).astype("int32"),
        IDX=onp.array([[0], [2], [1]], dtype="int32"),
    )


def _both(x):
    """x as a (JAX package, port) pair of NDArrays; lists and tuples of
    arrays element by element; anything else as it is."""
    if isinstance(x, onp.ndarray):
        return (jmx.np.array(x, dtype=x.dtype),
                mt.np.array(x, dtype=x.dtype, device=mt.cpu()))
    if isinstance(x, (list, tuple)) and any(isinstance(v, onp.ndarray)
                                            for v in x):
        pairs = [_both(v) for v in x]
        return type(x)(p[0] for p in pairs), type(x)(p[1] for p in pairs)
    return x, x


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _compare(name, jout, tout, check_dtype=True):
    """None when the outputs agree, else what differs."""
    jl, tl = _leaves(jout), _leaves(tout)
    if len(jl) != len(tl):
        return f"{len(jl)} outputs vs {len(tl)}"
    for a, b in zip(jl, tl):
        a = onp.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a)
        b = onp.asarray(b.asnumpy() if hasattr(b, "asnumpy") else b)
        if a.shape != b.shape:
            return f"shape {a.shape} vs {b.shape}"
        if check_dtype and a.dtype != b.dtype:
            return f"dtype {a.dtype} vs {b.dtype}"
        try:
            if a.dtype.kind == "f":
                onp.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                            equal_nan=True)
            else:
                onp.testing.assert_array_equal(b, a)
        except AssertionError as e:
            return str(e).strip().splitlines()[-1]
    return None


def _run(name, args, kwargs=None, check_dtype=True):
    kwargs = kwargs or {}
    jargs, targs = zip(*[_both(a) for a in args]) if args else ((), ())
    with mt.cpu():
        tout = getattr(mt.np, name)(*targs, **kwargs)
    jout = getattr(jmx.np, name)(*jargs, **kwargs)
    return _compare(name, jout, tout, check_dtype)


def test_creation_and_its_dtype_defaults():
    with mt.cpu():
        cases = [
            ("list of ints", mt.np.array([1, 2, 3]), jmx.np.array([1, 2, 3])),
            ("list of floats", mt.np.array([[1.5, 2]]),
             jmx.np.array([[1.5, 2]])),
            ("float64 numpy", mt.np.array(onp.ones(3)),
             jmx.np.array(onp.ones(3))),
            ("int64 numpy", mt.np.array(onp.arange(4)),
             jmx.np.array(onp.arange(4))),
            ("bool list", mt.np.array([True, False]),
             jmx.np.array([True, False])),
            ("explicit int8", mt.np.array([1, 2], dtype="int8"),
             jmx.np.array([1, 2], dtype="int8")),
            ("zeros", mt.np.zeros((2, 3)), jmx.np.zeros((2, 3))),
            ("ones int32", mt.np.ones((2,), dtype="int32"),
             jmx.np.ones((2,), dtype="int32")),
            ("full int", mt.np.full((2, 2), 3), jmx.np.full((2, 2), 3)),
            ("full float", mt.np.full((2,), 2.5), jmx.np.full((2,), 2.5)),
            ("arange ints", mt.np.arange(5), jmx.np.arange(5)),
            ("arange step", mt.np.arange(1, 7, 2), jmx.np.arange(1, 7, 2)),
            ("eye", mt.np.eye(3), jmx.np.eye(3)),
            ("nd.arange repeat", mt.nd.arange(2, 6, step=2, repeat=3),
             jmx.nd.arange(2, 6, step=2, repeat=3)),
        ]
        like = mt.np.array(onp.arange(6, dtype="int32").reshape(2, 3))
        jlike = jmx.np.array(onp.arange(6, dtype="int32").reshape(2, 3))
        for fn in ("zeros_like", "ones_like"):
            cases.append((fn, getattr(mt.np, fn)(like),
                          getattr(jmx.np, fn)(jlike)))
        cases.append(("full_like", mt.np.full_like(like, 7),
                      jmx.np.full_like(jlike, 7)))
    bad = {label: err for label, t, j in cases
           if (err := _compare(label, j, t)) is not None}
    assert bad == {}
    assert all(t.device == torch.device("cpu") for _, t, _ in cases)
    # an NDArray source is copied, and the host array is never aliased
    src = onp.zeros(3, dtype="f")
    a = mt.np.array(src, device=mt.cpu())
    src[0] = 5
    assert a.asnumpy()[0] == 0
    b = mt.np.array(a, device="cpu")
    b[0] = 1
    assert a.asnumpy()[0] == 0 and b.asnumpy()[0] == 1
    assert mt.npx.default_float_dtype() is onp.float32
    # npx.set_np(dtype=True): official numpy's creation defaults, in both
    try:
        mt.npx.set_np(dtype=True)
        jmx.npx.set_np(dtype=True)
        with mt.cpu():
            got = [mt.np.array([1, 2]), mt.np.arange(3), mt.np.arange(0.5, 2),
                   mt.np.zeros((2,))]
        want = [jmx.np.array([1, 2]), jmx.np.arange(3),
                jmx.np.arange(0.5, 2), jmx.np.zeros((2,))]
        assert [str(g.dtype) for g in got] == [str(w.dtype) for w in want]
        assert mt.npx.default_float_dtype() is onp.float64
    finally:
        mt.npx.set_np()
        jmx.npx.set_np()
    assert mt.np.zeros((1,), device="cpu").dtype == onp.float32


def test_arithmetic_comparison_and_inplace_operators():
    d = _inputs()
    jf, tf = _both(d["F"])
    jg, tg = _both(d["G"])
    ji, ti = _both(d["I"])
    ops = {
        "add": lambda a, b, s, i: (a + b, a + 2.0, 3 + a, i + 2),
        "sub": lambda a, b, s, i: (a - b, a - 1.5, 1 - a, i - 1),
        "mul": lambda a, b, s, i: (a * b, a * 3, 2 * a, i * 3),
        "div": lambda a, b, s, i: (a / b, a / 4, 1 / a, i / 2),
        "floordiv": lambda a, b, s, i: (b // a, a // 0.3, i // 3),
        "mod": lambda a, b, s, i: (b % a, a % 0.3, i % 3),
        "pow": lambda a, b, s, i: (a ** b, a ** 2, 2 ** a),
        "matmul": lambda a, b, s, i: (a @ b.T,),
        "unary": lambda a, b, s, i: (-a, abs(a - 0.5), +a),
        "compare": lambda a, b, s, i: (a < b, a <= 0.5, a > 0.5, a >= b,
                                       a == a, a != b, i == 3),
        "bitwise": lambda a, b, s, i: (i & 6, i | 1, i ^ 5, ~i),
    }
    bad = {}
    for name, fn in ops.items():
        with mt.cpu():
            tout = fn(tf, tg, None, ti)
        err = _compare(name, fn(jf, jg, None, ji), tout)
        if err:
            bad[name] = err
    assert bad == {}

    # in place: the handle is swapped and the version bumped, as in the JAX
    # package; values agree
    for pkg, a in (("jax", jmx.np.array(d["F"])), ("port", None)):
        if pkg == "port":
            a = mt.np.array(d["F"], device=mt.cpu())
        v0 = a._version
        a += 1.0
        a *= 2
        a -= a / 4
        a /= 3
        a[0, 1] = 10.0
        a[1] = a[2]
        a[:, 3] = mt.np.array([7.0, 8, 9], device=mt.cpu()) \
            if pkg == "port" else jmx.np.array([7.0, 8, 9])
        assert a._version == v0 + 7, pkg
        if pkg == "jax":
            want = a.asnumpy()
        else:
            onp.testing.assert_allclose(a.asnumpy(), want, rtol=RTOL)
    # a view taken before a write keeps the old values, as JAX's copies do
    b = mt.np.array(d["F"], device=mt.cpu())
    row = b[0]
    b[0] = 0.0
    onp.testing.assert_array_equal(row.asnumpy(), d["F"][0])


def test_reductions_reshape_transpose_and_indexing():
    d = _inputs()
    jt, tt = _both(d["T3"])
    ji, ti = _both(d["I"])
    jidx, tidx = _both(onp.array([1, 0], dtype="int32"))
    jmask, tmask = _both(d["T3"] > 0)
    cases = {
        "sum": lambda a, i, idx, m: (a.sum(), a.sum(axis=1),
                                     a.sum(axis=(0, 2), keepdims=True),
                                     i.sum(), i.sum(axis=0)),
        "mean": lambda a, i, idx, m: (a.mean(), a.mean(axis=-1), i.mean()),
        "max_min": lambda a, i, idx, m: (a.max(), a.min(axis=0),
                                         a.max(axis=1, keepdims=True)),
        "prod_std_var": lambda a, i, idx, m: (a.prod(axis=2), a.std(),
                                              a.var(axis=1, ddof=1)),
        "arg": lambda a, i, idx, m: (a.argmax(), a.argmin(axis=1),
                                     i.argmax(axis=0)),
        "any_all": lambda a, i, idx, m: ((a > 0).any(), (a > -2).all(axis=1)),
        "cumsum": lambda a, i, idx, m: (a.cumsum(), a.cumsum(axis=1),
                                        i.cumsum(axis=0)),
        "reshape": lambda a, i, idx, m: (a.reshape(4, 6), a.reshape((-1,)),
                                         a.reshape(0, -1), a.reshape(-3, 4),
                                         a.reshape(-4, 1, 2, -2),
                                         a.flatten()),
        "transpose": lambda a, i, idx, m: (a.T, a.transpose(1, 0, 2),
                                           a.transpose((2, 0, 1)),
                                           a.swapaxes(0, 2)),
        "shape_ops": lambda a, i, idx, m: (a.expand_dims(1).squeeze(1),
                                           a.repeat(2, axis=1),
                                           a[0:1].squeeze(),
                                           a.clip(-0.5, 0.5)),
        "index": lambda a, i, idx, m: (a[1], a[:, 1:3], a[..., -1],
                                       a[0, ::2, 1], a[idx], a[:, idx],
                                       a[[1, 0]], a[m], a[None, 1]),
        "math": lambda a, i, idx, m: (a.abs().sqrt(), a.exp(), a.tanh(),
                                      a.sigmoid(), a.relu(),
                                      (a * 10).round(), a.dot(a.T[..., 0])),
        "astype": lambda a, i, idx, m: (a.astype("int32"), i.astype("float32"),
                                        a.astype("float16")),
    }
    bad = {}
    for name, fn in cases.items():
        with mt.cpu():
            tout = fn(tt, ti, tidx, tmask)
        err = _compare(name, fn(jt, ji, jidx, jmask), tout)
        if err:
            bad[name] = err
    assert bad == {}
    assert tt.shape == (2, 3, 4) and tt.ndim == 3 and tt.size == 24
    assert tt.dtype == onp.float32 and len(tt) == 2
    assert float(mt.np.array([2.5], device=mt.cpu())) == 2.5
    assert tt.wait_to_read() is tt
    assert [r.shape for r in tt] == [(3, 4), (3, 4)]


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_attach_grad_record_backward_against_the_jax_ndarray(grad_req):
    r = _rs(3)
    xv = r.uniform(-1, 1, (3, 4)).astype("f")
    wv = r.uniform(-1, 1, (4, 2)).astype("f")
    head = r.uniform(-1, 1, (3, 2)).astype("f")

    def run(np_mod, autograd, dev):
        kw = {"device": dev} if dev is not None else {}
        x = np_mod.array(xv, **kw)
        w = np_mod.array(wv, **kw)
        x.attach_grad(grad_req)
        w.attach_grad(grad_req)
        grads = []
        for step in range(2):
            with autograd.record():
                h = x * 2.0
                h[0] = h[0] + 1.0          # in place inside record()
                h += 0.5
                y = np_mod.tanh(np_mod.matmul(h, w)) * (step + 1)
                z = (y ** 2).sum(axis=1)
            if step == 0:
                y.backward(np_mod.array(head, **kw))
            else:
                z.backward()               # ones as the head gradient
            grads.append((x.grad.asnumpy().copy(), w.grad.asnumpy().copy()))
        # outside record() nothing is recorded; x stays a variable
        x += 1.0
        with autograd.record():
            s = (x * x).sum()
        s.backward()
        grads.append((x.grad.asnumpy().copy(),))
        return grads, y.asnumpy()

    jg, jy = run(jmx.np, jmx.autograd, None)
    tg, ty = run(mt.np, mt.autograd, mt.cpu())
    onp.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-6)
    for js, ts in zip(jg, tg):
        for a, b in zip(js, ts):
            onp.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    # nothing was recorded outside record(); detach cuts the graph
    with mt.cpu():
        x = mt.np.array(xv)
        x.attach_grad()
        assert not (x * 2)._data.requires_grad
        with mt.autograd.record():
            d = (x * 2).detach()
        assert not d._data.requires_grad


def test_every_generated_np_name_matches_the_jax_package():
    """Every name the port generates from the JAX package's four lists, on
    the same inputs; all failing names are reported at once."""
    d = _inputs()
    F, G, I, J, H, H2 = (d[k] for k in ("F", "G", "I", "J", "H", "H2"))
    V, V2, M, T3 = d["V"], d["V2"], d["M"], d["T3"]
    unary_domain = {"arccosh": G, "acosh": G, "bitwise_invert": I,
                    "bitwise_not": I, "invert": I, "nan_to_num": H,
                    "isnan": H, "isinf": H, "isfinite": H, "isneginf": H,
                    "isposinf": H}
    int_binary = {"gcd", "lcm", "left_shift", "right_shift", "bitwise_and",
                  "bitwise_or", "bitwise_xor", "bitwise_left_shift",
                  "bitwise_right_shift"}
    calls = {}
    for n in tmulti._UNARY:
        calls[n] = [((unary_domain.get(n, F),), {})]
    for n in tmulti._BINARY:
        calls[n] = [((I, J), {})] if n in int_binary else [
            ((F, G), {}), ((G, 2.0), {})]
    calls["ldexp"] = [((F, J), {})]
    calls["heaviside"] = [((F - 0.5, G), {})]
    calls["vecdot"] = [((F, G), {})]
    for n in tmulti._REDUCE:
        src = H2 if n.startswith("nan") else F
        calls[n] = [((src,), {}), ((src,), {"axis": 1}),
                    ((src,), {"axis": 0, "keepdims": True})]
    for n in ("cumsum", "cumprod", "nancumsum", "nancumprod"):
        calls[n] = [((H2 if n.startswith("nan") else F,), {}),
                    ((F,), {"axis": 1}), ((I,), {"axis": 0})]
    for n in ("argmax", "argmin", "nanargmax", "nanargmin"):
        calls[n] = [((H2 if n.startswith("nan") else F,), {}),
                    ((F,), {"axis": 1}), ((I,), {"axis": 0})]
    calls["sum"] += [((I,), {}), ((I,), {"axis": 1})]
    calls["prod"] += [((I,), {"axis": 0})]
    calls["max"] += [((I,), {"axis": 1})]
    calls["mean"] += [((I,), {})]
    calls["std"] += [((F,), {"ddof": 1})]
    calls["var"] += [((F,), {"axis": 0, "ddof": 1})]
    calls["count_nonzero"] = [((d["Z"],), {}), ((d["Z"],), {"axis": 1})]
    calls["average"] = [((F,), {}), ((F,), {"axis": 1,
                                            "weights": onp.arange(1, 5.0)})]
    for n, q in (("quantile", 0.3), ("percentile", 30.0),
                 ("nanquantile", 0.3), ("nanpercentile", 30.0)):
        src = H2 if n.startswith("nan") else F
        calls[n] = [((src, q), {}), ((src, [q / 2, q]), {"axis": 1}),
                    ((src, q), {"axis": 0, "keepdims": True})]
    calls["median"] += [((I,), {})]
    row = F[0]
    calls.update({
        "reshape": [((F, (4, 3)), {})], "ravel": [((F,), {})],
        "transpose": [((T3,), {}), ((T3, (1, 0, 2)), {})],
        "permute_dims": [((T3, (2, 0, 1)), {})],
        "swapaxes": [((T3, 0, 2), {})], "moveaxis": [((T3, 0, -1), {})],
        "rollaxis": [((T3, 2), {}), ((T3, 0, 2), {})],
        "squeeze": [((F[None],), {}), ((F[None, :, None],), {"axis": 0})],
        "expand_dims": [((F, 1), {}), ((F, (0, 3)), {})],
        "broadcast_to": [((row, (3, 4)), {})],
        "broadcast_arrays": [((F, row), {})],
        "flip": [((F,), {}), ((T3,), {"axis": 1})],
        "fliplr": [((F,), {})], "flipud": [((F,), {})],
        "rot90": [((F,), {}), ((T3, 3, (1, 2)), {})],
        "roll": [((F, 2), {}), ((F, 1), {"axis": 1})],
        "concatenate": [(([F, G],), {}), (([F, G],), {"axis": 1}),
                        (([F, G],), {"axis": None})],
        "stack": [(([F, G],), {}), (([F, G],), {"axis": 2})],
        "vstack": [(([F, G],), {})], "hstack": [(([F, G],), {})],
        "dstack": [(([F, G],), {})], "column_stack": [(([V2, row],), {})],
        "split": [((d["A6"], 3), {}), ((F, [1, 3]), {"axis": 1})],
        "array_split": [((V, 3), {})], "hsplit": [((F, 2), {})],
        "vsplit": [((d["A6"], 2), {})], "dsplit": [((T3, 2), {})],
        "tile": [((F, (2, 1)), {}), ((row, 2), {})],
        "repeat": [((F, 2), {}), ((F, 2), {"axis": 1})],
        "pad": [((F, 1), {}), ((F, ((1, 2), (0, 1))), {})],
        "take": [((F, onp.array([0, 2, 1], "int32")), {"axis": 1}),
                 ((F, onp.array([5, 0], "int32")), {})],
        "take_along_axis": [((F, d["IDX"], 1), {})],
        "extract": [((F > 0.5, F), {})],
        "searchsorted": [((V, F), {}), ((V, F), {"side": "right"})],
        "argsort": [((F,), {}), ((F,), {"axis": 0})],
        "sort": [((F,), {}), ((F,), {"axis": 0})],
        "flatnonzero": [((d["Z"],), {})], "nonzero": [((d["Z"],), {})],
        "argwhere": [((d["Z"],), {})],
        "where": [((F > 0.5, F, G), {})],
        "diag": [((M,), {}), ((V,), {"k": 1})],
        "diagflat": [((V,), {})], "diagonal": [((M,), {}), ((T3, 1, 1, 2), {})],
        "trace": [((M,), {}), ((M, 1), {})],
        "tril": [((M,), {})], "triu": [((M, 1), {})],
        "tri": [((3, 4), {})], "eye": [((3, 4), {}), ((3,), {"k": 1})],
        "identity": [((3,), {})], "vander": [((V,), {}), ((V, 3), {})],
        "dot": [((F, G.T), {}), ((T3, d["P3"]), {}), ((V2, V2), {})],
        "vdot": [((F, G), {})], "inner": [((F, G), {})],
        "outer": [((V, V2), {})], "matmul": [((F, G.T), {}), ((T3, d["P3"]), {})],
        "tensordot": [((F, G), {"axes": ([1], [1])}), ((T3, F), {})],
        "kron": [((F[:2, :2], G[:2, :2]), {})],
        "cross": [((d["P3"], d["P3"][::-1]), {})],
        "clip": [((F, 0.3, 0.6), {})],
        "round": [((F * 10,), {}), ((F, 2), {})], "around": [((F * 10,), {})],
        "unique": [((I,), {})], "unique_values": [((I,), {})],
        "unique_counts": [((I,), {})], "unique_inverse": [((I,), {})],
        "union1d": [((I, J), {})], "intersect1d": [((I, J), {})],
        "setdiff1d": [((I, J), {})], "setxor1d": [((I, J), {})],
        "in1d": [((I, J), {})], "isin": [((I, J), {})],
        "atleast_1d": [((V,), {})], "atleast_2d": [((V,), {})],
        "atleast_3d": [((F,), {})],
        "meshgrid": [((V, V2), {}), ((V, V2), {"indexing": "ij"})],
        "unravel_index": [((onp.array([1, 5, 7], "int32"), (3, 4)), {})],
        "diag_indices": [((3,), {})], "tril_indices": [((3,), {})],
        "triu_indices": [((3, 1), {})],
        "bincount": [((I.reshape(-1),), {})],
        "digitize": [((F, V), {}), ((F, V), {"right": True})],
        "corrcoef": [((F,), {})], "cov": [((F,), {})],
        "diff": [((F,), {}), ((I,), {"axis": 0})], "ediff1d": [((F,), {})],
        "trapezoid": [((F,), {})],
        "isclose": [((F, F + 1e-9), {}), ((F, G), {})],
        "allclose": [((F, F), {}), ((F, G), {})],
        "array_equal": [((F, F), {}), ((F, G), {})],
        "append": [((V, V2), {})],
        "matrix_transpose": [((T3,), {})],
        "floor_divide": [((G, F), {})],
    })
    W = onp.array([3.0, 1.0, 2.0, 5.0, 4.0, 2.0, 0.5], "f")
    K = onp.array([3, 1, 2, 5, 4, 2, 7], "int32")
    calls.update({
        "apply_along_axis": [((lambda r: (r * 2).sum(), 1, F), {})],
        "argpartition": [((W, 3), {}), ((K, 2), {})],
        "partition": [((W, 2), {}), ((F, 1), {"axis": 0})],
        "array_equiv": [((W, W), {}), ((F[:1], F), {})],
        "choose": [((onp.array([0, 4, -1], "int32"), [W[:3], W[3:6]]),
                    {"mode": "wrap"})],
        "compress": [((W > 2, W), {})],
        "convolve": [((W, W[:3]), {}), ((K, K[:3]), {"mode": "same"})],
        "correlate": [((W, W[:3]), {})],
        "cumulative_sum": [((K,), {}), ((F,), {"axis": 1})],
        "delete": [((W, 2), {}), ((W, W > 2), {})],
        "fill_diagonal": [((F, 7.5), {"inplace": False})],
        "gradient": [((F, 0.5), {"axis": 1})],
        "histogram": [((F.ravel(),), {"bins": 5})],
        "histogram2d": [((W, W[::-1].copy()), {"bins": 3})],
        "indices": [(((2, 3),), {})],
        "insert": [((W, 2, 9.0), {})],
        "interp": [((W, onp.array([0.0, 1.5, 3.0, 4.5], "f"),
                     onp.array([1.0, -1.0, 2.0, 0.0], "f")), {})],
        "lexsort": [(([W, K],), {})],
        "packbits": [((onp.array([1, 0, 1, 1, 0, 0, 0, 1, 1], "uint8"),),
                      {})],
        "unpackbits": [((onp.array([[177, 3], [0, 255]], "uint8"),),
                        {"axis": 1})],
        "piecewise": [((W, [W < 2, W > 3], [lambda x: x * 2, 7.0, 1.0]),
                       {})],
        "polyfit": [((onp.array([0.0, 1.0], "f"),
                      onp.array([1.0, 3.0], "f"), 1), {})],
        "polyval": [((onp.array([1.0, -2.0, 0.5], "f"), W), {})],
        "ravel_multi_index": [(((onp.array([1, 0, 3], "int32"),
                                 onp.array([2, 5, 1], "int32")), (4, 6)),
                               {"mode": "clip"})],
        "resize": [((W, (3, 4)), {})],
        "roots": [((onp.array([1.0, -2.0], "f"),), {})],
        "select": [(([W < 2, W > 3], [W, W * 2]), {})],
        "sort_complex": [((W,), {})],
        "trim_zeros": [((onp.array([0, 0, 1.5, 0, 2, 0], "f"),), {})],
        "unique_all": [((K,), {})],
    })
    # held in test_torch_np_rest.py instead: the JAX package lacks
    # real_if_close (jnp has none), and its histogramdd returns its edges
    # as one NDArray that cannot be read back
    elsewhere = {"real_if_close", "histogramdd"}
    failures, compared, absent = {}, [], []
    for name in sorted(set(tmulti.GENERATED) - elsewhere):
        if not hasattr(jmx.np, name):
            absent.append(name)
            continue
        for args, kwargs in calls[name]:
            try:
                err = _run(name, args, kwargs)
            except Exception as e:  # noqa: BLE001 - report every name
                err = f"{type(e).__name__}: {e}"
            if err:
                failures[f"{name}{[type(a).__name__ for a in args]}"
                         f"{kwargs}"] = err
        compared.append(name)
    assert not failures, "\n".join(f"{k}: {v}" for k, v in failures.items())
    assert len(compared) > 200
    # the JAX package generates each of these too, or provides it by hand
    assert absent == []


def test_legacy_nd_namespace_and_npx():
    d = _inputs()
    jf, tf = _both(d["F"])
    jg, tg = _both(d["G"])
    cases = {
        "broadcast": lambda nd, a, b: (nd.broadcast_add(a, b),
                                       nd.broadcast_greater(a, b),
                                       nd.broadcast_maximum(a, b)),
        "elemwise": lambda nd, a, b: (nd.elemwise_mul(a, b), nd.relu(a - .5),
                                      nd.sigmoid(a), nd.rsqrt(b)),
        "reduce": lambda nd, a, b: (nd.sum(a, axis=1), nd.mean(a),
                                    nd.sum(a, axis=1, exclude=True),
                                    nd.max(a, axis=0, keepdims=True),
                                    nd.norm(a)),
        "index": lambda nd, a, b: (nd.argmax(a, axis=1),
                                   nd.take(a, nd.array([0, 5, -1])),
                                   nd.slice_axis(a, 1, 1, 3),
                                   nd.clip(a, .2, .4)),
        "shape": lambda nd, a, b: (nd.reshape(a, shape=(0, -1)),
                                   nd.reshape(a, shape=(-3,)),
                                   nd.transpose(a), nd.flatten(a),
                                   nd.expand_dims(a, 0),
                                   nd.concat(a, b, dim=1),
                                   nd.stack(a, b, axis=0),
                                   nd.split(a, num_outputs=2, axis=1),
                                   nd.cast(a, "float16")),
        "dot": lambda nd, a, b: (nd.dot(a, b, transpose_b=True),
                                 nd.batch_dot(a[None], b[None],
                                              transpose_b=True)),
    }
    npx_cases = {
        "npx": lambda npx, a, b: (npx.relu(a - 0.5), npx.softmax(a),
                                  npx.softmax(b, axis=0),
                                  npx.activation(a, "tanh")),
    }
    bad = {}
    for name, fn, tns, jns in (
            [(n, f, mt.nd, jmx.nd) for n, f in cases.items()]
            + [(n, f, mt.npx, jmx.npx) for n, f in npx_cases.items()]):
        with mt.cpu():
            tout = fn(tns, tf, tg)
        err = _compare(name, fn(jns, jf, jg), tout)
        if err:
            bad[name] = err
    assert bad == {}
    assert "broadcast_add" in mt.ops.registry.list_ops()
    relu = mt.ops.registry.get_op("relu")
    x = torch.tensor([-1.5, 0.0, 2.0])
    assert torch.equal(relu(x), torch.relu(x))
    assert torch.equal(relu(torch.tensor([True, False])),
                       torch.tensor([1, 0], dtype=torch.int64))
    # the fluent surface: any mx.nd op as a method
    with mt.cpu():
        onp.testing.assert_allclose(tf.broadcast_add(tg).asnumpy(),
                                    (d["F"] + d["G"]), rtol=RTOL)


def test_random_is_seeded_per_device_and_save_load_round_trips(tmp_path):
    with mt.cpu():
        mt.seed(7)
        a = mt.np.random.uniform(-2, 3, size=(1000,))
        n = mt.nd.random.normal(1.0, 0.5, shape=(2000,))
        k = mt.np.random.randint(3, 9, (500,))
        mt.seed(7)
        a2 = mt.np.random.uniform(-2, 3, size=(1000,))
        mt.seed(8)
        a3 = mt.np.random.uniform(-2, 3, size=(1000,))
    assert onp.array_equal(a.asnumpy(), a2.asnumpy())
    assert not onp.array_equal(a.asnumpy(), a3.asnumpy())
    assert a.dtype == onp.float32 and k.dtype == onp.int32
    av, nv, kv = a.asnumpy(), n.asnumpy(), k.asnumpy()
    assert av.min() >= -2 and av.max() < 3 and abs(av.mean() - 0.5) < 0.2
    assert abs(nv.mean() - 1.0) < 0.05 and abs(nv.std() - 0.5) < 0.05
    assert kv.min() == 3 and kv.max() == 8
    # save/load: a dict and a list, dtypes kept
    with mt.cpu():
        x = mt.np.array(onp.arange(6, dtype="int32").reshape(2, 3))
        y = mt.np.ones((2, 2))
        mt.nd.save(str(tmp_path / "d.npz"), {"x": x, "y": y})
        mt.nd.save(str(tmp_path / "l.npz"), [y, x])
        got = mt.nd.load(str(tmp_path / "d.npz"))
        lst = mt.nd.load(str(tmp_path / "l.npz"))
    assert got["x"].dtype == onp.int32
    assert onp.array_equal(got["x"].asnumpy(), x.asnumpy())
    assert [v.shape for v in lst] == [(2, 2), (2, 3)]
