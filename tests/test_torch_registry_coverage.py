"""The port's operator registry and the namespaces filled from it against
the JAX package's: every name of the JAX package's registry, ``mx.nd``,
``mx.npx``, ``mx.np.linalg``, ``mx.np.random``, ``mx.random`` and
``mx.nd.random`` exists in the port, except the groups of :data:`DEFERRED`
that later slices bring. Then one call of every case of the sweep table
(``mxnet_tpu_torch/ops/_sweep_cases.py``, which the card's smoke also
runs) on CPU NDArrays.

The helpers at the bottom (:func:`port_call`, :func:`jax_call`,
:func:`mismatch`, :func:`grads_pair`) are shared by the other
``test_torch_registry_*.py`` files: each feeds the same numpy inputs to
a registry op of both packages (the JAX package's pure function on jax
arrays, the port's on CPU tensors).
"""
import importlib
import types

import numpy as onp
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import _OPS as JOPS
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import _sweep_cases as sc
from mxnet_tpu_torch.ops.registry import _OPS as TOPS

#: the names the port may lack, by the ROADMAP.md queue 1 item that brings
#: each group: the JAX modules of the registered functions, and the
#: namespace names outside the registry. It may shrink, not grow.
DEFERRED = {
    "queue 1 item 4: ops/aliases.py, the internal spellings (_npi_* of "
    "mx.np, *_scalar, mp_*/multi_*/preloaded_* updates, ...)": dict(
        modules=("mxnet_tpu.ops.aliases", "jax.numpy", "jax.numpy.linalg",
                 "mxnet_tpu.numpy.multiarray")),
    "queue 1 item 5: the image ops": dict(
        modules=("mxnet_tpu.image.image",), names=("image",)),
    "queue 1 item 11: contrib/ (ops, dgl), operator.Custom, ops/rnn.py, "
    "the symbol executor's CachedOp": dict(
        modules=("mxnet_tpu.contrib.ops", "mxnet_tpu.contrib.dgl",
                 "mxnet_tpu.operator", "mxnet_tpu.ops.rnn"),
        names=("contrib", "rnn", "RNN", "Custom", "CachedOp")),
}
_DEFERRED_MODULES = {m for g in DEFERRED.values() for m in g["modules"]}
_DEFERRED_NAMES = {n for g in DEFERRED.values() for n in g.get("names", ())}


def _deferred(name):
    fn = JOPS.get(name)
    if fn is not None and getattr(fn, "__module__", None) in \
            _DEFERRED_MODULES:
        return True
    return name in _DEFERRED_NAMES


#: the module of the wrappers ``mxnet_tpu.library.load`` makes: it puts a
#: user library's ops into the JAX package's registry (``lib::<op>``) and
#: ``mx.nd`` (``<op>``) at run time, so what another test of the same
#: process loaded is not the JAX package's own
_LOADED_AT_RUN_TIME = "mxnet_tpu.library"


def _loaded(value):
    """A wrapper that ``mxnet_tpu.library.load`` registered."""
    return getattr(value, "__module__", None) == _LOADED_AT_RUN_TIME


def _foreign(value):
    """A module or future-feature an ``import`` left in a JAX namespace
    (``jax``, ``jnp``, ``functools``, ``annotations``)."""
    if isinstance(value, types.ModuleType):
        return not value.__name__.startswith("mxnet_tpu")
    return type(value).__module__ == "__future__"


_NAMESPACES = ("nd", "npx", "np.linalg", "np.random", "random", "nd.random")


def _resolve(root, path):
    obj = root
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def test_registry_covers_the_jax_registry():
    missing = sorted(n for n in JOPS if n not in TOPS and not _deferred(n)
                     and not _loaded(JOPS[n]))
    assert not missing, f"registry names missing from the port: {missing}"
    # every deferred group still stands for something missing
    for group, spec in DEFERRED.items():
        names = [n for n in JOPS
                 if getattr(JOPS[n], "__module__", None) in spec["modules"]]
        assert any(n not in TOPS for n in names) or spec.get("names"), group


def test_namespaces_cover_the_jax_namespaces():
    missing = {}
    for path in _NAMESPACES:
        jns, tns = _resolve(jmx, path), _resolve(mt, path)
        lacks = sorted(
            n for n in dir(jns) if not n.startswith("_")
            and not _foreign(getattr(jns, n)) and not hasattr(tns, n)
            and not _deferred(n) and not _loaded(getattr(jns, n)))
        if lacks:
            missing[f"mx.{path}"] = lacks
    assert not missing, missing


def test_coverage_leaves_out_ops_loaded_at_run_time(monkeypatch):
    """An op that ``mxnet_tpu.library.load`` put into the JAX registry and
    ``mx.nd`` (as ``tests/test_custom_op.py`` does earlier in the same
    process) is not one the port must have: both coverage checks still
    pass with such an op registered, and its name is left out of them
    alone."""
    def fake_relu(x):
        return x

    fake_relu.__module__ = _LOADED_AT_RUN_TIME
    monkeypatch.setitem(JOPS, "lib::fake_relu", fake_relu)
    monkeypatch.setattr(jmx.nd, "fake_relu", fake_relu, raising=False)
    assert _loaded(JOPS["lib::fake_relu"]) and not hasattr(mt.nd,
                                                           "fake_relu")
    test_registry_covers_the_jax_registry()
    test_namespaces_cover_the_jax_namespaces()
    # a JAX op of another module is still held against the port
    assert not _loaded(JOPS["Convolution"])


def test_sweep_table_covers_the_new_registry_names():
    keys = {c.key for c in sc.CASES}
    want = set(TOPS) - sc.EARLIER
    assert want <= keys, sorted(want - keys)
    assert all(k in TOPS or "." in k for k in keys), sorted(
        k for k in keys if k not in TOPS and "." not in k)
    assert sc.EARLIER <= set(TOPS)


def test_sweep_runs_on_cpu_ndarrays():
    """Every case once on CPU NDArrays: results on the CPU; a sampler's
    two draws after one seed equal, a deterministic case's two calls
    too."""
    data = sc.inputs(0)
    bad = []
    with mt.cpu():
        for case in sc.CASES:
            fn = sc.function_of(mt, case.key)
            runs = []
            for _ in range(2):
                mt.random.seed(11)
                args, kw = sc.materialize(
                    case, data, lambda a: mt.np.array(a, dtype=a.dtype))
                out = fn(*args, **kw)
                if case.kind == "sample_inplace":
                    out = args[0]
                runs.append(out)
            leaves = [sc.host_leaves(r) for r in runs]
            devices = {leaf._data.device.type for leaf in _ndarrays(runs[0])}
            if devices != {"cpu"}:
                bad.append((case.key, "devices", devices))
            for a, b in zip(*leaves):
                if a.shape != b.shape or not onp.array_equal(
                        a, b, equal_nan=a.dtype.kind in "fc"):
                    bad.append((case.key, "repeat differs"))
                    break
    assert not bad, bad


def _ndarrays(out):
    """The NDArrays of a result: a sparse array's are its stored ones."""
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _ndarrays(o)]
    if isinstance(out, mt.nd.BaseSparseNDArray):
        return [out.data, out.indices]
    return [out] if isinstance(out, mt.NDArray) else []


def test_nd_op_and_internal_namespaces():
    """``mx.nd.op`` is ``mx.nd``; ``mx.nd._internal`` resolves the
    registry's names, ``_``-spellings and the pure forms of the ops
    ``mx.nd`` hand-writes; ``mx.nd.linalg`` drops the prefix."""
    assert mt.nd.op.Convolution is mt.nd.Convolution
    for mod in (mt.nd, mt.npx):
        for name in ("linalg_potrf", "topk", "SoftmaxOutput",
                     "flash_attention", "sgd_update"):
            assert callable(getattr(mod, name)), (mod.__name__, name)
    assert mt.nd._internal.linalg_gemm2.__name__ == "linalg_gemm2"
    assert mt.nd._internal.BatchNorm.__name__ == "BatchNorm"
    assert mt.nd._internal.shuffle.__name__ == "_shuffle"
    assert mt.nd.linalg.potrf.__name__ == "linalg_potrf"
    jlin = [n for n in dir(jmx.nd.linalg) if not n.startswith("_")
            and not _foreign(getattr(jmx.nd.linalg, n))]
    assert all(hasattr(mt.nd.linalg, n) for n in jlin)
    assert importlib.import_module("mxnet_tpu_torch.ndarray.register") \
        .populate is mt.nd.populate


# ---------------------------------------------------------------------------
# helpers of the test_torch_registry_*.py files
# ---------------------------------------------------------------------------

def port_call(key, args, kwargs):
    """The port's registry op ``key`` on CPU tensors of the numpy
    arguments (lists too)."""
    return TOPS[key](*_fill(args, torch.from_numpy),
                     **dict(zip(kwargs, _fill(list(kwargs.values()),
                                              torch.from_numpy))))


def _split(args, kwargs):
    """The numpy arrays among the arguments (lists too) and a function
    that puts others in their place."""
    flat = list(args) + list(kwargs.values())
    where = []
    for i, v in enumerate(flat):
        if isinstance(v, onp.ndarray):
            where.append((i, None))
        elif isinstance(v, list):
            where += [(i, j) for j, x in enumerate(v)
                      if isinstance(x, onp.ndarray)]
    arrays = [flat[i] if j is None else flat[i][j] for i, j in where]

    def rebuild(xs):
        call = [list(v) if isinstance(v, list) else v for v in flat]
        for (i, j), x in zip(where, xs):
            if j is None:
                call[i] = x
            else:
                call[i][j] = x
        return (tuple(call[:len(args)]),
                dict(zip(kwargs, call[len(args):])))

    return arrays, rebuild


def _pure(key, rebuild):
    def fn(*xs):
        a, kw = rebuild(xs)
        return JOPS[key](*a, **kw)
    return fn


def jax_call(key, args, kwargs):
    """The JAX package's registry op ``key``, its pure function on jax
    arrays of the same arguments, compiled with ``jax.jit`` (the array
    arguments traced, the others static), or run eagerly where it reads a
    value on the host."""
    return jax_batch([(key, args, kwargs)])[0]


def _jittable(fn, xs):
    try:
        jax.eval_shape(fn, *xs)
        return True
    except (jax.errors.ConcretizationTypeError, TypeError):
        return False


def jax_batch(calls):
    """The outputs of the JAX package's registry ops for ``calls``, a list
    of ``(key, args, kwargs)`` with numpy arrays: the ops that trace are
    compiled together as one ``jax.jit`` (one compile, not one each:
    XLA's fixed cost a compile dominates at these sizes), the others run
    eagerly."""
    prepared = []
    for key, args, kwargs in calls:
        arrays, rebuild = _split(args, kwargs)
        xs = [jnp.asarray(a) for a in arrays]
        fn = _pure(key, rebuild)
        prepared.append((fn, xs, _jittable(fn, xs)))
    together = [(fn, xs) for fn, xs, ok in prepared if ok]

    def joint(*flat):
        outs, at = [], 0
        for fn, xs in together:
            outs.append(fn(*flat[at:at + len(xs)]))
            at += len(xs)
        return outs

    joined = iter(jax.jit(joint)(*[x for _, xs in together for x in xs])
                  if together else ())
    return [next(joined) if ok else fn(*xs) for fn, xs, ok in prepared]


def _fill(values, make):
    out = []
    for v in values:
        if isinstance(v, onp.ndarray):
            out.append(make(onp.ascontiguousarray(v)))
        elif isinstance(v, list):
            out.append(_fill(v, make))
        else:
            out.append(v)
    return tuple(out) if isinstance(values, tuple) else out


def host(out):
    """The leaves of a result of either package, as numpy."""
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in host(o)]
    if isinstance(out, torch.Tensor):
        out = out.detach()
        return [(out.float() if out.dtype == torch.bfloat16 else out)
                .numpy()]
    if hasattr(out, "asnumpy"):
        return [onp.asarray(out.asnumpy())]
    return [onp.asarray(out)]


def mismatch(label, want, got, rtol=1e-5, atol=1e-6, check="value",
             dtype=True):
    """None when the leaves agree (f32 within ``rtol`` relative plus
    ``atol``), else what differs."""
    want, got = host(want), host(got)
    if len(want) != len(got):
        return f"{label}: {len(want)} outputs vs {len(got)}"
    for i, (a, b) in enumerate(zip(want, got)):
        if a.shape != b.shape:
            return f"{label}[{i}]: shape {a.shape} vs {b.shape}"
        if dtype and a.dtype != b.dtype:
            return f"{label}[{i}]: dtype {a.dtype} vs {b.dtype}"
        if check == "abs":
            a, b = onp.abs(a), onp.abs(b)
        if a.dtype.kind in "fc" or b.dtype.kind in "fc":
            a64 = a.astype(complex if a.dtype.kind == "c" else "f8")
            b64 = b.astype(complex if b.dtype.kind == "c" else "f8")
            if not onp.allclose(b64, a64, rtol=rtol, atol=atol,
                                equal_nan=True):
                err = onp.nanmax(onp.abs(a64 - b64))
                return f"{label}[{i}]: max abs err {err:.3g}"
        elif not onp.array_equal(a, b):
            return f"{label}[{i}]: values differ"
    return None


def grads_pair(key, args, kwargs, wrt, seed=3):
    """``(jax grads, port grads)`` of one op (:func:`grads_batch`)."""
    _, jg, _, tg = grads_batch([(key, args, kwargs, wrt)], seed)[0]
    return jg, tg


def grads_batch(entries, seed=3):
    """For each ``(key, args, kwargs, wrt)``: ``(jax outputs, jax grads,
    port outputs, port grads)``, the grads those of ``sum(out_i * ct_i)``
    over the float outputs with respect to the positional arguments at
    ``wrt``, the cotangents ``ct_i`` the same numpy draws for both
    packages. The JAX side is one ``jax.jit`` over all entries."""
    rs = onp.random.RandomState(seed)
    jobs = []
    for key, args, kwargs, wrt in entries:
        arrays, rebuild = _split(tuple(args), kwargs)
        slots = tuple(next(n for n, a in enumerate(arrays) if a is args[i])
                      for i in wrt)
        fn = _pure(key, rebuild)
        xs = [jnp.asarray(a) for a in arrays]
        shapes = jax.tree_util.tree_leaves(jax.eval_shape(fn, *xs))
        cts = [rs.uniform(-1, 1, o.shape).astype(o.dtype)
               if jnp.issubdtype(o.dtype, jnp.floating) else None
               for o in shapes]
        jobs.append((fn, xs, slots, cts))

    def joint(*flat):
        res, at = [], 0
        for fn, xs, slots, cts in jobs:
            mine = flat[at:at + len(xs)]
            at += len(xs)

            def loss(*ys, fn=fn, cts=cts):
                leaves = jax.tree_util.tree_leaves(fn(*ys))
                return sum(jnp.sum(o * c) for o, c in zip(leaves, cts)
                           if c is not None)
            res.append((fn(*mine), jax.grad(loss, argnums=slots)(*mine)))
        return res

    jres = jax.jit(joint)(*[x for job in jobs for x in job[1]])
    out = []
    for (key, args, kwargs, wrt), (_, _, _, cts), (jout, jg) in zip(
            entries, jobs, jres):
        xs = [torch.from_numpy(args[i].copy()).requires_grad_()
              for i in wrt]
        call = list(_fill(tuple(args), torch.from_numpy))
        for i, x in zip(wrt, xs):
            call[i] = x
        touts = TOPS[key](*call, **kwargs)
        leaves = list(touts) if isinstance(touts, (list, tuple)) \
            else [touts]
        loss = sum((o * torch.from_numpy(c)).sum()
                   for o, c in zip(leaves, cts) if c is not None)
        tg = torch.autograd.grad(loss, xs, allow_unused=True)
        out.append((jout, list(jg), touts,
                    [torch.zeros_like(x) if t is None else t
                     for x, t in zip(xs, tg)]))
    return out
