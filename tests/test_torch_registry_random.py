"""The samplers of ``mx.np.random``, ``mx.random``, ``mx.nd.random``,
``mx.npx.random`` and the registry's ``_sample_*``/``_random_pdf_*``
(numpy/random.py, ndarray/random.py, ops/random_legacy.py), on the CPU.

The streams differ (threefry against Philox), so draws are not compared
by value with the JAX package: their shapes and dtypes are, parameter
broadcasting included (``size=None`` with array parameters); the port's
draws are held to their distributions (the mean and variance of 10^5
draws against ``scipy.stats`` within 5 standard errors, each error from
the distribution's own variance and kurtosis), two draws after one seed
are equal, and a draw is made on the device of its parameters or the
current one. The densities are deterministic and compared by value.

Tolerance of the densities: f32 within 1e-5 relative (plus 1e-6
absolute).
"""
import numpy as onp
import pytest
import scipy.stats as st

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import _sweep_cases as sc
from test_torch_registry_coverage import mismatch

DATA = sc.inputs(0)
#: the dtype of each sampler of mx.np.random (and mx.random) and
#: mx.nd.random, as the JAX package gives it (64-bit types on): float32
#: draws, int32 counts, and jax.random.multinomial's float (float64)
_DTYPES = dict.fromkeys(
    ("uniform", "normal", "randn", "rand", "choice", "permutation", "gamma",
     "beta", "exponential", "bernoulli", "binomial", "dirichlet",
     "multivariate_normal", "laplace", "logistic", "gumbel", "pareto",
     "power", "rayleigh", "weibull", "lognormal", "chisquare", "f",
     "standard_normal", "standard_cauchy", "standard_exponential",
     "shuffle"), "float32")
_DTYPES.update(randint="int32", poisson="int32", negative_binomial="int32",
               generalized_negative_binomial="int32", multinomial="float64")
#: samplers whose shape and dtype are also drawn from the JAX package
#: here (the others compile a gamma or a categorical draw, seconds each);
#: its binomial raises for every input (its creation wrapper hands
#: jax.random.binomial an int32 dtype), so the port's float is its own
_CROSS = {"np.random.uniform", "np.random.normal", "np.random.randint",
          "np.random.bernoulli", "nd.random.normal"}


def _jax_array(a):
    return jmx.np.array(a, dtype=a.dtype)


def _run(mx, case, make):
    args, kw = sc.materialize(case, DATA, make)
    out = sc.function_of(mx, case.key)(*args, **kw)
    return args[0] if case.kind == "sample_inplace" else out


def test_shapes_and_dtypes():
    """Every sampler's shape and dtype: the sizes the cases ask for, the
    dtypes of :data:`_DTYPES`; those of :data:`_CROSS` drawn from the JAX
    package too."""
    bad = []
    for case in sc.CASES:
        if not case.key.startswith(("np.random.", "random.", "nd.random.")):
            continue
        with mt.cpu():
            out = _run(mt, case, lambda a: mt.np.array(a, dtype=a.dtype))
        name = case.key.rsplit(".", 1)[1]
        leaves = sc.host_leaves(out)
        if name not in ("multinomial",) or case.key.startswith("np"):
            if str(leaves[0].dtype) != _DTYPES.get(name, "int32"):
                bad.append((case.key, leaves[0].dtype))
        size = case.kwargs.get("size", case.kwargs.get("shape"))
        if isinstance(size, tuple) and name not in (
                "multinomial", "dirichlet", "multivariate_normal"):
            if leaves[0].shape != size:
                bad.append((case.key, leaves[0].shape, size))
        if case.key in _CROSS:
            jout = _run(jmx, case, _jax_array)
            ja = sc.host_leaves(jout)[0]
            if (ja.shape, ja.dtype) != (leaves[0].shape, leaves[0].dtype):
                bad.append((case.key, ja.shape, ja.dtype,
                            leaves[0].shape, leaves[0].dtype))
    assert not bad, bad


#: (sampler over (mx, array parameter p of shape (2,)), its shape)
_BROADCASTS = [
    (lambda mx, p: mx.np.random.normal(p, 1.0), (2,)),
    (lambda mx, p: mx.np.random.normal(p[None], p[:, None] + 2.0), (2, 2)),
    (lambda mx, p: mx.np.random.exponential(p, size=(3, 2)), (3, 2)),
    (lambda mx, p: mx.npx.random.normal_n(p, 1.0, shape=(4,)), (4, 2)),
    (lambda mx, p: mx.npx.random.uniform_n(p, p + 1.0, shape=(3,)), (3, 2)),
    (lambda mx, p: mx.npx.random.bernoulli(p / 4.0), (2,)),
    (lambda mx, p: mx.nd.sample_normal(p, p, shape=(3, 4)), (2, 3, 4)),
    (lambda mx, p: mx.nd.sample_exponential(p, shape=3), (2, 3)),
]


def test_parameter_broadcasting():
    """Array parameters broadcast as in the JAX package (``size=None``:
    the parameters' shape; ``shape=`` of ``normal_n`` in front, of the
    legacy ``sample_*`` behind)."""
    p = DATA["pos2"]
    bad = []
    for i, (call, want) in enumerate(_BROADCASTS):
        jout = call(jmx, _jax_array(p))
        with mt.cpu():
            tout = call(mt, mt.np.array(p))
        if not (jout.shape == tout.shape == want
                and jout.dtype == tout.dtype):
            bad.append((i, jout.shape, tout.shape, jout.dtype, tout.dtype))
    assert not bad, bad


_N = 100_000
#: sampler -> (scipy distribution); every sampler draws _N values
_MOMENTS = [
    (lambda r: r.uniform(-1.0, 3.0, size=_N), st.uniform(-1, 4)),
    (lambda r: r.normal(2.0, 0.5, size=_N), st.norm(2, 0.5)),
    (lambda r: r.gamma(2.5, 1.5, size=_N), st.gamma(2.5, scale=1.5)),
    (lambda r: r.beta(2.0, 3.0, size=_N), st.beta(2, 3)),
    (lambda r: r.exponential(2.0, size=_N), st.expon(scale=2)),
    (lambda r: r.poisson(3.0, size=_N), st.poisson(3)),
    (lambda r: r.binomial(10.0, 0.3, size=_N), st.binom(10, 0.3)),
    (lambda r: r.negative_binomial(3, 0.4, size=_N), st.nbinom(3, 0.4)),
    (lambda r: r.laplace(1.0, 2.0, size=_N), st.laplace(1, 2)),
    (lambda r: r.logistic(0.5, 1.5, size=_N), st.logistic(0.5, 1.5)),
    (lambda r: r.gumbel(0.0, 2.0, size=_N), st.gumbel_r(0, 2)),
    (lambda r: r.pareto(5.0, size=_N), st.lomax(5)),
    (lambda r: r.power(3.0, size=_N), st.powerlaw(3)),
    (lambda r: r.rayleigh(2.0, size=_N), st.rayleigh(scale=2)),
    (lambda r: r.weibull(1.5, size=_N), st.weibull_min(1.5)),
    (lambda r: r.lognormal(0.0, 0.25, size=_N), st.lognorm(0.25)),
    (lambda r: r.chisquare(3.0, size=_N), st.chi2(3)),
    (lambda r: r.f(8.0, 20.0, size=_N), st.f(8, 20)),
    (lambda r: r.bernoulli(0.3, size=_N), st.bernoulli(0.3)),
    (lambda r: r.randint(0, 10, size=_N), st.randint(0, 10)),
    (lambda r: r.choice(6, size=_N), st.randint(0, 6)),
    (lambda r: r.standard_exponential(size=_N), st.expon()),
    (lambda r: r.standard_normal(size=_N), st.norm()),
    (lambda r: mt.nd.random.generalized_negative_binomial(
        2.0, 0.5, shape=_N), st.nbinom(2.0, 0.5)),
    (lambda r: mt.npx.random.normal_n(1.0, 3.0, shape=(_N,)),
     st.norm(1, 3)),
]


def _within(label, draws, dist):
    """None when the mean and the variance of ``draws`` lie within five
    standard errors of ``dist``'s."""
    x = onp.asarray(draws, dtype="f8").reshape(-1)
    n = x.size
    mean, var, _, kurt = (float(v) for v in dist.stats(moments="mvsk"))
    se_mean = (var / n) ** 0.5
    se_var = ((kurt + 2.0) * var * var / n) ** 0.5
    if abs(x.mean() - mean) > 5 * se_mean:
        return f"{label}: mean {x.mean():.5g} vs {mean:.5g}"
    if abs(x.var() - var) > 5 * se_var:
        return f"{label}: variance {x.var():.5g} vs {var:.5g}"
    return None


def test_draws_follow_their_distributions():
    bad = []
    mt.random.seed(2024)
    with mt.cpu():
        for i, (draw, dist) in enumerate(_MOMENTS):
            err = _within(f"sampler {i} ({dist.dist.name})",
                          draw(mt.np.random).asnumpy(), dist)
            if err:
                bad.append(err)
        cauchy = onp.sort(mt.np.random.standard_cauchy(size=_N).asnumpy())
        quartiles = cauchy[[_N // 4, _N // 2, 3 * _N // 4]]
        if not onp.allclose(quartiles, [-1.0, 0.0, 1.0], atol=0.03):
            bad.append(f"cauchy quartiles {quartiles}")
        # the multivariate samplers and the per-row legacy ones
        p = mt.np.array(DATA["p4"])
        counts = mt.np.random.multinomial(10, p, size=(_N // 10,)).asnumpy()
        if not onp.allclose(counts.mean(0), 10 * DATA["p4"], atol=0.03):
            bad.append(f"multinomial means {counts.mean(0)}")
        alpha = onp.array([1.0, 2.0, 3.0], "f")
        dirich = mt.np.random.dirichlet(mt.np.array(alpha),
                                        size=(_N,)).asnumpy()
        if not onp.allclose(dirich.mean(0), alpha / 6, atol=3e-3):
            bad.append(f"dirichlet means {dirich.mean(0)}")
        cov = DATA["mvn_cov"]
        mvn = mt.np.random.multivariate_normal(
            mt.np.zeros(3), mt.np.array(cov), size=(_N,)).asnumpy()
        if not onp.allclose(onp.cov(mvn.T), cov, rtol=0.03, atol=0.03):
            bad.append("multivariate_normal covariance")
        rows = mt.nd._internal._sample_gamma(
            mt.np.array(DATA["pos2"]), mt.np.array(DATA["pos2b"]),
            shape=_N // 10).asnumpy()
        for k, a, b in zip(range(2), DATA["pos2"], DATA["pos2b"]):
            err = _within(f"_sample_gamma row {k}", rows[k],
                          st.gamma(a, scale=b))
            if err:
                bad.append(err)
        idx = mt.nd._internal._sample_multinomial(
            mt.np.array(DATA["probs"]), shape=_N // 10).asnumpy()
        freq = onp.stack([onp.bincount(r, minlength=4) for r in idx]) \
            / (_N // 10)
        if not onp.allclose(freq, DATA["probs"], atol=0.02):
            bad.append(f"_sample_multinomial {freq}")
        classes, trials = mt.nd._internal._sample_unique_zipfian(
            1000, shape=(4, 50))
        c = classes.asnumpy()
        if not (all(len(set(r)) == 50 for r in c) and c.min() >= 0
                and c.max() < 1000 and (trials.asnumpy() >= 50).all()):
            bad.append("_sample_unique_zipfian")
    assert not bad, bad


def test_draws_follow_the_device():
    """A draw is made where its parameters lie, else on the current
    device: inside ``with cpu()`` on the CPU, outside any scope on
    ``cuda:0`` (so here, without a card, it raises rather than falling
    back to the CPU)."""
    p = mt.np.array(DATA["pos2"], device=mt.cpu())
    assert mt.np.random.gamma(p).device == mt.cpu()
    assert mt.nd.random.poisson(p, shape=None).device == mt.cpu()
    with mt.cpu():
        assert mt.random.normal(size=(2,)).device == mt.cpu()
    if not mt.num_gpus():
        with pytest.raises(mt.MXNetError):
            mt.np.random.uniform(size=(2,))
    # mx.random.seed replays every stream; npx.random shares it
    with mt.cpu():
        mt.random.seed(5)
        a = mt.npx.random.bernoulli(0.5, size=(64,)).asnumpy()
        mt.npx.random.seed(5)
        b = mt.npx.random.bernoulli(0.5, size=(64,)).asnumpy()
    assert onp.array_equal(a, b)


def test_densities():
    """``_random_pdf_*`` against the JAX package's, log and not."""
    bad = []
    for case in sc.CASES:
        if not case.key.startswith("_random_pdf_"):
            continue
        for is_log in (False, True):
            kw = dict(case.kwargs, is_log=is_log)
            args, _ = sc.materialize(case, DATA, _jax_array)
            jout = sc.function_of(jmx, case.key)(*args, **kw)
            args, _ = sc.materialize(
                case, DATA, lambda a: mt.np.array(a, device=mt.cpu()))
            tout = sc.function_of(mt, case.key)(*args, **kw)
            err = mismatch(f"{case.key} is_log={is_log}", jout, tout)
            if err:
                bad.append(err)
    assert not bad, bad
