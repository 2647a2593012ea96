"""The small top-level modules of ROADMAP queue 1 item 4 (``util``,
``test_utils``, ``context``/``Context``/``Device``/``cpu_pinned``,
``name``, ``attribute``, ``error``, ``registry``, ``log``), each held
against the JAX package's on the CPU: the same calls give the same names,
attributes, classes, verdicts and values."""
import builtins
import logging

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt

_MODULES = ("util", "test_utils", "context", "name", "attribute", "error",
            "registry", "log")


def test_the_top_level_names_exist():
    for name in _MODULES + ("Context", "Device", "cpu_pinned", "num_tpus",
                            "NameManager", "AttrScope", "ndarray", "base",
                            "device"):
        assert hasattr(mt, name), name
    for mod in _MODULES:
        jnames = {n for n in getattr(getattr(jmx, mod), "__all__", ())}
        lacks = sorted(n for n in jnames
                       if not hasattr(getattr(mt, mod), n))
        assert not lacks, (mod, lacks)


def test_devices_and_contexts():
    assert mt.Context is mt.Device is mt.context.Context
    assert mt.Device("gpu", 1) == torch.device("cuda", 1)
    assert mt.Device("cpu") == mt.cpu() and mt.Device(mt.cpu()) == mt.cpu()
    assert isinstance(mt.cpu(), mt.Device) and isinstance(
        mt.cpu_pinned(), mt.Context)
    assert mt.context.current_context is mt.current_device
    assert mt.num_tpus() == 0
    with pytest.raises(mt.MXNetError):
        mt.Device("tpu")
    with mt.cpu_pinned():
        assert mt.current_device() == mt.cpu()
    with mt.cpu():
        x = mt.np.array([1.0, 2.0], ctx=mt.cpu_pinned())
        assert x.device.type == "cpu"
        assert x.as_in_ctx(mt.cpu_pinned()) is x
        onp.testing.assert_array_equal(
            mt.np.array([3.0]).copyto(mt.cpu_pinned()).asnumpy(), [3.0])


def test_name_and_attribute_scopes():
    outs = []
    for pkg in (mt, jmx):
        with pkg.name.Prefix("net_") as p, pkg.AttrScope(group="a"):
            with pkg.attribute.AttrScope(stage="1"):
                attrs = pkg.attribute.current().get({"x": "y"})
            outs.append((p.get(None, "conv"), p.get(None, "conv"),
                         p.get("given", "fc"), attrs,
                         pkg.attribute.current().get()))
        mgr = pkg.NameManager()
        outs[-1] += (mgr.get(None, "fc"), mgr.get(None, "fc"))
        with pytest.raises(ValueError):
            pkg.AttrScope(n=1)
    assert outs[0] == outs[1]


def test_errors_registry_and_log(tmp_path):
    for name in ("InternalError", "ValueError", "TypeError", "IndexError"):
        cls = getattr(mt.error, name)
        assert issubclass(cls, mt.MXNetError)
        jcls = getattr(jmx.error, name)
        builtin = getattr(builtins, name, None)
        if builtin is not None:
            assert issubclass(cls, builtin) == issubclass(jcls, builtin)
    assert str(mt.error.NotImplementedForSymbol(len)) == str(
        jmx.error.NotImplementedForSymbol(len))
    made = []
    for pkg in (mt, jmx):
        class Base:
            def __init__(self, k=0):
                self.k = k

        register = pkg.registry.get_register_func(Base, "thing")
        alias = pkg.registry.get_alias_func(Base, "thing")
        create = pkg.registry.get_create_func(Base, "thing")

        @alias("other")
        class Sub(Base):
            pass

        register(Sub)
        made.append((type(create("sub", k=3)).__name__,
                     create('["OTHER", {"k": 5}]').k,
                     sorted(pkg.registry.get_registry(Base))))
        with pytest.raises(ValueError):
            create("none")
    assert made[0] == made[1]
    for pkg in (mt, jmx):
        f = tmp_path / f"{pkg.__name__}.log"
        log = pkg.log.get_logger(f"t19_{pkg.__name__}", filename=str(f),
                                 level=pkg.log.INFO)
        log.info("hello")
        log = pkg.log.getLogger(f"t19_{pkg.__name__}", filename=str(f))
        assert len(log.handlers) == 1 and log.level == logging.WARNING
        for h in log.handlers:
            h.close()
        assert "hello" in f.read_text()


def test_util_and_test_utils():
    fn = mt.util.wrap_ctx_to_device_func(lambda device=None: device)
    assert fn(ctx="x") == "x" == jmx.util.wrap_ctx_to_device_func(
        lambda device=None: device)(ctx="x")
    for pkg in (mt, jmx):
        with pkg.util.np_array(False):
            assert not pkg.util.is_np_array() and pkg.util.is_np_shape()
        with pkg.util.np_shape(False):
            assert not pkg.util.is_np_shape()
        assert pkg.util.is_np_array()
    assert mt.util.get_gpu_count() == 0 and mt.util.get_gpu_memory() == (0, 0)
    tu, ju = mt.test_utils, jmx.test_utils
    a = onp.array([1.0, 2.0, 3.0], "float32")
    with mt.cpu():
        x = mt.np.array(a)
        for b in (a + 1e-6, a + 1e-3):
            assert tu.almost_equal(x, b) == ju.almost_equal(a, b)
        tu.assert_almost_equal(x, a + 1e-6)
        with pytest.raises(AssertionError):
            tu.assert_almost_equal(x, a + 1e-2)
        assert tu.same(x, a) and not tu.same(x, a + 1)
        assert tu.default_rtol_atol(x.astype("bfloat16")) == (3e-2, 1e-2)
        onp.random.seed(0)
        r = tu.rand_ndarray((3, 4), "float64", low=2.0, high=3.0)
        assert r.dtype == onp.float64 and r.device == mt.cpu()
        assert 2.0 <= r.asnumpy().min() and r.asnumpy().max() < 3.0
        tu.check_numeric_gradient(lambda v: (v * v * v).sum(),
                                  [onp.array([0.5, -1.0], "float32")])
        with pytest.raises(AssertionError):
            tu.check_numeric_gradient(
                lambda v: mt.np.where(v > 0, v, v).sum() * 2.0
                + mt.npx.stop_gradient(v).sum(),
                [onp.array([0.5, -1.0], "float32")])
        got = tu.check_consistency(lambda v: v * 2 + 1, [a],
                                   devices=[mt.cpu(), mt.cpu()])
    onp.testing.assert_array_equal(got, a * 2 + 1)
    # the generator harness on the port's sampler, against scipy's normal
    import scipy.stats as ss

    buckets, probs = tu.gen_buckets_probs_with_ppf(ss.norm.ppf, 5)
    assert (buckets, probs) == ju.gen_buckets_probs_with_ppf(ss.norm.ppf, 5)
    with mt.cpu():
        mt.random.seed(3)
        pvals = tu.verify_generator(
            lambda n: mt.np.random.normal(size=(n,)), buckets, probs,
            nsamples=3000, nrepeat=2)
    assert len(pvals) == 2
    with pytest.raises(AssertionError):   # all mass in one bucket
        tu.verify_generator(lambda n: onp.full(n, 5.0), buckets, probs,
                            nsamples=1000, nrepeat=2)
    with pytest.raises(AssertionError):   # mass outside every bucket
        tu.chi_square_check(lambda n: onp.full(n, 5.0), [(0.0, 1.0)], [1.0],
                            nsamples=1000)
