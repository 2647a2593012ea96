"""``quantize_net`` against the JAX package's on the CPU: the reference
test's small net (tests/test_quantization.py:_net) and ``resnet18_v1(
classes=10)`` at 2x3x32x32, with the JAX net's weights carried by
``convert.load_jax_params``, calibrated on the same batches in 'naive' and
'entropy' mode. Held: the per-layer calibrated ranges within 1e-5
relative (the layers' inputs come from each package's f32 forward, which
differ in the last bits); the same children swapped, ``exclude_layers``;
the int8 codes of every quantized layer's input, each package quantizing
its own f32 input, counted where they differ: at most 0.1 % of a layer's
codes, by one (measured: none); the int8 logits within 1e-4 of the
largest logit (measured: equal for the small net, ResNet-18 within
6.3e-7); then the port's copy of ``example/quantize_int8.py`` on the CPU.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon.model_zoo.vision import resnet18_v1 as jresnet18
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1 as tresnet18
from mxnet_tpu_torch.tools import quantize_int8


def _small_net(m):
    net = m.gluon.nn.HybridSequential()
    net.add(m.gluon.nn.Conv2D(8, 3, padding=1, activation="relu"),
            m.gluon.nn.GlobalAvgPool2D(),
            m.gluon.nn.Flatten(),
            m.gluon.nn.Dense(32, activation="relu"),
            m.gluon.nn.Dense(10))
    return net


def _pair(make, x):
    """The JAX net (``mx.seed(0)``, initialized, one forward) and the port's
    with its weights, on the CPU."""
    jmx.seed(0)
    jnet = make(jmx)
    jnet.initialize()
    jnet(jmx.np.array(x))
    with mt.cpu():
        tnet = make(mt)
        tnet.initialize(device=mt.cpu())
        tnet(mt.np.array(x))
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    return tnet, jnet


def _quantized(net, children):
    out = {}

    def walk(block, prefix):
        for name, child in children(block).items():
            full = f"{prefix}.{name}" if prefix else name
            if type(child).__name__.startswith("Quantized"):
                out[full] = child
            else:
                walk(child, full)

    walk(net, "")
    return out


def _input_codes(layers, run, as_numpy):
    """Each quantized layer's input during ``run()``, as numpy."""
    seen = {}

    def hook(name):
        def fn(block, inputs, out):  # noqa: ARG001
            seen[name] = as_numpy(inputs[0])
        return fn

    handles = [layer.register_forward_hook(hook(name))
               for name, layer in layers.items()]
    out = run()
    for h in handles:
        if hasattr(h, "remove"):
            h.remove()
    return out, seen


def _code_flips(tl, tin, jin):
    """The share of each layer's int8 input codes that differ between the
    packages (each quantizing its own f32 input with its range), and the
    largest difference."""
    import jax.numpy as jnp
    from mxnet_tpu_torch.kernels import int8 as kint8

    flips = {}
    for name, layer in tl.items():
        lo, hi = layer._out_range
        jx = jnp.clip(jnp.asarray(jin[name]), jnp.float32(lo),
                      jnp.float32(hi))
        jcodes = onp.asarray(jq._q(jx, jnp.float32(lo), jnp.float32(hi))[0])
        tcodes = kint8.quantize(torch.from_numpy(tin[name]), layer._lohi,
                                clip=True)[0].numpy()
        diff = onp.abs(tcodes.astype(int) - jcodes.astype(int))
        flips[name] = ((diff > 0).mean(), diff.max())
    return flips


def _quantize_both(make, x, calib, mode, **kwargs):
    tnet, jnet = _pair(make, x)
    with mt.cpu():
        tq.quantize_net(tnet, calib_data=[mt.np.array(c) for c in calib],
                        calib_mode=mode, **kwargs)
    jq.quantize_net(jnet, calib_data=[jmx.np.array(c) for c in calib],
                    calib_mode=mode, **kwargs)
    tl = _quantized(tnet, lambda b: b._modules)
    jl = _quantized(jnet, lambda b: b._children)
    assert list(tl) == list(jl)
    assert [type(v).__name__ for v in tl.values()] == \
        [type(v).__name__ for v in jl.values()]
    for name in tl:
        t, j = tl[name]._out_range, jl[name]._out_range
        onp.testing.assert_allclose(t, j, rtol=1e-5, err_msg=name)
        onp.testing.assert_array_equal(tl[name]._wq.numpy(), jl[name]._wq)
    with mt.cpu():
        got, tin = _input_codes(
            tl, lambda: tnet(mt.np.array(x)).asnumpy(),
            lambda a: a.detach().numpy())
    want, jin = _input_codes(
        jl, lambda: onp.asarray(jnet(jmx.np.array(x)).asnumpy()),
        lambda a: onp.asarray(a.asnumpy()))
    for layer in jl.values():
        layer._fwd_hooks.clear()
    return tnet, jnet, got, want, tl, _code_flips(tl, tin, jin)


def _check_logits(got, want, flips):
    for name, (share, largest) in flips.items():
        assert share <= 1e-3 and largest <= 1, (name, share, largest)
    assert got.shape == want.shape and onp.isfinite(got).all()
    onp.testing.assert_allclose(got, want, rtol=0,
                                atol=1e-4 * onp.abs(want).max())


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_small_net_quantized_like_the_reference(mode):
    x = onp.random.RandomState(0).uniform(-1, 1, (4, 3, 8, 8)).astype("f")
    _, _, got, want, layers, flips = _quantize_both(_small_net, x, [x],
                                                    mode)
    assert sorted(type(v).__name__ for v in layers.values()) == [
        "QuantizedConv2D", "QuantizedDense", "QuantizedDense"]
    _check_logits(got, want, flips)


def test_children_exclude_layers_and_cached_graphs():
    x = onp.random.RandomState(1).uniform(0, 1, (2, 3, 8, 8)).astype("f")
    tnet, jnet = _pair(_small_net, x)
    tnet._served.graphs["stale"] = None    # a graph of the fp32 forward
    with mt.cpu():
        tq.quantize_net(tnet, calib_data=[mt.np.array(x)],
                        exclude_layers=["4"])
        tnet.hybridize()
        y1, y2 = (tnet(mt.np.array(x)).asnumpy() for _ in range(2))
    jq.quantize_net(jnet, calib_data=[jmx.np.array(x)], exclude_layers=["4"])
    assert [type(c).__name__ for c in tnet._modules.values()] == \
        [type(c).__name__ for c in jnet._children.values()] == [
            "QuantizedConv2D", "GlobalAvgPool2D", "Flatten", "QuantizedDense",
            "Dense"]
    assert not tnet._served.graphs
    onp.testing.assert_array_equal(y1, y2)
    qd = tnet._modules["3"]
    assert qd._wq.dtype == torch.int8 and tuple(qd._wscale.shape) == (32,)
    assert tnet.device == torch.device("cpu")


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_resnet18_quantized_like_the_reference(mode):
    rs = onp.random.RandomState(2)
    x = rs.uniform(0, 1, (2, 3, 32, 32)).astype("f")
    calib = [rs.uniform(0, 1, (2, 3, 32, 32)).astype("f") for _ in range(2)]
    tnet, jnet, got, want, layers, flips = _quantize_both(
        lambda m: (jresnet18 if m is jmx else tresnet18)(classes=10), x,
        calib, mode)
    assert len(layers) == 21
    assert sum(type(v).__name__ == "QuantizedDense"
               for v in layers.values()) == 1
    assert got.shape == (2, 10)
    _check_logits(got, want, flips)


def test_quantize_int8_tool_on_cpu():
    """The example at 60 iterations: the fp32 net trains, int8 keeps its
    accuracy within 0.05 (the tool's own gate), in both modes."""
    out = quantize_int8.run(iters=60, device=mt.cpu())
    assert out["fp32_acc"] >= 0.9
    assert out["int8_acc"] >= out["fp32_acc"] - 0.05
    res = quantize_int8.main(["--cpu", "--iters", "60", "--calib-mode",
                              "entropy"])
    assert res["int8_acc"] >= res["fp32_acc"] - 0.05
    assert any(type(c).__name__ == "QuantizedConv2D"
               for c in res["net"]._modules.values())
