"""The slice as a whole on the CPU: a narrow ResNet v1 written once in the
legacy op vocabulary as a function of the ``mx`` module (``mx.nd.
Convolution``, ``BatchNorm``, ``Activation``, ``Pooling``, ``Flatten``,
``FullyConnected``, ``SoftmaxOutput``), trained by ``mx.nd.sgd_mom_update``
(``out=`` the weight) for two steps in both packages from the same numpy
weights and batch: the class probabilities, every gradient, every
weight, momentum and moving statistic after each step.

The net: a 3x3 stem of 8 channels, BatchNorm, ReLU, a basic block of 8
channels, a basic block of 16 channels with stride 2 and a projection
shortcut, a global average pool and a dense head of 10 classes; batch 4
of 3x16x16. (No max pool after the stem: each activation shape costs the
JAX package's eager ops a compile of their own.)

Tolerance: f32 within 1e-5 relative (plus 1e-6 absolute).
"""
import numpy as onp

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from test_torch_registry_coverage import mismatch

BATCH, CLASSES = 4, 10


def _weights(seed=0):
    rs = onp.random.RandomState(seed)

    def conv(o, i, k):
        return (rs.normal(0, (2.0 / (i * k * k)) ** 0.5, (o, i, k, k))
                .astype("f"))

    def bn(prefix, c):
        return {f"{prefix}_g": rs.uniform(0.8, 1.2, c).astype("f"),
                f"{prefix}_b": rs.uniform(-0.1, 0.1, c).astype("f"),
                f"{prefix}_m": onp.zeros(c, "f"),
                f"{prefix}_v": onp.ones(c, "f")}

    w = {"stem_w": conv(8, 3, 3), **bn("stem", 8),
         "s1a_w": conv(8, 8, 3), **bn("s1a", 8),
         "s1b_w": conv(8, 8, 3), **bn("s1b", 8),
         "s2a_w": conv(16, 8, 3), **bn("s2a", 16),
         "s2b_w": conv(16, 16, 3), **bn("s2b", 16),
         "s2p_w": conv(16, 8, 1), **bn("s2p", 16),
         "fc_w": rs.normal(0, 0.1, (CLASSES, 16)).astype("f"),
         "fc_b": onp.zeros(CLASSES, "f")}
    x = rs.uniform(-1, 1, (BATCH, 3, 16, 16)).astype("f")
    y = rs.randint(0, CLASSES, BATCH).astype("f")
    return w, x, y


def _conv_bn(mx, p, name, h, channels, stride=1, kernel=3, relu=True):
    nd = mx.nd
    pad = (kernel // 2,) * 2
    h = nd.Convolution(h, p[f"{name}_w"], kernel=(kernel, kernel),
                       stride=(stride, stride), pad=pad,
                       num_filter=channels, no_bias=True)
    h = nd.BatchNorm(h, p[f"{name}_g"], p[f"{name}_b"], p[f"{name}_m"],
                     p[f"{name}_v"], fix_gamma=False, eps=1e-5)
    return nd.Activation(h, act_type="relu") if relu else h


def resnet_v1(mx, p, x, y):
    """The net's class probabilities, as ``SoftmaxOutput`` returns them
    (its backward is the cross entropy's, whatever the head)."""
    nd = mx.nd
    h = _conv_bn(mx, p, "stem", x, 8)
    r = _conv_bn(mx, p, "s1a", h, 8)
    h = nd.Activation(_conv_bn(mx, p, "s1b", r, 8, relu=False) + h,
                      act_type="relu")
    r = _conv_bn(mx, p, "s2a", h, 16, stride=2)
    short = _conv_bn(mx, p, "s2p", h, 16, stride=2, kernel=1, relu=False)
    h = nd.Activation(_conv_bn(mx, p, "s2b", r, 16, relu=False) + short,
                      act_type="relu")
    h = nd.Flatten(nd.Pooling(h, kernel=(1, 1), global_pool=True,
                              pool_type="avg"))
    return nd.SoftmaxOutput(nd.FullyConnected(h, p["fc_w"], p["fc_b"],
                                              num_hidden=CLASSES), y)


def _train(mx, steps=2):
    w, x, y = _weights()
    kw = {} if mx is jmx else dict(device=mt.cpu())
    p = {k: mx.np.array(v, **kw) for k, v in w.items()}
    trained = [k for k in p if not k.endswith(("_m", "_v"))]
    moms = {k: mx.np.zeros(p[k].shape, **kw) for k in trained}
    for k in trained:
        p[k].attach_grad()
    data, label = mx.np.array(x, **kw), mx.np.array(y, **kw)
    record = []
    for _ in range(steps):
        with mx.autograd.record():
            prob = resnet_v1(mx, p, data, label)
        prob.backward()
        grads = {k: p[k].grad.copy() for k in trained}
        for k in trained:
            mx.nd.sgd_mom_update(p[k], p[k].grad, moms[k], lr=0.1,
                                 momentum=0.9, wd=1e-4, out=p[k])
        record.append(dict(prob=prob, **{f"d{k}": g for k, g in
                                         grads.items()},
                           **{k: v.copy() for k, v in p.items()},
                           **{f"mom_{k}": m.copy() for k, m in
                              moms.items()}))
    return record


def test_two_sgd_momentum_steps_in_the_legacy_vocabulary():
    want, got = _train(jmx), _train(mt)
    bad = []
    for step, (a, b) in enumerate(zip(want, got)):
        for key in a:
            err = mismatch(f"step {step} {key}", a[key], b[key])
            if err:
                bad.append(err)
    assert not bad, bad
    loss = -onp.log(got[0]["prob"].asnumpy()[
        onp.arange(BATCH), _weights()[2].astype(int)]).mean()
    assert onp.isfinite(loss)
