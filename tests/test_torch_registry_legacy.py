"""The registry's layer ops (ops/legacy.py's CamelCase ops and ops/nn.py's
registrations) against the JAX package's, on the CPU from the same numpy
inputs: forward over the sweep table's cases, backward over a table of
the differentiable ones, and the cases the port must keep exactly:
BatchNorm with ``fix_gamma`` both ways, ``output_mean_var`` and
``use_global_stats``; SoftmaxOutput with ``ignore_label``, ``use_ignore``,
``grad_scale`` and ``normalization``; the stateful ``mx.nd.BatchNorm`` /
``mx.npx.batch_norm`` (moving statistics written in place while
training).

Tolerance: f32 within 1e-5 relative (plus 1e-6 absolute near zero); the
two frameworks sum in different orders.
"""
import numpy as onp

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import _sweep_cases as sc
from test_torch_registry_coverage import (grads_batch, jax_batch,
                                          jax_call, mismatch, port_call)

_NN = {"fully_connected", "convolution", "deconvolution", "pooling",
       "batch_norm", "_contrib_SyncBatchNorm", "layer_norm", "group_norm",
       "GroupNorm", "instance_norm", "rms_norm", "lrn", "softmax",
       "log_softmax", "softmin", "activation", "leaky_relu", "embedding",
       "one_hot", "pick", "topk", "sequence_mask", "sequence_last",
       "sequence_reverse", "l2_normalization", "upsampling", "moments"}
_LEGACY = {"Convolution", "Deconvolution", "FullyConnected", "Pooling",
           "BatchNorm", "LayerNorm", "InstanceNorm", "L2Normalization",
           "Activation", "LeakyReLU", "SoftmaxActivation", "Embedding",
           "Concat", "Flatten", "Reshape", "Cast", "SwapAxis",
           "SequenceLast", "SequenceMask", "SequenceReverse", "UpSampling",
           "LRN", "SliceChannel", "Pad", "Dropout",
           "IdentityAttachKLSparseReg"}
DATA = sc.inputs(0)


def _numpy_case(case):
    return sc.materialize(case, DATA, lambda a: a)


def test_forward_over_the_sweep_cases():
    cases = [c for c in sc.CASES
             if c.key in _NN | _LEGACY and c.kind == "det"]
    calls = [(c.key, *_numpy_case(c)) for c in cases]
    bad = [mismatch(c.key, j, port_call(*call), check=c.check)
           for c, call, j in zip(cases, calls, jax_batch(calls))]
    assert not any(bad), [b for b in bad if b]


#: (op, positional numpy args, kwargs, indices of the args to
#: differentiate)
_GRADS = [
    ("Convolution", ("x4", "w_conv", "b4"), dict(kernel=(3, 3), pad=(1, 1),
                                               stride=(2, 2)), (0, 1, 2)),
    ("Deconvolution", ("x4", "w_deconv"), dict(kernel=(3, 3),
                                               stride=(2, 2)), (0, 1)),
    ("FullyConnected", ("x4", "w_fc4", "b_fc"), dict(num_hidden=6),
     (0, 1, 2)),
    ("Pooling", ("x4",), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                              pool_type="avg"), (0,)),
    ("Pooling", ("x4",), dict(kernel=(2, 2), stride=(2, 2)), (0,)),
    ("LayerNorm", ("x2", "g5", "b5"), {}, (0, 1, 2)),
    ("InstanceNorm", ("x4", "g3", "b3"), {}, (0, 1, 2)),
    ("group_norm", ("x4b", "g4", "bt4"), dict(num_groups=2), (0, 1, 2)),
    ("rms_norm", ("x2", "g5"), {}, (0, 1)),
    ("LRN", ("x4",), dict(nsize=3), (0,)),
    ("softmin", ("x2",), {}, (0,)),
    ("log_softmax", ("x2",), dict(axis=0), (0,)),
    ("L2Normalization", ("x4",), dict(mode="spatial"), (0,)),
    ("UpSampling", ("x4",), dict(scale=2, sample_type="bilinear"), (0,)),
    ("pick", ("x2", "label"), {}, (0,)),
    ("LeakyReLU", ("x2", "g5"), dict(act_type="prelu"), (0, 1)),
    ("LeakyReLU", ("x2",), dict(act_type="selu"), (0,)),
    ("Embedding", ("idx", "emb"), {}, (1,)),
    ("SequenceMask", ("seq", "seqlen"), dict(use_sequence_length=True),
     (0,)),
    ("SequenceReverse", ("seq", "seqlen"), dict(use_sequence_length=True),
     (0,)),
    ("topk", ("x2",), dict(k=2, ret_typ="value"), (0,)),
    ("moments", ("x4",), dict(axes=(0, 2, 3)), (0,)),
]


def _arrays(names):
    data = dict(DATA, w_fc4=DATA["w_fc"].repeat(108 // 5 + 1, 1)[:, :108])
    return tuple(data[n] for n in names)


def test_backward_of_the_differentiable_ops():
    bad = []
    results = grads_batch([(key, _arrays(names), kw, wrt)
                           for key, names, kw, wrt in _GRADS])
    for (key, names, _, wrt), (jout, jg, tout, tg) in zip(_GRADS, results):
        bad.append(mismatch(key, jout, tout))
        bad += [mismatch(f"{key} d{names[i]}", a, b)
                for i, a, b in zip(wrt, jg, tg)]
    assert not any(bad), [b for b in bad if b]


_BN = ("x4", "g3", "b3", "m3", "v3")


#: BatchNorm's variants: fix_gamma (the default), gamma, output_mean_var,
#: use_global_stats, another eps and momentum
_BN_VARIANTS = [
    dict(), dict(fix_gamma=False), dict(fix_gamma=False,
                                        output_mean_var=True),
    dict(use_global_stats=True, fix_gamma=False),
    dict(fix_gamma=False, eps=1e-5, momentum=0.5, output_mean_var=True)]


def test_legacy_batch_norm():
    """The registry's pure BatchNorm (legacy.py:62): ones for gamma under
    ``fix_gamma``, eps 1e-3, batch statistics unless
    ``use_global_stats``; forward, and the gradients of x, gamma and
    beta, in each of :data:`_BN_VARIANTS`."""
    results = grads_batch([("BatchNorm", _arrays(_BN), kw, (0, 1, 2))
                           for kw in _BN_VARIANTS])
    bad = []
    for kw, (jout, jg, tout, tg) in zip(_BN_VARIANTS, results):
        bad.append(mismatch(f"BatchNorm {kw}", jout, tout))
        bad += [mismatch(f"{name} {kw}", a, b, rtol=2e-5, atol=2e-6)
                for name, a, b in zip(("dx", "dgamma", "dbeta"), jg, tg)]
    assert not any(bad), [b for b in bad if b]


#: SoftmaxOutput's variants
_SM_VARIANTS = [
    dict(), dict(grad_scale=0.25), dict(use_ignore=True, ignore_label=2),
    dict(normalization="batch", grad_scale=2.0),
    dict(normalization="valid", use_ignore=True, ignore_label=0)]


def test_softmax_output():
    """Softmax forward; backward ``(p - onehot) * grad_scale`` (rows of
    the ignored label zeroed), whatever the head gradient: the head
    gradient is random, and both packages ignore it. Each of
    :data:`_SM_VARIANTS`, over (N, C) and (N, C, H, W) data."""
    calls = [("SoftmaxOutput", _arrays(names), kw, (0,))
             for kw in _SM_VARIANTS
             for names in (("x2", "label"), ("x4", "lab3"))]
    bad = []
    for (_, _, kw, _), (jout, jg, tout, tg) in zip(
            calls, grads_batch(calls, seed=9)):
        bad.append(mismatch(f"SoftmaxOutput {kw}", jout, tout))
        bad.append(mismatch(f"dSoftmaxOutput {kw}", jg[0], tg[0]))
    assert not any(bad), [b for b in bad if b]


def _both(a):
    return (jmx.np.array(a, dtype=a.dtype),
            mt.np.array(a, dtype=a.dtype, device=mt.cpu()))


def test_stateful_batch_norm_in_both_namespaces():
    """``mx.nd.BatchNorm`` (eps 1e-3, fix_gamma) and ``mx.npx.batch_norm``
    as the JAX package runs them: inside ``record()`` the batch statistics
    normalize and the moving ones take the blended values, in the port in
    their own storage; outside it the moving statistics normalize and
    stay as they are."""
    x, g, b, m, v = _arrays(_BN)
    for ns, kw in (("nd", dict(fix_gamma=True)),
                   ("npx", dict(fix_gamma=False, momentum=0.8))):
        pairs = [_both(a) for a in (x, g, b, m, v)]
        jargs, targs = zip(*pairs)
        tm, tv = targs[3]._data, targs[4]._data
        fn = "BatchNorm" if ns == "nd" else "batch_norm"
        for record in (True, False):
            with jmx.autograd.record() if record else _null():
                jout = getattr(getattr(jmx, ns), fn)(*jargs, **kw)
            with mt.autograd.record() if record else _null():
                tout = getattr(getattr(mt, ns), fn)(*targs, **kw)
            assert mismatch(f"{ns} out record={record}", jout,
                            tout) is None
            for i in (3, 4):
                assert mismatch(f"{ns} moving {i}", jargs[i],
                                targs[i]) is None
        assert targs[3]._data is tm and targs[4]._data is tv
        assert not onp.allclose(targs[3].asnumpy(), m)
    # npx.BatchNorm is npx.batch_norm; output_mean_var gives three arrays
    _, targs = zip(*[_both(a) for a in (x, g, b, m, v)])
    with mt.autograd.record():
        out = mt.npx.BatchNorm(*targs, output_mean_var=True)
    assert len(out) == 3


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_dropout_facades():
    """The stateful ``nd.Dropout``/``npx.dropout``: identity outside
    training (``mode="training"``), inverted scaling inside it and with
    ``mode="always"``; the registry's pure ``Dropout`` is identity without
    a key, as the JAX package's."""
    x = onp.ones((64, 64), "f")
    t = mt.np.array(x, device=mt.cpu())
    assert mt.nd.Dropout(t, p=0.5) is t
    with mt.autograd.record():
        out = mt.nd.Dropout(t, p=0.25).asnumpy()
    kept = out != 0
    assert onp.allclose(out[kept], 1 / 0.75)
    assert 0.6 < kept.mean() < 0.9
    out = mt.npx.dropout(t, p=0.5, axes=(0,), mode="always").asnumpy()
    assert (out == out[:1]).all()     # the mask shared along axis 0
    assert onp.array_equal(port_call("Dropout", (x,), {}).numpy(), x)
    assert onp.array_equal(onp.asarray(jax_call("Dropout", (x,), {})), x)
