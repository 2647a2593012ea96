"""The rest of ops/tensor.py's registrations and ops/vision.py's legacy
vision ops against the JAX package's, on the CPU from the same numpy
inputs: forward over the sweep table's cases, backward over a table of
the differentiable ones, and the loss-output ops, whose backward is the
reference's fixed gradient whatever the head gradient (the cotangents
below are random: both packages ignore them where the reference does).

Tolerance: f32 within 1e-5 relative (plus 1e-6 absolute near zero).
"""
import numpy as onp

import mxnet_tpu as jmx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import _sweep_cases as sc
from test_torch_registry_coverage import (grads_batch, jax_batch,
                                          mismatch, port_call)

_TENSOR = {
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "MakeLoss", "make_loss", "SVMOutput",
    "SoftmaxOutput", "softmax_output", "_npi_logical_and",
    "_npi_logical_or", "_npi_logical_xor", "ravel_multi_index",
    "_ravel_multi_index", "unravel_index", "_unravel_index", "arange_like",
    "argmax_channel", "batch_take", "broadcast_like",
    "choose_element_0index", "fill_element_0index", "gather_nd",
    "scatter_nd", "diag", "trace", "cumsum", "histogram", "im2col",
    "col2im", "khatri_rao", "mish", "relu6", "silu", "shape_array",
    "size_array", "slice_like", "smooth_l1", "softmax_cross_entropy",
    "space_to_depth"}
_VISION = {"BilinearSampler", "GridGenerator", "SpatialTransformer",
           "ROIPooling", "Correlation", "Crop", "DeformableConvolution"}
DATA = sc.inputs(0)
_R = onp.random.RandomState(4)
# a small deformable case: its backward compiles one gather per tap
DATA.update(dx=_R.uniform(-1, 1, (1, 2, 4, 4)).astype("f"),
            dw=_R.uniform(-1, 1, (3, 2, 2, 2)).astype("f"),
            doff=_R.uniform(-0.5, 0.5, (1, 8, 3, 3)).astype("f"))


def test_forward_over_the_sweep_cases():
    # the ops of the backward table are compared forward there
    cases = [c for c in sc.CASES
             if c.key in (_TENSOR | _VISION) - {g[0] for g in _GRADS}
             and c.kind == "det"]
    calls = [(c.key, *sc.materialize(c, DATA, lambda a: a)) for c in cases]
    bad = [mismatch(c.key, j, port_call(*call), check=c.check)
           for c, call, j in zip(cases, calls, jax_batch(calls))]
    assert not any(bad), [b for b in bad if b]


_GRADS = [
    ("smooth_l1", ("x2",), dict(scalar=2.0), (0,)),
    ("batch_take", ("x2", "label"), {}, (0,)),
    ("choose_element_0index", ("x2", "label"), {}, (0,)),
    ("fill_element_0index", ("x2", "vals4", "label"), {}, (0, 1)),
    ("gather_nd", ("x2", "gidx"), {}, (0,)),
    ("scatter_nd", ("gvals", "gidx"), dict(shape=(5, 5)), (0,)),
    ("slice_like", ("x4", "x4small"), {}, (0,)),
    ("broadcast_like", ("row", "x2"), {}, (0,)),
    ("im2col", ("x4",), dict(kernel=(3, 3), stride=(2, 2), dilate=(1, 2),
                             pad=(1, 1)), (0,)),
    ("col2im", ("cols",), dict(output_size=(6, 6), kernel=(3, 3)), (0,)),
    ("khatri_rao", ("kr_a", "kr_b"), {}, (0, 1)),
    ("mish", ("x2",), {}, (0,)),
    ("silu", ("x2",), {}, (0,)),
    ("relu6", ("x8",), {}, (0,)),
    ("cumsum", ("x2",), dict(axis=0), (0,)),
    ("diag", ("x2",), dict(k=-1), (0,)),
    ("trace", ("sq",), dict(offset=1), (0,)),
    ("space_to_depth", ("x4",), dict(block_size=3), (0,)),
    ("softmax_cross_entropy", ("x2", "label"), {}, (0,)),
    ("BilinearSampler", ("x4", "grid"), {}, (0, 1)),
    ("GridGenerator", ("affine",), dict(transform_type="affine",
                                        target_shape=(3, 4)), (0,)),
    ("GridGenerator", ("grid",), dict(transform_type="warp"), (0,)),
    ("SpatialTransformer", ("x4", "affine"), dict(target_shape=(4, 4)),
     (0, 1)),
    ("ROIPooling", ("x4", "rois"), dict(pooled_size=(3, 2),
                                        spatial_scale=0.5), (0,)),
    ("Correlation", ("x4", "x4c"), dict(kernel_size=1, max_displacement=2,
                                        stride2=2, pad_size=1), (0, 1)),
    ("Crop", ("x4",), dict(offset=(1, 2), h_w=(3, 3)), (0,)),
    ("DeformableConvolution", ("dx", "doff", "dw"), dict(kernel=(2, 2)),
     (0, 1, 2)),
]


def test_backward_of_the_differentiable_ops():
    bad = []
    results = grads_batch([(key, tuple(DATA[n] for n in names), kw, wrt)
                           for key, names, kw, wrt in _GRADS])
    for (key, names, _, wrt), (jout, jg, tout, tg) in zip(_GRADS, results):
        bad.append(mismatch(key, jout, tout))
        bad += [mismatch(f"{key} d{names[i]}", a, b)
                for i, a, b in zip(wrt, jg, tg)]
    assert not any(bad), [b for b in bad if b]


_LOSS_OUTPUTS = [
    ("LinearRegressionOutput", ("x2", "y2"), dict(grad_scale=0.5)),
    ("LogisticRegressionOutput", ("x2", "y2"), dict(grad_scale=2.0)),
    ("MAERegressionOutput", ("x2", "y2"), {}),
    ("MakeLoss", ("x2",), dict(grad_scale=0.3)),
    ("make_loss", ("x4",), {}),
    ("SVMOutput", ("x2", "label"), dict(margin=0.5,
                                        regularization_coefficient=2.0)),
    ("SVMOutput", ("x2", "label"), dict(use_linear=True)),
]


def test_loss_output_gradients():
    calls = [(key, tuple(DATA[n] for n in names), kw, (0,))
             for key, names, kw in _LOSS_OUTPUTS]
    bad = []
    for (key, _, kw, _), (jout, jg, tout, tg) in zip(
            calls, grads_batch(calls, seed=5)):
        bad.append(mismatch(f"{key} {kw}", jout, tout))
        bad.append(mismatch(f"d{key} {kw}", jg[0], tg[0]))
    assert not any(bad), [b for b in bad if b]


def test_loss_output_through_ndarrays():
    """``mx.nd.SoftmaxOutput`` on NDArrays inside ``record()``: the
    backward from the output lands the fixed gradient in the data's
    buffer in both packages."""
    x, label = DATA["x2"], DATA["label"]
    grads = []
    for mx in (jmx, mt):
        kw = {} if mx is jmx else dict(device=mt.cpu())
        data = mx.np.array(x, **kw)
        data.attach_grad()
        lab = mx.np.array(label, **kw)
        with mx.autograd.record():
            out = mx.nd.SoftmaxOutput(data, lab, grad_scale=0.5,
                                      use_ignore=True, ignore_label=2)
        out.backward()
        grads.append(data.grad.asnumpy())
    assert mismatch("grad", grads[0], grads[1]) is None
