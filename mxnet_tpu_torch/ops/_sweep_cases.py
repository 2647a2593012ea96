"""One call of every operator of the registry corpus, of ``mx.np.linalg``,
``mx.np.random``, ``mx.random`` and ``mx.nd.random``: the table that the
CPU tests (against the JAX package) and ``chip_smoke.py`` (the card
against the CPU) both run.

A case names its function (a registry op by its name, or
``"np.linalg.svd"``-style for the namespaces), its arguments (numpy
arrays made from a seed by :func:`inputs`, named by :class:`A`, or by
:class:`S` in a sparse storage, or plain values) and its kind: ``"det"`` (deterministic: the same inputs give the
same values), ``"sample"`` (a draw: shape, dtype and device are checked,
and two draws after one seed must be equal) or ``"sample_inplace"`` (a
draw into its argument). ``check`` says how two results of a
deterministic case compare: ``"value"``, or ``"abs"`` where a
factorization's vectors are defined up to sign (QR, SVD, eigenvectors).

Registry names of earlier slices (:data:`EARLIER`) have tests of their
own and are not in the table.
"""
from __future__ import annotations

import dataclasses

import numpy as onp

__all__ = ["A", "S", "Case", "CASES", "REST_CASES", "EARLIER", "inputs", "function_of",
           "materialize", "host_leaves"]

#: the registry's names before the slice that brought this table
EARLIER = frozenset("""
BlockGrad abs add_n arccos arccosh arcsin arcsinh arctan arctanh argmax
argmin argsort batch_dot broadcast_add broadcast_axes broadcast_axis
broadcast_div broadcast_equal broadcast_greater broadcast_greater_equal
broadcast_hypot broadcast_lesser broadcast_lesser_equal broadcast_logical_and
broadcast_logical_or broadcast_logical_xor broadcast_maximum
broadcast_minimum broadcast_minus broadcast_mod broadcast_mul
broadcast_not_equal broadcast_plus broadcast_power broadcast_sub
broadcast_to cast cbrt ceil clip concat cos cosh degrees depth_to_space
digamma dot elemwise_add elemwise_div elemwise_mul elemwise_sub erf erfinv
exp expand_dims expm1 fix flatten flip floor gamma gammaln hard_sigmoid
hypot identity log log10 log1p log2 log_sigmoid logical_not max max_axis
mean min min_axis nanprod nansum negative norm pad prod radians rcbrt
reciprocal relu repeat reshape reshape_like reverse rint round rsqrt
sigmoid sign sin sinh slice slice_axis softsign sort split sqrt square
squeeze stack stop_gradient sum sum_axis swapaxes take tan tanh tile
transpose trunc where
""".split())


@dataclasses.dataclass(frozen=True)
class A:
    """An argument: the array of :func:`inputs` by this name."""
    name: str


@dataclasses.dataclass(frozen=True)
class S:
    """An argument: the array of :func:`inputs` by this name, in storage
    ``stype`` (``tostype``)."""
    name: str
    stype: str


@dataclasses.dataclass
class Case:
    key: str            # a registry op name, or "np.linalg.<name>" etc.
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    kind: str = "det"
    check: str = "value"


def _spd(r, batch, n):
    m = r.uniform(-1, 1, (batch, n, n))
    return (m @ m.transpose(0, 2, 1) + n * onp.eye(n)).astype("float32")


def inputs(seed=0):
    """The named numpy arrays of the table, from ``seed``."""
    r = onp.random.RandomState(seed)
    f = "float32"

    def u(*shape, lo=-1.0, hi=1.0):
        return r.uniform(lo, hi, shape).astype(f)

    spd = _spd(r, 2, 3)
    tri = onp.tril(u(2, 3, 3)) + 2 * onp.eye(3, dtype=f)
    d = dict(
        x4=u(2, 3, 6, 6), x4b=u(2, 4, 3, 3), x4c=u(2, 3, 6, 6),
        x4small=u(1, 2, 4, 4), w_conv=u(4, 3, 3, 3), b4=u(4),
        w_deconv=u(3, 4, 3, 3), x2=u(4, 5), y2=u(4, 5), row=u(1, 5),
        w_fc=u(6, 5), b_fc=u(6), g3=u(3, lo=0.5, hi=1.5), b3=u(3),
        m3=u(3, lo=-0.1, hi=0.1), v3=u(3, lo=0.5, hi=1.5),
        g4=u(4, lo=0.5, hi=1.5), bt4=u(4), g5=u(5, lo=0.5, hi=1.5), b5=u(5),
        seq=u(5, 2, 3), seqlen=onp.array([3, 5], f),
        idx=r.randint(0, 6, (2, 4)).astype("int32"), emb=u(6, 5),
        label=onp.array([0, 2, 4, 1], f), vals4=u(4),
        lab3=r.randint(0, 3, (2, 6, 6)).astype(f),
        gidx=onp.array([[0, 1, 3], [4, 2, 0]], "int32"), gvals=u(3),
        coords=onp.array([[0, 2, 1], [3, 1, 0]], "int32"),
        flat=onp.array([0, 5, 11], "int32"),
        kr_a=u(2, 3), kr_b=u(4, 3), cols=u(2, 27, 16), sq=u(3, 3),
        spd=spd, spd1=spd[0], tri=tri, mat=u(2, 3, 4), mat2=u(3, 4),
        vec3=u(2, 3), vec6=u(2, 6), bmat=u(2, 3, 4), cmat=u(2, 3, 3),
        gemm_b=u(2, 4, 3), lsa=u(5, 3), lsb=u(5, 2), t_inv=u(6, 2, 3),
        t_rhs=u(6), md1=u(3, 4), md2=u(4, 5), md3=u(5, 2), kron_a=u(2, 2),
        kron_b=u(2, 3), cr_a=u(2, 3), cr_b=u(2, 3), v4=u(4), v5=u(5),
        rois=onp.array([[0, 0, 0, 4, 4], [1, 1, 2, 5, 5]], f),
        grid=u(2, 2, 4, 4, lo=-0.9, hi=0.9),
        affine=onp.array([[0.9, 0.1, 0.05, -0.1, 0.8, 0.0]] * 2, f),
        offset=u(2, 18, 4, 4, lo=-0.5, hi=0.5),
        w=u(3, 4), g=u(3, 4), mom=u(3, 4, lo=-0.1, hi=0.1),
        var=u(3, 4, lo=0.01, hi=0.1), hist=u(3, lo=0.01, hi=0.1),
        r1=onp.array([0.7], f), r2=onp.array([1.3], f),
        low2=onp.array([0.0, 1.0], f), high2=onp.array([1.0, 3.0], f),
        pos2=onp.array([1.5, 2.5], f), pos2b=onp.array([0.5, 2.0], f),
        prob2=onp.array([0.3, 0.6], f), pdf_x=u(2, 3, lo=0.2, hi=0.9),
        pdf_counts=onp.array([[0, 1, 3], [2, 5, 1]], f),
        simplex=onp.full((2, 3, 4), 0.25, f), alpha24=u(2, 4, lo=0.5, hi=2),
        probs=onp.array([[0.1, 0.2, 0.3, 0.4], [0.4, 0.3, 0.2, 0.1]], f),
        p4=onp.array([0.1, 0.2, 0.3, 0.4], f),
        mvn_mean=onp.zeros(3, f), mvn_cov=spd[0],
        mask=(r.uniform(0, 1, (4, 5)) > 0.3).astype(f),
        nz=(r.uniform(0, 1, (3, 4)) > 0.5).astype(f),
        ones_b=onp.ones((2, 3), f), ucoords=onp.array([[0, 1], [2, 3]],
                                                       "int32"),
        pair=onp.array([1.0, -2.0], f), pred=onp.array([1.0], f),
        steps=u(4, 2), state=onp.zeros((2,), f), counter=onp.array([0.0], f),
        q=u(1, 2, 24, 32), k=u(1, 2, 24, 32), v=u(1, 2, 24, 32),
    )
    d["x8"] = d["x2"] * 8
    d["sparse"] = d["x2"] * d["mask"]
    d["sparse"][[1, 3]] = 0
    d["keep"] = onp.array([0, 1, 2], "int32")
    d.update(
        pick=onp.array([0, 1, 2, 3], "int32"), v5b=u(5),
        mask5=onp.array([True, False, True, True, False]),
        ci=onp.array([1, 0, 3], "int32"), cj=onp.array([2, 5, 1], "int32"),
        zeros_in=onp.array([0, 0, 1.5, 0, 2, 0], f),
        xp=onp.array([-1.0, -0.3, 0.2, 1.0], f),
        v5sq=(3 * d["v5"] * d["v5"] - d["v5"] + 1).astype(f),
        cubic=onp.array([1.0, -6.0, 11.0, -6.0], f),
        bits=r.uniform(0, 1, (3, 10)) > 0.5,
        bytes=r.randint(0, 256, (2, 3)).astype("uint8"))
    # int8 codes and their f32 ranges (contrib/quantization.py's ops)
    d.update(
        qx=r.randint(-127, 128, (2, 3, 6, 6)).astype("int8"),
        qx2=r.randint(-127, 128, (2, 3, 6, 6)).astype("int8"),
        qw=r.randint(-127, 128, (4, 3, 3, 3)).astype("int8"),
        qb=r.randint(-127, 128, (4,)).astype("int8"),
        qfc=r.randint(-127, 128, (6, 108)).astype("int8"),
        qbfc=r.randint(-127, 128, (6,)).astype("int8"),
        qemb=r.randint(-127, 128, (6, 5)).astype("int8"),
        acc32=r.randint(-2 ** 30, 2 ** 30, (4, 5)).astype("int32"),
        qlo=onp.array(-2.0, f), qhi=onp.array(3.0, f),
        qlo2=onp.array(-0.5, f), qhi2=onp.array(0.25, f),
        calib=r.normal(0, 1, 4096).astype(f))
    return d


# bodies of the control-flow cases: NDArray operators only, so the same
# callables run in both packages
def _fe_body(x, s):
    return x * 2.0, s + x


def _wl_cond(i, acc):  # noqa: ARG001
    return i < 3


def _wl_func(i, acc):
    return acc * 1.0, (i + 1.0, acc + i)


def _cond_then(x):
    return x * 2.0


def _cond_else(x):
    return x - 1.0


C = Case
CASES = [
    # -- ops/nn.py ------------------------------------------------------------
    C("fully_connected", (A("x2"), A("w_fc"), A("b_fc")), dict(num_hidden=6)),
    C("convolution", (A("x4"), A("w_conv"), A("b4")),
      dict(stride=(1, 1), pad=(1, 1))),
    C("deconvolution", (A("x4"), A("w_deconv"), A("b4")), dict(stride=(2, 2))),
    C("pooling", (A("x4"),), dict(kernel=(2, 2), pool_type="avg",
                                  stride=(2, 2))),
    C("batch_norm", (A("x4"), A("g3"), A("b3"), A("m3"), A("v3"))),
    C("_contrib_SyncBatchNorm", (A("x4"), A("g3"), A("b3"), A("m3"),
                                 A("v3")), dict(training=False)),
    C("layer_norm", (A("x2"), A("g5"), A("b5"))),
    C("group_norm", (A("x4b"), A("g4"), A("bt4")), dict(num_groups=2)),
    C("GroupNorm", (A("x4b"), A("g4"), A("bt4")), dict(num_groups=4)),
    C("instance_norm", (A("x4"), A("g3"), A("b3"))),
    C("rms_norm", (A("x2"), A("g5"))),
    C("lrn", (A("x4"),), dict(nsize=3)),
    C("softmax", (A("x2"),), dict(axis=0, temperature=2.0)),
    C("log_softmax", (A("x2"),)),
    C("softmin", (A("x2"),)),
    C("activation", (A("x2"),), dict(act_type="softrelu")),
    C("leaky_relu", (A("x2"),), dict(act_type="elu", slope=0.3)),
    C("dropout", (A("x2"),), dict(p=0.5), kind="sample"),
    C("embedding", (A("idx"), A("emb"))),
    C("one_hot", (A("idx"), 6)),
    C("pick", (A("x2"), A("label")), dict(axis=1)),
    C("topk", (A("x2"),), dict(k=2, ret_typ="both")),
    C("sequence_mask", (A("seq"), A("seqlen"), True), dict(value=-1.0)),
    C("sequence_last", (A("seq"), A("seqlen"), True)),
    C("sequence_reverse", (A("seq"), A("seqlen"), True)),
    C("l2_normalization", (A("x4"),), dict(mode="channel")),
    # -- contrib/quantization.py -----------------------------------------------
    C("_contrib_quantize", (A("x2"), A("qlo"), A("qhi"))),
    C("_contrib_quantize_v2", (A("x2"),)),
    C("_contrib_quantize_v2", (A("x2"),),
      dict(min_calib_range=-0.5, max_calib_range=0.5)),
    C("_contrib_dequantize", (A("qx"), A("qlo"), A("qhi"))),
    C("_contrib_requantize", (A("acc32"), A("qlo"), A("qhi"))),
    C("_contrib_requantize", (A("acc32"), A("qlo"), A("qhi")),
      dict(min_calib_range=-1.0, max_calib_range=1.0)),
    C("_contrib_calibrate_entropy", (A("calib"),)),
    C("_contrib_quantized_act", (A("qx"), A("qlo"), A("qhi")),
      dict(act_type="relu")),
    C("_contrib_quantized_flatten", (A("qx"), A("qlo"), A("qhi"))),
    C("_contrib_quantized_pooling", (A("qx"), A("qlo"), A("qhi")),
      dict(kernel=(2, 2), stride=(2, 2))),
    C("_contrib_quantized_elemwise_add", (A("qx"), A("qx2"), A("qlo"),
                                          A("qhi"), A("qlo2"), A("qhi2"))),
    C("_contrib_quantized_elemwise_mul", (A("qx"), A("qx2"), A("qlo"),
                                          A("qhi"), A("qlo2"), A("qhi2"))),
    C("_contrib_quantized_concat", (A("qx"), A("qx2"), A("qlo"), A("qhi"),
                                    A("qlo2"), A("qhi2")), dict(dim=1)),
    C("_contrib_quantized_embedding", (A("idx"), A("qemb"), A("qlo"),
                                       A("qhi"))),
    C("_contrib_quantized_batch_norm", (A("qx"), A("g3"), A("b3"), A("m3"),
                                        A("v3"), A("qlo"), A("qhi"))),
    C("_contrib_quantized_conv", (A("qx"), A("qw"), A("qb"), A("qlo"),
                                  A("qhi"), A("qlo2"), A("qhi2"), A("qlo"),
                                  A("qhi")), dict(pad=(1, 1))),
    C("_contrib_quantized_conv", (A("qx"), A("qw"), None, A("qlo"),
                                  A("qhi"), A("qlo2"), A("qhi2")),
      dict(stride=(2, 2), no_bias=True)),
    C("_contrib_quantized_fully_connected", (A("qx"), A("qfc"), A("qbfc"),
                                             A("qlo"), A("qhi"), A("qlo2"),
                                             A("qhi2"), A("qlo"), A("qhi"))),
    C("upsampling", (A("x4"),), dict(scale=2, sample_type="bilinear")),
    C("moments", (A("x4"),), dict(axes=(0, 2, 3))),
    # -- ops/legacy.py ----------------------------------------------------
    C("Convolution", (A("x4"), A("w_conv"), A("b4")),
      dict(kernel=(3, 3), num_filter=4, pad=(1, 1))),
    C("Deconvolution", (A("x4"), A("w_deconv")),
      dict(kernel=(3, 3), num_filter=4, stride=(2, 2), adj=(1, 1))),
    C("FullyConnected", (A("x2"), A("w_fc")),
      dict(num_hidden=6, no_bias=True, flatten=False)),
    C("Pooling", (A("x4"),), dict(kernel=(3, 3), pool_type="max",
                                  stride=(2, 2), pad=(1, 1))),
    C("BatchNorm", (A("x4"), A("g3"), A("b3"), A("m3"), A("v3")),
      dict(fix_gamma=False, output_mean_var=True)),
    C("LayerNorm", (A("x2"), A("g5"), A("b5")), dict(output_mean_var=True)),
    C("InstanceNorm", (A("x4"), A("g3"), A("b3"))),
    C("L2Normalization", (A("x2"),)),
    C("Activation", (A("x2"),), dict(act_type="sigmoid")),
    C("LeakyReLU", (A("x2"),), dict(act_type="leaky", slope=0.1)),
    C("SoftmaxActivation", (A("x4"),), dict(mode="channel")),
    C("Embedding", (A("idx"), A("emb")), dict(input_dim=6, output_dim=5)),
    C("Concat", (A("x2"), A("y2")), dict(dim=0)),
    C("Flatten", (A("x4"),)),
    C("Reshape", (A("x4"),), dict(shape=(0, -1))),
    C("Cast", (A("x2"),), dict(dtype="float16")),
    C("SwapAxis", (A("x4"),), dict(dim1=1, dim2=3)),
    C("SequenceLast", (A("seq"),)),
    C("SequenceMask", (A("seq"), A("seqlen")),
      dict(use_sequence_length=True)),
    C("SequenceReverse", (A("seq"),)),
    C("UpSampling", (A("x4"),), dict(scale=2, sample_type="nearest")),
    C("LRN", (A("x4"),), dict(nsize=3, alpha=0.01)),
    C("SliceChannel", (A("x4b"),), dict(num_outputs=2)),
    C("Pad", (A("x4"),), dict(mode="edge", pad_width=(0, 0, 0, 0, 1, 2, 2,
                                                      1))),
    C("Dropout", (A("x2"),), dict(p=0.5)),
    C("IdentityAttachKLSparseReg", (A("x2"),)),
    # -- ops/tensor.py ------------------------------------------------------
    C("LinearRegressionOutput", (A("x2"), A("y2"))),
    C("LogisticRegressionOutput", (A("x2"), A("y2"))),
    C("MAERegressionOutput", (A("x2"), A("y2"))),
    C("MakeLoss", (A("x2"),)),
    C("make_loss", (A("x2"),), dict(grad_scale=0.5)),
    C("SVMOutput", (A("x2"), A("label"))),
    C("SoftmaxOutput", (A("x2"), A("label"))),
    C("softmax_output", (A("x4"), A("lab3")), dict(use_ignore=True,
                                                   ignore_label=1)),
    C("_npi_logical_and", (A("x2"), A("y2"))),
    C("_npi_logical_or", (A("x2"), A("y2"))),
    C("_npi_logical_xor", (A("mask"), A("y2"))),
    C("ravel_multi_index", (A("coords"),), dict(shape=(5, 4))),
    C("_ravel_multi_index", (A("coords"),), dict(shape=(5, 4))),
    C("unravel_index", (A("flat"),), dict(shape=(3, 4))),
    C("_unravel_index", (A("flat"),), dict(shape=(3, 4))),
    C("arange_like", (A("x2"),), dict(start=1.0, step=0.5, repeat=2)),
    C("argmax_channel", (A("x4"),)),
    C("batch_take", (A("x2"), A("label"))),
    C("broadcast_like", (A("row"), A("x2"))),
    C("choose_element_0index", (A("x2"), A("label"))),
    C("fill_element_0index", (A("x2"), A("vals4"), A("label"))),
    C("gather_nd", (A("x2"), A("gidx"))),
    C("scatter_nd", (A("gvals"), A("gidx")), dict(shape=(5, 5))),
    C("diag", (A("x2"),), dict(k=1)),
    C("trace", (A("sq"),)),
    C("cumsum", (A("x2"),), dict(axis=1)),
    C("histogram", (A("x2"),), dict(bin_cnt=5, range=(-1.0, 1.0))),
    C("im2col", (A("x4"),), dict(kernel=(3, 3), stride=(1, 1), pad=(0, 0))),
    C("col2im", (A("cols"),), dict(output_size=(6, 6), kernel=(3, 3))),
    C("khatri_rao", (A("kr_a"), A("kr_b"))),
    C("mish", (A("x2"),)),
    C("relu6", (A("x8"),)),
    C("silu", (A("x2"),)),
    C("shape_array", (A("x4"),)),
    C("size_array", (A("x4"),)),
    C("slice_like", (A("x4"), A("x4small"))),
    C("smooth_l1", (A("x2"),), dict(scalar=2.0)),
    C("softmax_cross_entropy", (A("x2"), A("label"))),
    C("space_to_depth", (A("x4"),), dict(block_size=2)),
    # -- ops/vision.py ------------------------------------------------------
    C("BilinearSampler", (A("x4"), A("grid"))),
    C("GridGenerator", (A("affine"),), dict(transform_type="affine",
                                            target_shape=(4, 5))),
    C("SpatialTransformer", (A("x4"), A("affine")), dict(target_shape=(4,
                                                                       4))),
    C("ROIPooling", (A("x4"), A("rois")), dict(pooled_size=(2, 2),
                                               spatial_scale=1.0)),
    C("Correlation", (A("x4"), A("x4c")), dict(kernel_size=1,
                                               max_displacement=1)),
    C("Crop", (A("x4"),), dict(h_w=(4, 3), center_crop=True)),
    C("DeformableConvolution", (A("x4"), A("offset"), A("w_conv"), A("b4")),
      dict(kernel=(3, 3))),
    # -- ops/optimizer_ops.py -------------------------------------------------
    C("sgd_update", (A("w"), A("g")), dict(lr=0.1, wd=0.01)),
    C("sgd_mom_update", (A("w"), A("g"), A("mom")),
      dict(lr=0.1, momentum=0.9, wd=0.01)),
    C("nag_mom_update", (A("w"), A("g"), A("mom")),
      dict(lr=0.1, momentum=0.9, wd=0.01)),
    C("signsgd_update", (A("w"), A("g")), dict(lr=0.1, wd=0.01)),
    C("signum_update", (A("w"), A("g"), A("mom")),
      dict(lr=0.1, momentum=0.9, wd_lh=0.01)),
    C("adam_update", (A("w"), A("g"), A("mom"), A("var")), dict(lr=0.01)),
    C("adamw_update", (A("w"), A("g"), A("mom"), A("var")),
      dict(lr=0.01, wd=0.01)),
    C("_adamw_update", (A("w"), A("g"), A("mom"), A("var")),
      dict(lr=0.01, eta=0.5)),
    C("lamb_update_phase1", (A("w"), A("g"), A("mom"), A("var")),
      dict(t=2, wd=0.01)),
    C("lamb_update_phase2", (A("w"), A("g"), A("r1"), A("r2")),
      dict(lr=0.1)),
    C("mp_lamb_update_phase2", (A("w"), A("g"), A("r1"), A("r2")),
      dict(lr=0.1, lower_bound=0.8)),
    C("rmsprop_update", (A("w"), A("g"), A("var")), dict(lr=0.01)),
    C("rmspropalex_update", (A("w"), A("g"), A("var"), A("mom"), A("mom")),
      dict(lr=0.01)),
    C("ftrl_update", (A("w"), A("g"), A("mom"), A("var")), dict(lr=0.1)),
    C("adagrad_update", (A("w"), A("g"), A("var")), dict(lr=0.1)),
    C("_sparse_adagrad_update", (A("w"), A("g"), A("var")), dict(lr=0.1)),
    C("adadelta_update", (A("w"), A("g"), A("var"), A("var"))),
    C("all_finite", (A("w"),)),
    C("multi_all_finite", (A("w"), A("g"))),
    C("multi_sum_sq", (A("w"), A("g"))),
    C("adabelief_update", (A("w"), A("g"), A("mom"), A("var")),
      dict(lr=0.01)),
    C("_adabelief_update", (A("w"), A("g"), A("mom"), A("var")),
      dict(lr=0.01, wd=0.01)),
    C("ftml_update", (A("w"), A("g"), A("var"), A("var"), A("mom")),
      dict(lr=0.1, t=2)),
    C("group_adagrad_update", (A("w"), A("g"), A("hist")), dict(lr=0.1)),
    C("_contrib_group_adagrad_update", (A("w"), A("g"), A("hist")),
      dict(lr=0.1)),
    C("lans_update_phase1", (A("w"), A("g"), A("mom"), A("var")),
      dict(t=2, wd=0.01)),
    C("_multi_lans_update", (A("w"), A("g"), A("mom"), A("var"))),
    C("_multi_mp_lans_update", (A("w"), A("g"), A("mom"), A("var"))),
    # -- ops/linalg.py (the _linalg_* twins are added below) ----------------
    C("linalg_gemm", (A("bmat"), A("gemm_b"), A("cmat")),
      dict(alpha=2.0, beta=0.5)),
    C("linalg_gemm2", (A("bmat"), A("bmat")), dict(transpose_b=True)),
    C("linalg_potrf", (A("spd"),)),
    C("linalg_potri", (A("tri"),)),
    C("linalg_trmm", (A("tri"), A("bmat")), dict(alpha=2.0)),
    C("linalg_trsm", (A("tri"), A("bmat")), dict(transpose=True)),
    C("linalg_syrk", (A("bmat"),), dict(alpha=0.5)),
    C("linalg_gelqf", (A("bmat"),), check="abs"),
    C("linalg_syevd", (A("spd"),), check="abs"),
    C("linalg_sumlogdiag", (A("spd"),)),
    C("linalg_extractdiag", (A("spd"),), dict(offset=1)),
    C("linalg_makediag", (A("vec3"),), dict(offset=-1)),
    C("linalg_extracttrian", (A("spd"),), dict(lower=False)),
    C("linalg_maketrian", (A("vec6"),)),
    C("linalg_inverse", (A("spd"),)),
    C("linalg_det", (A("spd"),)),
    C("linalg_slogdet", (A("spd"),)),
    C("linalg_svd", (A("bmat"),), check="abs"),
    C("linalg_matrix_rank", (A("bmat"),)),
    C("linalg_norm", (A("bmat"),), dict(axis=(1, 2))),
    C("linalg_solve", (A("spd"), A("cmat"))),
    C("linalg_tensorinv", (A("t_inv"),), dict(ind=1)),
    C("linalg_tensorsolve", (A("t_inv"), A("t_rhs"))),
    C("linalg_cholesky", (A("spd"),), dict(lower=False)),
    C("linalg_qr", (A("bmat"),), check="abs"),
    C("linalg_eig", (A("spd1"),), check="abs"),
    C("linalg_eigh", (A("spd"),), dict(upper=True), check="abs"),
    C("linalg_eigvals", (A("spd1"),)),
    C("linalg_eigvalsh", (A("spd"),)),
    C("linalg_lstsq", (A("lsa"), A("lsb"))),
    C("linalg_pinv", (A("mat2"),)),
    C("linalg_multi_dot", (A("md1"), A("md2"), A("md3"))),
    C("linalg_matrix_power", (A("sq"), 3)),
    C("linalg_kron", (A("kron_a"), A("kron_b"))),
    C("linalg_matmul", (A("bmat"), A("gemm_b"))),
    # -- ops/np_linalg.py ------------------------------------------------------
    C("_npi_svd", (A("mat2"),), check="abs"),
    C("_npi_eigh", (A("spd"),), dict(upper=True), check="abs"),
    C("_npi_eigvalsh", (A("spd"),)),
    C("_npi_matrix_rank", (A("bmat"),), dict(rtol=0.1)),
    C("_npi_matrix_rank_none_tol", (A("bmat"),), dict(hermitian=False)),
    C("_npi_lstsq", (A("lsa"), A("lsb"))),
    C("_npi_eig", (A("spd1"),), check="abs"),
    C("_npi_eigvals", (A("spd1"),)),
    # -- ops/random_legacy.py ---------------------------------------------------
    C("_random_pdf_uniform", (A("pdf_x"), A("low2"), A("high2"))),
    C("_random_pdf_normal", (A("pdf_x"), A("low2"), A("pos2")),
      dict(is_log=True)),
    C("_random_pdf_gamma", (A("pdf_x"), A("pos2"), A("pos2b"))),
    C("_random_pdf_exponential", (A("pdf_x"), A("pos2"))),
    C("_random_pdf_poisson", (A("pdf_counts"), A("pos2"))),
    C("_random_pdf_negative_binomial", (A("pdf_counts"), A("pos2"),
                                        A("prob2"))),
    C("_random_pdf_generalized_negative_binomial",
      (A("pdf_counts"), A("pos2"), A("pos2b"))),
    C("_random_pdf_dirichlet", (A("simplex"), A("alpha24"))),
    C("_sample_uniform", (A("low2"), A("high2")), dict(shape=3),
      kind="sample"),
    C("_sample_normal", (A("low2"), A("pos2")), dict(shape=(2, 3)),
      kind="sample"),
    C("_sample_exponential", (A("pos2"),), dict(shape=3), kind="sample"),
    C("_sample_gamma", (A("pos2"), A("pos2b")), dict(shape=3),
      kind="sample"),
    C("_sample_poisson", (A("pos2"),), dict(shape=3), kind="sample"),
    C("_sample_multinomial", (A("probs"),), dict(shape=3, get_prob=True),
      kind="sample"),
    C("_sample_unique_zipfian", (50,), dict(shape=(2, 5)), kind="sample"),
    C("_shuffle", (A("x2"),), kind="sample"),
    # -- numpy/random.py: the _npi_* samplers ----------------------------------
    C("_npi_normal", (0.0, 2.0), dict(size=(3, 4)), kind="sample"),
    C("_npi_uniform", (1.0, 2.0), dict(size=(3, 4)), kind="sample"),
    C("_npi_gamma", (2.0, 1.5), dict(size=(3, 4)), kind="sample"),
    C("_npi_exponential", (2.0,), dict(size=(3, 4)), kind="sample"),
    C("_npi_laplace", (0.0, 1.0), dict(size=(3, 4)), kind="sample"),
    C("_npi_gumbel", (0.0, 1.0), dict(size=(3, 4)), kind="sample"),
    C("_npi_logistic", (0.0, 1.0), dict(size=(3, 4)), kind="sample"),
    C("_npi_pareto", (3.0,), dict(size=(3, 4)), kind="sample"),
    C("_npi_rayleigh", (1.0,), dict(size=(3, 4)), kind="sample"),
    C("_npi_weibull", (2.0,), dict(size=(3, 4)), kind="sample"),
    C("_npi_bernoulli", (0.3,), dict(size=(3, 4)), kind="sample"),
    C("_npi_choice", (5,), dict(size=3), kind="sample"),
    C("_npi_multinomial", (4, A("p4")), dict(size=2), kind="sample"),
    C("_npi_normal_n", (A("low2"), A("pos2")), kind="sample"),
    C("_npi_uniform_n", (A("low2"), A("high2")), kind="sample"),
    C("_npi_powerd", (2.0,), dict(size=(3, 4)), kind="sample"),
    # -- numpy_extension: the registry's npx spellings and control flow --
    C("_npx_reshape", (A("x4"),), dict(newshape=(-2, -1))),
    C("_npx_nonzero", (A("nz"),)),
    C("_npx_index_add", (A("x2"), A("ucoords"), A("pair"))),
    C("_npx_index_update", (A("x2"), A("ucoords"), A("pair"))),
    C("_scatter_set_nd", (A("x2"), A("ucoords"), A("pair"))),
    C("_npx_constraint_check", (A("ones_b"),)),
    C("_contrib_arange_like", (A("x2"),), dict(step=2.0, axis=1)),
    C("_npx_foreach", (_fe_body, A("steps"), A("state"))),
    C("_foreach", (_fe_body, A("steps"), A("state"))),
    C("_npx_while_loop", (_wl_cond, _wl_func, [A("counter"), A("counter")]),
      dict(max_iterations=5)),
    C("_while_loop", (_wl_cond, _wl_func, [A("counter"), A("counter")]),
      dict(max_iterations=4)),
    C("_npx_cond", (A("pred"), _cond_then, _cond_else, [A("x2")])),
    C("_cond", (A("pred"), _cond_then, _cond_else, [A("x2")])),
    # -- ops/flash_attention.py ---------------------------------------------------
    C("flash_attention", (A("q"), A("k"), A("v")), dict(causal=True,
                                                        block_q=64)),
    # -- mx.np.linalg --------------------------------------------------------
    C("np.linalg.cholesky", (A("spd"),)),
    C("np.linalg.det", (A("spd"),)),
    C("np.linalg.slogdet", (A("spd"),)),
    C("np.linalg.eig", (A("spd1"),), check="abs"),
    C("np.linalg.eigh", (A("spd"),), check="abs"),
    C("np.linalg.eigvals", (A("spd1"),)),
    C("np.linalg.eigvalsh", (A("spd"),), dict(upper=True)),
    C("np.linalg.inv", (A("spd"),)),
    C("np.linalg.lstsq", (A("lsa"), A("lsb"))),
    C("np.linalg.matrix_power", (A("sq"), 2)),
    C("np.linalg.matrix_rank", (A("bmat"),)),
    C("np.linalg.norm", (A("bmat"),), dict(ord="fro", axis=(1, 2))),
    C("np.linalg.pinv", (A("mat2"),)),
    C("np.linalg.qr", (A("bmat"),), check="abs"),
    C("np.linalg.solve", (A("spd"), A("cmat"))),
    C("np.linalg.svd", (A("bmat"),), check="abs"),
    C("np.linalg.svdvals", (A("bmat"),)),
    C("np.linalg.tensorinv", (A("t_inv"),), dict(ind=1)),
    C("np.linalg.tensorsolve", (A("t_inv"), A("t_rhs"))),
    C("np.linalg.cond", (A("spd"),)),
    C("np.linalg.multi_dot", ([A("md1"), A("md2"), A("md3")],)),
    C("np.linalg.matrix_norm", (A("bmat"),), dict(ord=1)),
    C("np.linalg.vector_norm", (A("bmat"),), dict(axis=-1, ord=3)),
    C("np.linalg.cross", (A("cr_a"), A("cr_b"))),
    C("np.linalg.outer", (A("v4"), A("v5"))),
    C("np.linalg.matmul", (A("bmat"), A("gemm_b"))),
    C("np.linalg.trace", (A("spd"),), dict(offset=1)),
    C("np.linalg.diagonal", (A("bmat"),)),
]

def _double_sum(r):
    return (r * 2).sum()


def _halve(x):
    return x * 0.5


#: the names of ROADMAP queue 1 item 4's last group (slice 19): the rest of
#: ``mx.np``, ``mx.nd.sparse`` and the new NDArray methods, one call each,
#: deterministic; ``check="sorted"`` compares complex values sorted (the
#: order of eigenvalues is the solver's)
REST_CASES = [
    C("np.partition", (A("x2"), 2)), C("np.argpartition", (A("x2"), 1),
                                       dict(axis=0)),
    C("np.lexsort", ([A("v5"), A("v5b")],)),
    C("np.choose", (A("pick"), [A("v4"), A("vals4")]), dict(mode="wrap")),
    C("np.compress", (A("mask5"), A("v5"))),
    C("np.delete", (A("x2"), [0, 2]), dict(axis=1)),
    C("np.insert", (A("v5"), [1, 3], 7.5)),
    C("np.ravel_multi_index", ([A("ci"), A("cj")], (4, 6))),
    C("np.indices", ((2, 3),)), C("np.unique_all", (A("gidx"),)),
    C("np.trim_zeros", (A("zeros_in"),)),
    C("np.select", ([A("mask")], [A("x2")]), dict(default=-1.0)),
    C("np.array_equiv", (A("x2"), A("row"))),
    C("np.resize", (A("v5"), (3, 4))),
    C("np.fill_diagonal", (A("sq"), 2.0), dict(inplace=False)),
    C("np.convolve", (A("v5"), A("v4")), dict(mode="same")),
    C("np.correlate", (A("v5"), A("v4")), dict(mode="full")),
    C("np.gradient", (A("x2"), 0.5)), C("np.interp", (
        A("x2"), A("xp"), A("v4"))),
    C("np.polyval", (A("v4"), A("v5"))),
    C("np.polyfit", (A("v5"), A("v5sq"), 2)),
    C("np.histogram", (A("x2"),), dict(bins=4)),
    C("np.histogram2d", (A("v5"), A("v5sq")), dict(bins=3)),
    C("np.histogramdd", (A("x2"),), dict(bins=2)),
    C("np.cumulative_sum", (A("x2"),), dict(axis=1, include_initial=True)),
    C("np.apply_along_axis", (_double_sum, 1, A("x2"))),
    C("np.piecewise", (A("v5"), [A("mask5")], [_halve, 3.0])),
    C("np.sort_complex", (A("v5"),)),
    C("np.roots", (A("cubic"),), check="sorted"),
    C("np.packbits", (A("bits"),), dict(axis=1)),
    C("np.unpackbits", (A("bytes"),), dict(count=10)),
    C("np.real_if_close", (A("v5"),)),
    C("np.logspace", (0.0, 2.0, 5)), C("np.geomspace", (1.0, 50.0, 4)),
    C("np.empty", ((2, 3),)), C("np.empty_like", (A("x2"),)),
    C("np.asarray", (A("v5"),)), C("np.copy", (A("x2"),)),
    C("np.astype", (A("gidx"), "float32")),
    C("np.row_stack", ([A("v5"), A("v5")],)),
    C("np.block", ([A("v4"), A("v5")],)),
    C("np.hanning", (6,)), C("np.hamming", (5,)), C("np.blackman", (7,)),
    C("np.diag_indices_from", (A("sq"),)),
    C("np.tril_indices_from", (A("x2"),), dict(k=1)),
    C("np.triu_indices_from", (A("sq"),)),
    C("nd.sparse.cast_storage", (A("sparse"), "csr")),
    C("nd.sparse.csr_matrix", (A("sparse"),)),
    C("nd.sparse.row_sparse_array", (A("sparse"),)),
    C("nd.sparse.dot", (S("sparse", "csr"), A("w_fc")),
      dict(transpose_b=True)),
    C("nd.sparse.dot", (S("sparse", "csr"), A("y2")),
      dict(transpose_a=True)),
    C("nd.sparse.dot", (S("sparse", "row_sparse"), A("v5"))),
    C("nd.sparse.retain", (S("sparse", "row_sparse"), A("keep"))),
    C("nd.sparse.add", (S("sparse", "row_sparse"), S("x2", "row_sparse"))),
    C("nd.sparse.subtract", (S("x2", "row_sparse"),
                             S("sparse", "row_sparse"))),
    C("nd.sparse.multiply", (S("sparse", "csr"), A("x2"))),
    C("NDArray.norm", (A("x2"),), dict(ord=1, axis=0)),
    C("NDArray.split", (A("x2"), 2)),
    C("NDArray.split", (A("x2"),), dict(num_outputs=5)),
    C("NDArray.take", (A("x2"), A("gidx")), dict(axis=1)),
    C("NDArray.tostype", (A("sparse"), "row_sparse")),
]
# the sparse storage ops (ndarray/sparse.py)
CASES += [
    C("cast_storage", (A("sparse"), "csr")),
    C("cast_storage", (A("sparse"), "row_sparse")),
    C("cast_storage", (S("sparse", "csr"), "default")),
    C("_sparse_retain", (S("sparse", "row_sparse"), A("keep"))),
]

# the _linalg_* twins of la_op.cc
CASES += [dataclasses.replace(c, key="_" + c.key) for c in CASES
          if c.key.startswith("linalg_")]

# the samplers of mx.np.random, again as mx.random (one module in the
# port, two in the JAX package), and of mx.nd.random
_NP_RANDOM = [
    ("uniform", (1.0, 2.0), {}),
    ("normal", (A("low2"), 2.0), dict(size=(3, 2))),
    ("randn", (3, 4), None), ("rand", (3, 4), None),
    ("randint", (0, 9), {}), ("choice", (A("x2"),), dict(replace=False)),
    ("permutation", (A("x2"),), None),
    ("gamma", (A("pos2"),), dict(size=(3, 2))),
    ("beta", (2.0, 3.0), {}), ("exponential", (2.0,), {}),
    ("poisson", (3.0,), {}), ("bernoulli", (A("prob2"),), None),
    ("binomial", (10.0, 0.3), {}), ("negative_binomial", (3, 0.4), {}),
    ("multinomial", (5, A("p4")), dict(size=(3,))),
    ("dirichlet", (A("p4"),), dict(size=(3,))),
    ("multivariate_normal", (A("mvn_mean"), A("mvn_cov")),
     dict(size=(3,))),
    ("laplace", (0.0, 2.0), {}), ("logistic", (1.0, 0.5), {}),
    ("gumbel", (0.0, 1.0), {}), ("pareto", (3.0,), {}),
    ("power", (2.0,), {}), ("rayleigh", (2.0,), {}), ("weibull", (1.5,), {}),
    ("lognormal", (0.0, 0.5), {}), ("chisquare", (3.0,), {}),
    ("f", (4.0, 6.0), {}), ("standard_normal", (), {}),
    ("standard_cauchy", (), {}), ("standard_exponential", (), {}),
]
for _ns in ("np.random", "random"):
    for _name, _args, _kw in _NP_RANDOM:
        CASES.append(Case(f"{_ns}.{_name}", _args,
                          {} if _kw is None else (_kw or dict(size=(3, 4))),
                          kind="sample"))
    CASES.append(Case(f"{_ns}.shuffle", (A("x2"),), kind="sample_inplace"))
CASES += [
    Case("nd.random.uniform", (0.0, 2.0), dict(shape=(3, 4)), kind="sample"),
    Case("nd.random.normal", (), dict(loc=1.0, scale=2.0, shape=(3, 4)),
         kind="sample"),
    Case("nd.random.randn", (3, 4), kind="sample"),
    Case("nd.random.gamma", (), dict(alpha=2.0, beta=0.5, shape=(3, 4)),
         kind="sample"),
    Case("nd.random.exponential", (2.0,), dict(shape=(3, 4)), kind="sample"),
    Case("nd.random.poisson", (3.0,), dict(shape=(3, 4)), kind="sample"),
    Case("nd.random.negative_binomial", (), dict(k=3, p=0.4, shape=(3, 4)),
         kind="sample"),
    Case("nd.random.generalized_negative_binomial", (),
         dict(mu=2.0, alpha=0.5, shape=(3, 4)), kind="sample"),
    Case("nd.random.randint", (0, 7), dict(shape=(3, 4)), kind="sample"),
    Case("nd.random.multinomial", (A("probs"),), dict(shape=3),
         kind="sample"),
    Case("nd.random.shuffle", (A("x2"),), kind="sample"),
]
del _ns, _name, _args, _kw


def function_of(mx, key):
    """The function a case calls in ``mx`` (either package): a registry op
    as ``mx.ndarray.register.make_eager`` wraps it, the namespace
    function, or for ``"NDArray.<name>"`` the method of the first
    argument."""
    if key.startswith("NDArray."):
        method = key.split(".", 1)[1]
        return lambda self, *a, **k: getattr(self, method)(*a, **k)
    if "." not in key:
        import importlib

        register = importlib.import_module(f"{mx.__name__}.ndarray.register")
        registry = importlib.import_module(f"{mx.__name__}.ops.registry")
        return register.make_eager(key, registry._OPS[key])
    obj = mx
    for part in key.split("."):
        obj = getattr(obj, part)
    return obj


def materialize(case, data, make):
    """``(args, kwargs)`` of ``case`` with each :class:`A` replaced by
    ``make(numpy array)``, inside lists too."""

    def fill(v):
        if isinstance(v, A):
            return make(data[v.name])
        if isinstance(v, S):
            return make(data[v.name]).tostype(v.stype)
        if isinstance(v, list):
            return [fill(x) for x in v]
        return v

    return (tuple(fill(a) for a in case.args),
            {k: fill(v) for k, v in case.kwargs.items()})


def host_leaves(out):
    """The arrays of a result, flattened, as numpy (bf16 as f32)."""
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in host_leaves(o)]
    if out is None:
        return []
    if hasattr(out, "asnumpy"):
        return [onp.asarray(out.asnumpy())]
    return [onp.asarray(out)]
