"""INT8 post-training quantization (counterpart of
mxnet_tpu/contrib/quantization.py).

The same module rewrite as the JAX package: ``quantize_net`` calibrates
each Dense/Conv2D child's input range over a few batches ('naive' min/max
or 'entropy' KL thresholds), then swaps the child for a
:class:`QuantizedDense`/:class:`QuantizedConv2D` that holds per-channel
int8 weights. Their forward quantizes the input with Q1 and multiplies
int8 by int8 into int32 with Q2, the hand-written CUDA kernels of
kernels/int8.py (the JAX package uses XLA's int8 ``dot_general`` and
``conv_general_dilated`` there; PyTorch has no int8 convolution on the
card). The int8 weights, the scales, the bias and the calibrated range
live on the layer's device from its construction, so a served forward
captures into a CUDA graph. CPU tensors take the kernels' plain versions.

The ops (``quantize``, ``quantize_v2``, ``dequantize``, ``requantize``, the
ten ``quantized_*`` ops) take and give NDArrays; their tensor forms are
the registry's ``_contrib_*`` names. Ranges are float32 scalars.
"""
from __future__ import annotations

import functools

import numpy as _np
import torch

from .. import autograd as _ag
from .. import ndarray as _ndarray
from ..gluon import nn as _gnn
from ..gluon.block import HybridBlock
from ..kernels import int8 as _int8
from ..ndarray import register as _register
from ..ndarray.ndarray import (NDArray, _host_to_tensor, apply_op,
                               creation_device)
from ..ops import nn as _nnops
from ..ops.registry import get_op, register_op

__all__ = ["quantize", "dequantize", "requantize", "quantize_v2",
           "quantize_net", "QuantizedDense", "QuantizedConv2D",
           "optimal_threshold"]

INT8_MAX = 127.0
#: the reference's ``2.0 ** 31 - 1`` (:106), which f32 arithmetic rounds to
#: 2147483648.0 as the JAX package's does
_INT32_MAX = 2.0 ** 31 - 1


# ---------------------------------------------------------------------------
# argument handling: tensors on one device
# ---------------------------------------------------------------------------

def _device_of(vals):
    for v in vals:
        if isinstance(v, NDArray):
            return v._data.device
        if isinstance(v, torch.Tensor):
            return v.device
    return creation_device()


def _tensors(*vals):
    """Each value as a tensor on the first array's device: NDArrays
    unwrapped, numpy arrays and numbers made as ``mx.np.array`` makes them
    (float64 as float32); None stays None."""
    dev = _device_of(vals)
    out = []
    for v in vals:
        if isinstance(v, NDArray):
            v = v._data
        if v is not None and not isinstance(v, torch.Tensor):
            v = _host_to_tensor(v, None, dev)
        out.append(v)
    return out


def _nd(fn, *vals, **kwargs):
    """``fn`` (a tensor op of this module) over ``vals`` as NDArrays on one
    device; NDArrays out."""
    return apply_op(lambda *ts: fn(*ts, **kwargs),
                    *[None if t is None else NDArray(t)
                      for t in _tensors(*vals)])


def _public(fn):
    """The NDArray op of the tensor form ``fn`` (``_<name>``, the
    registry's ``_contrib_<name>``): arrays in, as :func:`_nd` takes them;
    NDArrays out."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        return _nd(fn, *args, **kwargs)

    op.__name__ = op.__qualname__ = fn.__name__[1:]
    return op


def _lohi(lo, hi):
    """(lo, hi) as 2 f32 on their device: what Q1 reads."""
    if lo.numel() != 1 or hi.numel() != 1:
        raise ValueError("int8 ranges are scalars: got min of "
                         f"{tuple(lo.shape)} and max of {tuple(hi.shape)}")
    return torch.stack([lo.reshape(()), hi.reshape(())]).to(torch.float32)


def _calib_lohi(lo, hi, device):
    """A calibrated range as Q1 reads it: ``jnp.float32`` of each value."""
    return torch.tensor([float(lo), float(hi)], dtype=torch.float32,
                        device=device)


def _dynamic_lohi(x):
    """(min, max) of x on its device (no host read)."""
    lo, hi = torch.aminmax(x.to(torch.float32))
    return torch.stack([lo, hi])


def _with_range(codes, info, shape=()):
    return codes, info[0].reshape(shape), info[1].reshape(shape)


# ---------------------------------------------------------------------------
# ops (reference: quantize-inl.h, dequantize-inl.h, requantize-inl.h)
# ---------------------------------------------------------------------------

def _quantize(data, min_range, max_range, out_type="int8"):
    """fp32 -> int8 with symmetric scaling (reference: _contrib_quantize).

    Returns (q_data, min_output, max_output) like the reference op."""
    if out_type != "int8":
        raise ValueError("the int8 port quantizes to int8 only")
    x, lo, hi = _tensors(data, min_range, max_range)
    codes, info = _int8.quantize(x, _lohi(lo, hi))
    return _with_range(codes, info, torch.broadcast_shapes(lo.shape,
                                                           hi.shape))


quantize = _public(_quantize)


def _quantize_v2(data, min_calib_range=None, max_calib_range=None,
                 out_type="int8"):
    """Quantize with optional pre-computed calib range; computes min/max
    on the fly otherwise (reference: _contrib_quantize_v2)."""
    if out_type not in ("int8", "auto"):
        raise ValueError("the int8 port quantizes to int8 only")
    (x,) = _tensors(data)
    if min_calib_range is not None:
        lohi = _calib_lohi(min_calib_range, max_calib_range, x.device)
    else:
        lohi = _dynamic_lohi(x)
    return _with_range(*_int8.quantize(x, lohi))


quantize_v2 = _public(_quantize_v2)


def _dequantize(data, min_range, max_range, out_type="float32"):  # noqa: ARG001
    """int8 -> fp32 (reference: _contrib_dequantize)."""
    q, lo, hi = _tensors(data, min_range, max_range)
    return _deq(q, lo, hi)


dequantize = _public(_dequantize)


def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None):
    """int32 accumulator -> int8 with new range (reference:
    _contrib_requantize)."""
    q, lo, hi = _tensors(data, min_range, max_range)
    in_scale = _range_scale(lo, hi, _INT32_MAX)
    x = q.to(torch.float32) * in_scale
    if min_calib_range is not None:
        lohi = _calib_lohi(min_calib_range, max_calib_range, x.device)
    else:
        lohi = _dynamic_lohi(x)
    return _with_range(*_int8.quantize(x, lohi))


requantize = _public(_requantize)


# ---------------------------------------------------------------------------
# KL / entropy calibration (reference: calibrate.cc, the TensorRT
# formulation)
# ---------------------------------------------------------------------------

def optimal_threshold(arr, num_bins=2048, num_quantized_bins=128):
    """KL-optimal |threshold| for symmetric int8 quantization.

    One-sided |x| histogram; for each candidate clip point, the reference
    distribution p folds clipped outlier mass into its edge bin while the
    candidate q is built from the *unclipped* bins only — so over-clipping
    shows up as divergence at the edge (the calibrate.cc / TensorRT
    formulation).

    The JAX package's code (:134) with one change of form: each candidate
    q is spread from its merged bins' sums with ``np.add.reduceat`` and
    ``np.repeat`` instead of a Python loop over the 128 bins. The
    histogram holds integer counts, so those sums are exact in float64 in
    any order, each spread value is the same ``sum / nonzero`` division,
    and every later step (p, the sums of p and q, KL) is the reference's
    own: the thresholds are bit for bit the reference's, about 20 times
    faster. ``arr`` may be a numpy array, a tensor or an NDArray."""
    if isinstance(arr, NDArray):
        arr = arr._data
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().to("cpu", torch.float32).numpy()
    arr = _np.abs(_np.asarray(arr).ravel())
    amax = float(arr.max()) if arr.size else 0.0
    if amax == 0:
        return 1e-8
    if arr.size < 4 * num_quantized_bins:
        # too few samples for a meaningful histogram — KL on a sparse
        # histogram picks arbitrary clip points; use max (naive) instead
        return amax
    hist, edges = _np.histogram(arr, bins=num_bins, range=(0.0, amax))
    hist = hist.astype(_np.float64)
    nonzero = (hist > 0).astype(_np.int64)
    width = edges[1] - edges[0]
    best_kl, best_t = _np.inf, amax
    eps = 1e-10
    for i in range(num_quantized_bins, num_bins + 1):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()        # clipped mass -> edge bin
        psum = p.sum()
        if psum == 0:
            continue
        ref = hist[:i]                    # q comes from unclipped counts
        num_merged = i // num_quantized_bins
        # merged bin j spans [j * num_merged, (j + 1) * num_merged), the
        # last one up to i
        starts = _np.arange(num_quantized_bins) * num_merged
        sums = _np.add.reduceat(ref, starts)
        nz = _np.add.reduceat(nonzero[:i], starts)
        mean = _np.divide(sums, nz, out=_np.zeros(num_quantized_bins),
                          where=nz > 0)
        q = _np.where(ref > 0, _np.repeat(mean, _np.diff(starts, append=i)),
                      0.0)
        qsum = q.sum()
        if qsum == 0:
            continue
        pn = p / psum
        qn = q / qsum
        mask = pn > 0
        kl = float((pn[mask] * _np.log(
            pn[mask] / _np.maximum(qn[mask], eps))).sum())
        if kl < best_kl:
            best_kl = kl
            best_t = (i + 0.5) * width
    return min(best_t, amax)


def _calibrate_entropy(arr, num_bins=2048, num_quantized_bins=128):
    """The registry's form of :func:`optimal_threshold`: the threshold as a
    0-d float32 tensor on the samples' device, as the JAX package's
    ``mx.nd._contrib_calibrate_entropy`` gives it."""
    (t,) = _tensors(arr)
    return torch.tensor(optimal_threshold(t, num_bins, num_quantized_bins),
                        dtype=torch.float32, device=t.device)


class _LayerCollector:
    """Collects per-layer input ranges during calibration forward passes
    (reference: calibration collector in quantization.py); samples stay on
    the host."""

    def __init__(self, mode):
        self.mode = mode
        self.samples = {}   # layer id -> list of np arrays (entropy)
        self.ranges = {}    # layer id -> (lo, hi)

    def collect(self, key, arr):
        a = _np.asarray(arr)
        if self.mode == "entropy":
            self.samples.setdefault(key, []).append(a.ravel())
        lo, hi = float(a.min()), float(a.max())
        if key in self.ranges:
            plo, phi = self.ranges[key]
            lo, hi = min(lo, plo), max(hi, phi)
        self.ranges[key] = (lo, hi)

    def threshold(self, key):
        if self.mode == "entropy" and key in self.samples:
            t = optimal_threshold(_np.concatenate(self.samples[key]))
            return (-t, t)
        lo, hi = self.ranges[key]
        t = max(abs(lo), abs(hi))
        return (-t, t)


# ---------------------------------------------------------------------------
# quantized layers (reference: quantized_fully_connected.cc,
# quantized_conv.cc — int8 gemm/conv with int32 accumulation)
# ---------------------------------------------------------------------------

def _quantize_weight_per_channel(w):
    """Per-output-channel symmetric int8 weights (the higher-accuracy
    channel-wise mode of the reference)."""
    axis = tuple(range(1, w.ndim))
    amax = _np.maximum(_np.abs(_np.asarray(w)).max(axis=axis), 1e-20)
    scale = INT8_MAX / amax
    wq = _np.clip(_np.round(_np.asarray(w) * scale.reshape(
        (-1,) + (1,) * (w.ndim - 1))), -127, 127).astype(_np.int8)
    return wq, scale.astype(_np.float32)


class _Quantized(HybridBlock):
    """The int8 weights, per-channel scales, bias and calibrated input
    range of a quantized layer, as buffers on the layer's device (made once
    here, so that a served forward replays from a CUDA graph)."""

    def __init__(self, layer, out_range):
        super().__init__()
        w = _np.asarray(layer.weight.data().asnumpy(), dtype=_np.float32)
        wq, wscale = _quantize_weight_per_channel(w)
        dev = layer.weight.device
        bias = None if layer.bias is None else torch.as_tensor(
            _np.asarray(layer.bias.data().asnumpy(), dtype=_np.float32),
            device=dev)
        self.register_buffer("_wq", torch.from_numpy(wq).to(dev),
                             persistent=False)
        self.register_buffer("_wscale", torch.from_numpy(wscale).to(dev),
                             persistent=False)
        self.register_buffer("_bias", bias, persistent=False)
        self.register_buffer(
            "_lohi", None if out_range is None else _calib_lohi(
                out_range[0], out_range[1], dev), persistent=False)
        object.__setattr__(self, "_activation",
                           getattr(layer, "_activation", None))
        object.__setattr__(self, "_out_range", out_range)

    def _quantize_input(self, x):
        """Q1 on the input: clipped to the calibrated range where there is
        one, else over its own min and max."""
        if self._lohi is None:
            return _int8.quantize(x, _dynamic_lohi(x))
        return _int8.quantize(x, self._lohi, clip=True)

    def _finish(self, y):
        act = self._activation
        if act is not None and act != "relu":   # relu is fused into Q2
            y = _nnops.activation(y, act)
        return y


class QuantizedDense(_Quantized):
    """int8 x int8 -> int32 matmul + fp32 rescale (reference:
    quantized_fully_connected.cc), through Q2 as a 1x1 convolution."""

    def __init__(self, dense, out_range=None):
        super().__init__(dense, out_range)
        object.__setattr__(self, "_flatten", getattr(dense, "_flatten",
                                                     True))

    def forward(self, x):
        if self._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        xq, info = self._quantize_input(x)
        o, k = self._wq.shape
        lead = xq.shape[:-1]
        y = _int8.conv(xq.reshape(-1, k, 1, 1), self._wq.view(o, k, 1, 1),
                       xscale=info[2:3], wscale=self._wscale,
                       bias=self._bias, relu=self._activation == "relu")
        return self._finish(y.reshape(*lead, o))


class QuantizedConv2D(_Quantized):
    """int8 conv with int32 accumulation (reference: quantized_conv.cc),
    NCHW/OIHW as the reference computes it."""

    def __init__(self, conv, out_range=None):
        layout = getattr(conv, "_layout", "NCHW")
        if layout != "NCHW":
            # the reference reads x and the weight as NCHW/OIHW whatever
            # the layer's layout (:310), which is wrong for NHWC
            raise NotImplementedError(
                f"QuantizedConv2D takes NCHW convolutions, not {layout}")
        super().__init__(conv, out_range)
        for name in ("_strides", "_padding", "_dilation"):
            object.__setattr__(self, name, tuple(getattr(conv, name)))
        object.__setattr__(self, "_groups", conv._groups)

    def forward(self, x):
        xq, info = self._quantize_input(x)
        y = _int8.conv(xq, self._wq, self._strides, self._padding,
                       self._dilation, self._groups, xscale=info[2:3],
                       wscale=self._wscale, bias=self._bias,
                       relu=self._activation == "relu")
        return self._finish(y)


# ---------------------------------------------------------------------------
# model conversion (reference: quantize_net / quantize_model)
# ---------------------------------------------------------------------------

def _targets(network, exclude):
    """``(parent, name, dotted name, child)`` of every Dense and Conv2D
    child to quantize, in the reference's walk order."""
    targets = []

    def walk(block, prefix):
        for name, child in list(block._modules.items()):
            full = f"{prefix}.{name}" if prefix else name
            if isinstance(child, (_gnn.Dense, _gnn.Conv2D)) \
                    and full not in exclude and name not in exclude:
                targets.append((block, name, full, child))
            else:
                walk(child, full)

    walk(network, "")
    return targets


def _calib_hook(collector, key):
    def hook(block, inputs, out):  # noqa: ARG001
        # calibrate the layer INPUT distribution — that's what gets
        # quantized to int8 (the reference inserts its quantize node on the
        # input edge)
        x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        if isinstance(x, NDArray):
            x = x._data
        collector.collect(key, x.detach().to("cpu", torch.float32).numpy())
    return hook


def _swap(targets, ranges):
    """Replace each target by its quantized block, with ``ranges[name]``
    (or None: a dynamic input range)."""
    for parent, name, full, child in targets:
        rng = ranges.get(full)
        if isinstance(child, _gnn.Dense):
            q = QuantizedDense(child, rng)
        else:
            q = QuantizedConv2D(child, rng)
        parent._modules[name] = q


def quantize_net(network, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=None,
                 num_calib_batches=None, **kwargs):  # noqa: ARG001
    """Post-training quantization of a HybridBlock (reference:
    contrib.quantization.quantize_net).

    Runs calibration batches through the fp32 net while collecting each
    Dense/Conv2D input distribution (forward hooks, removed afterwards),
    computes thresholds ('naive' min/max or 'entropy' KL), then swaps those
    children for int8 blocks. Returns the network, modified in place. A
    hybridized net is calibrated eagerly and hybridized again after; the
    CUDA graphs captured of its fp32 forward are dropped.
    """
    if quantized_dtype != "int8":
        raise ValueError("the int8 port supports int8")
    exclude = set(exclude_layers or ())
    targets = _targets(network, exclude)

    collector = _LayerCollector(calib_mode)
    if calib_data is not None and calib_mode != "none":
        was_active = getattr(network, "_active", False)
        if was_active:
            network.hybridize(False)
        handles = [child.register_forward_hook(_calib_hook(collector, full))
                   for _, _, full, child in targets]
        try:
            dev = network.device
            n = 0
            for batch in calib_data:
                x = batch[0] if isinstance(batch, (list, tuple)) else batch
                if not isinstance(x, (NDArray, torch.Tensor)):
                    x = _host_to_tensor(_np.asarray(x), None, dev)
                with _ag.pause():
                    network(x)
                n += 1
                if num_calib_batches and n >= num_calib_batches:
                    break
        finally:
            for h in handles:
                h.remove()
            if was_active:
                network.hybridize(True)

    _swap(targets, {full: collector.threshold(full)
                    for _, _, full, _ in targets if full in collector.ranges})
    network._clear_cached()
    return network


# --- quantized compute ops (reference: src/operator/quantization/
# quantized_*.cc). Each takes int8 data + (min, max) ranges, computes in the
# dequantized domain, and re-quantizes with Q1; the int8 products of
# quantized_conv and quantized_fully_connected are Q2's int32 sums. -------

def _range_scale(lo, hi, top):
    """``max(|lo|, |hi|) / top`` as the reference's f32 quotient: a tensor
    over a tensor, since torch's ``tensor / float`` on the card multiplies
    by the reciprocal."""
    return torch.maximum(lo.abs(), hi.abs()) / torch.tensor(
        top, dtype=torch.float32, device=lo.device)


def _deq(x, lo, hi):
    return x.to(torch.float32) * _range_scale(lo, hi, INT8_MAX)


def _req(x):
    return _with_range(*_int8.quantize(x, _dynamic_lohi(x)))


def _act_fn(x, act_type="relu"):
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return torch.logaddexp(x, torch.zeros_like(x))
    raise ValueError(f"unknown act_type {act_type!r}")


def _quantized_act(data, min_data, max_data, **kwargs):
    """int8 activation (reference: quantized_activation.cc): dequantize,
    ``act_type``, requantize over the result's range."""
    x, lo, hi = _tensors(data, min_data, max_data)
    return _req(_act_fn(_deq(x, lo, hi), **kwargs))


quantized_act = _public(_quantized_act)


def _quantized_flatten(data, min_data, max_data):
    """Pure reshape — int8 codes and ranges pass through unchanged
    (reference: quantized_flatten.cc forwards min/max untouched)."""
    x, lo, hi = _tensors(data, min_data, max_data)
    return x.reshape(x.shape[0], -1), lo, hi


quantized_flatten = _public(_quantized_flatten)


def _quantized_pooling(data, min_data, max_data, kernel=(2, 2),
                       pool_type="max", stride=None, pad=None,
                       global_pool=False, ceil_mode=False,
                       pooling_convention=None, layout=None, **kwargs):  # noqa: ARG001
    """int8 pooling (reference: quantized_pooling.cc) — honors the same
    pooling conventions as the fp op so int8 and fp32 graphs agree on
    shapes."""
    x, lo, hi = _tensors(data, min_data, max_data)
    out = get_op("pooling")(
        _deq(x, lo, hi), kernel=kernel, pool_type=pool_type, stride=stride,
        pad=pad, global_pool=global_pool, ceil_mode=ceil_mode,
        pooling_convention=pooling_convention, layout=layout)
    return _req(out)


quantized_pooling = _public(_quantized_pooling)


def _quantized_elemwise_add(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    """int8 add with range tracking (reference:
    quantized_elemwise_add.cc)."""
    a, b, alo, ahi, blo, bhi = _tensors(lhs, rhs, lhs_min, lhs_max, rhs_min,
                                        rhs_max)
    return _req(_deq(a, alo, ahi) + _deq(b, blo, bhi))


quantized_elemwise_add = _public(_quantized_elemwise_add)


def _quantized_elemwise_mul(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    """int8 multiply with range tracking."""
    a, b, alo, ahi, blo, bhi = _tensors(lhs, rhs, lhs_min, lhs_max, rhs_min,
                                        rhs_max)
    return _req(_deq(a, alo, ahi) * _deq(b, blo, bhi))


quantized_elemwise_mul = _public(_quantized_elemwise_mul)


def _quantized_concat(*args, dim=1, num_args=None):  # noqa: ARG001
    """Concat n int8 inputs: args = [d0..dn-1, min0, max0, ... ] in the
    reference's layout (data list then interleaved ranges)."""
    n = len(args) // 3
    ts = _tensors(*args)
    datas, ranges = ts[:n], ts[n:]
    outs = [_deq(d, ranges[2 * i], ranges[2 * i + 1])
            for i, d in enumerate(datas)]
    return _req(torch.cat(outs, dim=dim))


quantized_concat = _public(_quantized_concat)


def _quantized_embedding(data, weight, min_weight, max_weight,
                         input_dim=None, output_dim=None, **kwargs):  # noqa: ARG001
    """int8 embedding lookup (reference: quantized_embedding.cc)."""
    idx, w, lo, hi = _tensors(data, weight, min_weight, max_weight)
    return _req(_deq(w, lo, hi)[idx.to(torch.int64)])


quantized_embedding = _public(_quantized_embedding)


def _quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                          min_data, max_data, eps=1e-3, **kwargs):  # noqa: ARG001
    """int8 inference BatchNorm (reference: quantized_batch_norm.cc)."""
    x, g, b, mm, mv, lo, hi = _tensors(data, gamma, beta, moving_mean,
                                       moving_var, min_data, max_data)
    xf = _deq(x, lo, hi)
    shape = (1, -1) + (1,) * (xf.dim() - 2)
    out = (xf - mm.reshape(shape)) / torch.sqrt(
        mv.reshape(shape) + eps) * g.reshape(shape) + b.reshape(shape)
    return _req(out)


quantized_batch_norm = _public(_quantized_batch_norm)


def _quantized_operands(data, weight, bias, min_data, max_data, min_weight,
                        max_weight, min_bias, max_bias, no_bias):
    """The tensors of quantized_conv's and quantized_fully_connected's
    operands; the bias and its range None under ``no_bias``."""
    if no_bias:
        bias = min_bias = max_bias = None
    return _tensors(data, weight, bias, min_data, max_data, min_weight,
                    max_weight, min_bias, max_bias)


def _rescale_req(acc, dlo, dhi, wlo, whi, b, blo, bhi, bias_shape):
    dscale = _range_scale(dlo, dhi, INT8_MAX)
    wscale = _range_scale(wlo, whi, INT8_MAX)
    out = acc.to(torch.float32) * (dscale * wscale)
    if b is not None:
        out = out + _deq(b, blo, bhi).reshape(bias_shape)
    return _req(out)


def _quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                    max_weight, min_bias=None, max_bias=None, kernel=None,
                    stride=(1, 1), pad=(0, 0), dilate=(1, 1), num_filter=0,
                    num_group=1, no_bias=False, **kwargs):  # noqa: ARG001
    """int8 convolution: int8 x int8 -> int32 sums (Q2), rescaled to the fp
    range product and requantized (reference: quantized_conv.cc)."""
    x, w, b, dlo, dhi, wlo, whi, blo, bhi = _quantized_operands(
        data, weight, bias, min_data, max_data, min_weight, max_weight,
        min_bias, max_bias, no_bias)
    acc = _int8.conv(x.to(torch.int8), w.to(torch.int8), stride, pad, dilate,
                     num_group)
    return _rescale_req(acc, dlo, dhi, wlo, whi, b, blo, bhi, (1, -1, 1, 1))


quantized_conv = _public(_quantized_conv)


def _quantized_fully_connected(data, weight, bias, min_data, max_data,
                               min_weight, max_weight, min_bias=None,
                               max_bias=None, num_hidden=0, no_bias=False,
                               flatten=True, **kwargs):  # noqa: ARG001
    """int8 dense: int8 x int8 -> int32 sums (Q2, a 1x1 convolution), then
    as quantized_conv (reference: quantized_fully_connected.cc)."""
    x, w, b, dlo, dhi, wlo, whi, blo, bhi = _quantized_operands(
        data, weight, bias, min_data, max_data, min_weight, max_weight,
        min_bias, max_bias, no_bias)
    xm = x.reshape(x.shape[0], -1) if flatten else x
    o, k = w.shape
    lead = xm.shape[:-1]
    acc = _int8.conv(xm.to(torch.int8).reshape(-1, k, 1, 1),
                     w.to(torch.int8).reshape(o, k, 1, 1)).reshape(*lead, o)
    return _rescale_req(acc, dlo, dhi, wlo, whi, b, blo, bhi, (-1,))


quantized_fully_connected = _public(_quantized_fully_connected)


# the registry's _contrib_* spellings (mxnet_tpu/ops/aliases.py:213-221,
# :497-506), installed into mx.nd as the JAX package's namespace has them
_REGISTERED = {
    "quantize": _quantize, "quantize_v2": _quantize_v2,
    "dequantize": _dequantize, "requantize": _requantize,
    "calibrate_entropy": _calibrate_entropy,
    "quantized_act": _quantized_act, "quantized_flatten": _quantized_flatten,
    "quantized_pooling": _quantized_pooling,
    "quantized_elemwise_add": _quantized_elemwise_add,
    "quantized_elemwise_mul": _quantized_elemwise_mul,
    "quantized_concat": _quantized_concat,
    "quantized_embedding": _quantized_embedding,
    "quantized_batch_norm": _quantized_batch_norm,
    "quantized_conv": _quantized_conv,
    "quantized_fully_connected": _quantized_fully_connected,
}
for _name, _fn in _REGISTERED.items():
    register_op(f"_contrib_{_name}", _fn)


_register.populate(vars(_ndarray), predicate=lambda n: n.startswith(
    "_contrib_") and n[len("_contrib_"):] in _REGISTERED)
del _name, _fn
