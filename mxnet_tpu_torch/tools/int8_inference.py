"""INT8 ResNet-50 inference, BASELINE config #5 (the counterpart of
``bench.py:bench_int8_agreement`` at full width):

    python -m mxnet_tpu_torch.tools.int8_inference

Builds ``resnet50_v1(classes=1000)`` in f32 NCHW (the reference's default
layout) from seed 0, hybridizes it, calibrates it with
``quantize_net(calib_mode="entropy")`` over synthetic batches (4 of 8
images, bench.py's count), which swaps its 53 convolutions and its Dense
for int8 blocks (Q1 and Q2 on the card; BatchNorm, ReLU, the adds and the
pools stay f32), and serves it through ``InferenceEngine`` with captured
rungs at batch 1, 8 and 32. Prints, one JSON line each: the calibration's
host seconds and the swapped children; the 24 served requests (outcomes,
batches by rung, Q1 and Q2 launches counted from the rungs' replays);
int8 against fp32 top-1 agreement over 8 batches of 32 (random weights:
an indication, no gate) and the forwards' ms at batch 32 (a captured rung
each), with the card's name. Needs a card.
"""
from __future__ import annotations

import json
import time

import numpy as onp
import torch

from .. import device as _device
from ..contrib import quantization as qz
from ..gluon.model_zoo.vision import resnet50_v1
from ..kernels import build as _build
from ..kernels import int8 as _int8
from ..ndarray.ndarray import array
from ..serving import InferenceEngine

__all__ = ["RUNGS", "IMAGE", "build_int8_resnet50", "int8_layers",
           "cpu_twin", "serve", "agreement", "forward_ms"]

RUNGS = (1, 8, 32)
IMAGE = (3, 224, 224)


def _resnet50(device, seed):
    net = resnet50_v1(classes=1000)
    net.initialize(device=device,
                   generator=torch.Generator().manual_seed(seed))
    return net


def _copy_params(src, dst):
    """``dst``'s parameters take ``src``'s values (same names), on dst's
    devices."""
    theirs = src.collect_params()
    for name, p in dst.collect_params().items():
        p.set_data(theirs[name].data()._data.to(p.device))


def build_int8_resnet50(device=None, seed=0, calib_batches=4, calib_batch=8,
                        calib_mode="entropy"):
    """``(fp32_net, int8_net, info)``: two hybridized ResNet-50 v1 nets
    with the same weights from ``seed``, the second calibrated on
    ``calib_batches`` synthetic batches of ``calib_batch`` images and
    quantized in place; ``info``: calibration host seconds, mode, batches,
    and the children swapped by type."""
    dev = _device.resolve(device)
    rs = onp.random.RandomState(seed)
    calib = [array(rs.rand(calib_batch, *IMAGE).astype("f"), device=dev)
             for _ in range(calib_batches)]
    fp32, net = _resnet50(dev, seed), _resnet50(dev, seed)
    for n in (fp32, net):
        n(calib[0][:1])          # settle the deferred shapes
    _copy_params(fp32, net)
    fp32.hybridize()
    net.hybridize()
    t0 = time.perf_counter()
    qz.quantize_net(net, calib_data=calib, calib_mode=calib_mode)
    seconds = time.perf_counter() - t0
    kinds = {}
    for _, layer in int8_layers(net):
        kinds[type(layer).__name__] = kinds.get(type(layer).__name__, 0) + 1
    return fp32, net, dict(calib_host_s=seconds, calib_mode=calib_mode,
                           calib_batches=calib_batches,
                           calib_batch=calib_batch, swapped=kinds)


def int8_layers(net):
    """``[(dotted name, quantized layer)]`` of ``net`` in module order."""
    return [(name, m) for name, m in net.named_modules()
            if isinstance(m, (qz.QuantizedConv2D, qz.QuantizedDense))]


def cpu_twin(int8_net, fp32_net, seed=0):
    """The same quantized net on the CPU (the kernels' plain versions):
    ResNet-50 v1 with ``fp32_net``'s weights, each Dense and Conv2D swapped
    with the calibrated range of its counterpart in ``int8_net``."""
    cpu = torch.device("cpu")
    net = _resnet50(cpu, seed)
    net(torch.zeros((1,) + IMAGE))
    _copy_params(fp32_net, net)
    ranges = {name: layer._out_range for name, layer in int8_layers(
        int8_net)}
    qz._swap(qz._targets(net, set()), ranges)
    return net


def serve(net, requests, seed=0, max_inflight=2):
    """Warm the engine's rungs (one CUDA graph each), then answer
    ``requests`` requests of 1-8 images, the launch counts zeroed just
    before and read just after: all but the last two queued before the
    engine starts (packed into batches of up to 32 rows), then one of 1
    image and one of 2-8, each alone, so that every rung serves. Returns
    ``(results, summary)``."""
    eng = InferenceEngine(net, name="resnet50_int8",
                          max_batch_size=RUNGS[-1], buckets=RUNGS,
                          timeout_ms=0, max_inflight=max_inflight)
    warm = eng.warmup(onp.zeros((1,) + IMAGE, "f"))
    rs = onp.random.RandomState(seed + 1)
    rows = min(8, RUNGS[-1])
    sizes = [int(rs.randint(1, rows + 1)) for _ in range(requests - 2)]
    sizes += [1, int(rs.randint(2, rows + 1))]
    batches = [rs.rand(n, *IMAGE).astype("f") for n in sizes]
    captures = net.capture_count()
    _build.reset_counters()                 # main path: counts from 0
    t0 = time.perf_counter()
    handles = [eng.submit(x) for x in batches[:-2]]
    eng.start()
    results = [h.result(timeout=600) for h in handles]
    results += [eng.submit(x).result(timeout=600) for x in batches[-2:]]
    wall = time.perf_counter() - t0
    eng.stop()
    launches = {_int8.KERNEL_QUANT: _int8.LAUNCHES_QUANT.value,
                _int8.KERNEL_CONV: _int8.LAUNCHES_CONV.value}
    st = eng.stats()
    return list(zip(batches, results)), dict(
        warmup=warm, requests=len(batches), outcomes=st["requests"],
        batches=st["dispatches"], by_rung=eng.bucket_dispatches(),
        rows=sum(len(b) for b in batches),
        captures_after_warmup=net.capture_count() - captures,
        recompiles_since_warmup=st["recompiles_since_warmup"],
        launches=launches, wall_s=wall)


def agreement(fp32_net, int8_net, batches=8, batch=32, seed=0):
    """int8 against fp32 top-1 agreement over ``batches`` synthetic batches
    (both through their captured rung of ``batch``)."""
    dev = int8_net.device
    rs = onp.random.RandomState(seed + 2)
    agree = total = 0
    for _ in range(batches):
        x = torch.from_numpy(rs.rand(batch, *IMAGE).astype("f")).to(dev)
        ref = fp32_net.call_cached_graph(x).argmax(-1)
        got = int8_net.call_cached_graph(x).argmax(-1)
        agree += int((ref == got).sum())
        total += batch
    return agree / total


def forward_ms(net, batch=32, iters=20):
    """ms of one forward at ``batch`` through its captured rung (CUDA
    events around ``iters`` replays, after a warm-up)."""
    x = torch.rand((batch,) + IMAGE, device=net.device)
    for _ in range(3):
        net.call_cached_graph(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        net.call_cached_graph(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("int8_inference measures the card: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _device.default_device()
    fp32, net, info = build_int8_resnet50(dev)
    print("int8_calibration " + json.dumps(info), flush=True)
    _, served = serve(net, 24)
    print("int8_serving " + json.dumps(served), flush=True)
    out = dict(agreement_top1=agreement(fp32, net),
               int8_forward_ms_batch32=forward_ms(net),
               fp32_forward_ms_batch32=forward_ms(fp32),
               card=torch.cuda.get_device_name(0))
    print("int8_inference " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
