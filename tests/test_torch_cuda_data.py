"""The DataLoader on the card: the device-prefetch stage (pinned host
memory, a side stream the consumer waits on), fork workers started after
CUDA is initialised, and thread-pool collation onto the consumer's device
(``cuda:0`` outside a scope, the CPU inside ``with mx.cpu():``). Each
mode's batches equal those of the loader run in the caller on the CPU.
Marked ``cuda``; skips without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_data.py
"""
import contextlib
import multiprocessing as mp

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.data.dataloader import _host_tensor
from mxnet_tpu_torch.telemetry import instruments as inst


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _dataset():
    r = onp.random.RandomState(8)
    return mt.gluon.data.ArrayDataset(
        r.randint(0, 255, (70, 32, 32, 3)).astype("uint8"),
        r.randint(0, 10, (70,)).astype("int32"))


def _epoch(scope=None, **kw):
    onp.random.seed(4)
    dl = mt.gluon.data.DataLoader(_dataset(), batch_size=16, shuffle=True,
                                  timeout=60, **kw)
    try:
        with scope if scope is not None else contextlib.nullcontext():
            batches = [(x, y) for x, y in dl]
            torch.cuda.synchronize()
    finally:
        dl.close()
    assert not mp.active_children()
    return dl, batches


def _host(batches):
    return [(x.asnumpy(), y.asnumpy()) for x, y in batches]


def _same(got, want):
    assert len(got) == len(want) == 5
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == onp.uint8 and gy.dtype == onp.int32
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()


@pytest.mark.cuda
def test_device_prefetch_pins_and_copies_on_a_side_stream():
    _need_card()
    _, want = _epoch(mt.cpu())
    assert _host_tensor(onp.zeros(4, "uint8"), True).is_pinned()
    before = inst.data_prefetch_total.value
    dl, got = _epoch(device_prefetch=2, pin_memory=True)
    assert all(x._data.device == mt.gpu(0) for x, _ in got)
    _same(_host(got), _host(want))
    assert inst.data_prefetch_total.value - before == 5
    assert dl.prefetch_streams and all(
        side != consumer for side, consumer in dl.prefetch_streams)
    assert torch.cuda.current_stream().stream_id in {
        c for _, c in dl.prefetch_streams}


@pytest.mark.cuda
def test_fork_workers_after_cuda_is_initialised():
    _need_card()
    torch.zeros(1, device="cuda").add_(1)
    assert torch.cuda.is_initialized()
    _, want = _epoch(mt.cpu())
    dl, got = _epoch(num_workers=2)
    assert all(x._data.device == mt.gpu(0) for x, _ in got)
    _same(_host(got), _host(want))


@pytest.mark.cuda
def test_thread_pool_collates_onto_the_consumers_device():
    _need_card()
    _, want = _epoch(mt.cpu())
    _, on_card = _epoch(num_workers=3, thread_pool=True)
    _, on_cpu = _epoch(mt.cpu(), num_workers=3, thread_pool=True,
                       device_prefetch=2)
    assert all(x._data.device == mt.gpu(0) for x, _ in on_card)
    assert all(x._data.device.type == "cpu" for x, _ in on_cpu)
    _same(_host(on_card), _host(want))
    _same(_host(on_cpu), _host(want))
