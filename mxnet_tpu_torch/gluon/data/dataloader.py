"""DataLoader (counterpart of mxnet_tpu/gluon/data/dataloader.py).

Worker modes, as in the JAX package:
  * ``num_workers=0``: samples are loaded and collated in the caller.
  * ``num_workers>0`` (fork workers): a ``multiprocessing`` pool whose
    workers index the dataset and return its numpy samples; the parent
    collates them with the batchify function. Workers never touch torch's
    CUDA state, so they may fork from a parent that has initialised it. A
    dataset whose first sample holds an NDArray or a tensor takes the
    thread path instead (:meth:`DataLoader._fork_safe`).
  * ``num_workers>0, thread_pool=True``: a pool of ``num_workers`` Python
    threads loads and collates batches to numpy (the JAX package's native
    pipeline, ``_native_iter``, waits with its native runtime).

Whatever the mode, batches come in the sampler's order, and the last step,
making device arrays of the numpy batch, runs in the consumer's thread on
the device current when the iteration began (``with mx.cpu():`` is
thread-local). Outside a device scope that is ``cuda:0``, and without a
card the iteration raises: nothing falls back to the CPU.

``device_prefetch=N`` (default ``MXTPU_DEVICE_PREFETCH``) keeps up to N
batches beyond the one being consumed already copied to the card: each
batch's numpy leaves are put in pinned host memory and copied on a side
CUDA stream, whose event the consumer's stream waits on before the batch
is handed out (``record_stream`` keeps the caching allocator from reusing
a buffer still in flight). On the CPU the stage only makes the arrays.
"""
from __future__ import annotations

import collections
import multiprocessing as _mp
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as _np
import torch

from ... import env as _env
from ...device import current_device
from ...diagnostics import spans as _spans
from ...ndarray.ndarray import NDArray
from ...telemetry import instruments as _telemetry
from .batchify import default_batchify_fn, map_leaves, place
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]

# -- fork workers: the dataset is inherited copy-on-write at fork; only
# indices go out and samples come back
_WORKER_DATASET = None


def _mp_worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _mp_worker_fn(indices):
    """The samples at ``indices``; collation happens in the parent."""
    return [_WORKER_DATASET[i] for i in indices]


def _host_tensor(arr, pin):
    """A CPU tensor of ``arr`` with ``mx.np.array``'s creation defaults
    (float64 -> float32, int64 -> int32), pinned if ``pin``."""
    t = torch.from_numpy(_np.ascontiguousarray(arr))
    if t.dtype == torch.float64:
        t = t.float()
    elif t.dtype == torch.int64:
        t = t.int()
    return t.pin_memory() if pin else t


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, NDArray):
        yield tree


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120, try_nopython=None,  # noqa: ARG002
                 device_prefetch=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required without batch_sampler")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle and sampler are exclusive")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None \
                or last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not "
                "be specified if batch_sampler is specified")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._thread_pool = bool(thread_pool)
        self._mp_pool = None
        self._fork_safe_cache = None
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._device_prefetch = device_prefetch
        self._batchify_fn = batchify_fn or default_batchify_fn
        # the numpy half of a batchify function of batchify.py; a user's
        # function has none and runs whole in the consumer
        self._host = getattr(self._batchify_fn, "host", None)
        #: (copy stream, consumer stream) ids the prefetch stage has used
        self.prefetch_streams = set()

    def __iter__(self):
        device = current_device()
        it = self._iter_impl()
        depth = self._device_prefetch
        if depth is None:
            depth = _env.get("MXTPU_DEVICE_PREFETCH")
        if depth and depth > 0:
            it = self._device_prefetch_iter(it, int(depth), device)
        else:
            it = (self._finish(item, device) for item in it)
        while True:
            with _spans.span("dataloader_next", cat="data"):
                try:
                    batch = next(it)
                except StopIteration:
                    return
            yield batch

    def __len__(self):
        return len(self._batch_sampler)

    # -- the consumer's half ---------------------------------------------
    def _finish(self, item, device, stream=None, prefetch=False):
        """The batch of ``item`` (a numpy batch, or the samples for a
        user's batchify function) with its numpy leaves made NDArrays on
        ``device``. On a card they are copied on ``stream`` (None: the
        current one), from pinned memory in the prefetch stage or with
        ``pin_memory``. The prefetch stage counts their bytes as ``h2d``
        transfers."""
        tree = item if self._host is not None else self._batchify_fn(item)
        if prefetch:
            map_leaves(tree, lambda x: _telemetry.record_transfer(
                "h2d", x.nbytes) if isinstance(x, _np.ndarray) else None)
        if device.type != "cuda":
            return place(tree, device)
        pin = prefetch or self._pin_memory

        def put(x):
            if isinstance(x, _np.ndarray):
                return NDArray(_host_tensor(x, pin).to(device,
                                                       non_blocking=pin))
            if isinstance(x, NDArray) and x._data.device != device:
                return NDArray(x._data.to(device, non_blocking=True))
            return x

        if stream is None:
            return map_leaves(tree, put)
        with torch.cuda.stream(stream):
            return map_leaves(tree, put)

    def _device_prefetch_iter(self, it, depth, device):
        """Hold up to ``depth`` batches beyond the consumed one with their
        copies issued; each is handed out after the consumer's stream has
        waited on its copy's event. The copies need not wait for the
        consumer: they write fresh blocks, and a block an earlier batch
        held is reused only after the consumer's work on it
        (``record_stream``)."""
        cuda = device.type == "cuda"
        side = torch.cuda.Stream(device) if cuda else None
        pending = collections.deque()

        def top_up():
            while len(pending) <= depth:
                try:
                    item = next(it)
                except StopIteration:
                    return
                with _spans.span("device_prefetch", cat="data"):
                    batch = self._finish(item, device, side, prefetch=True)
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(side)
                    pending.append((batch, event))
                _telemetry.record_device_prefetch(len(pending))

        top_up()
        while pending:
            batch, event = pending.popleft()
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                self.prefetch_streams.add((side.stream_id,
                                           consumer.stream_id))
                for leaf in _leaves(batch):
                    leaf._data.record_stream(consumer)
            top_up()
            yield batch

    # -- the producers ----------------------------------------------------
    def _load(self, indices):
        samples = [self._dataset[i] for i in indices]
        return samples if self._host is None else self._host(samples)

    def _iter_impl(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._load(indices)
            return
        if not self._thread_pool and self._fork_safe():
            yield from self._mp_iter()
            return
        yield from self._threaded_iter()

    def _fork_safe(self):
        """Fork workers only index numpy data: a dataset whose first sample
        holds an NDArray or a tensor takes the thread path."""
        def has_tensor(x):
            if isinstance(x, (tuple, list)):
                return any(has_tensor(i) for i in x)
            if isinstance(x, dict):
                return any(has_tensor(v) for v in x.values())
            return isinstance(x, (NDArray, torch.Tensor))

        if self._fork_safe_cache is None:
            try:
                self._fork_safe_cache = (len(self._dataset) == 0
                                         or not has_tensor(self._dataset[0]))
            except Exception:
                self._fork_safe_cache = False
        return self._fork_safe_cache

    def _mp_iter(self):
        """Worker processes load the samples of up to ``prefetch`` batches
        ahead; the parent collates them in the sampler's order."""
        batches = list(self._batch_sampler)
        if not batches:
            return
        pool = self._ensure_pool()
        window = max(self._prefetch, 1)
        pending = collections.deque()
        try:
            submitted = 0
            while pending or submitted < len(batches):
                while submitted < len(batches) and len(pending) < window:
                    pending.append(pool.apply_async(
                        _mp_worker_fn, (batches[submitted],)))
                    submitted += 1
                samples = pending.popleft().get(timeout=self._timeout)
                yield samples if self._host is None else self._host(samples)
        except Exception:
            self._shutdown_pool()  # hung or broken workers are not reused
            raise

    def _ensure_pool(self):
        """The worker pool, made at the first epoch and kept for the
        loader's life. Fork from a parent without other Python threads of
        the user's (threads named ``mxtpu-*`` are the framework's own),
        else spawn; ``MXTPU_MP_START`` overrides either way."""
        if self._mp_pool is not None:
            return self._mp_pool
        user_threads = [
            t for t in threading.enumerate()
            if t is not threading.main_thread()
            and not t.name.startswith("mxtpu-")]
        start = _env.get("MXTPU_MP_START") or (
            "fork" if not user_threads else "spawn")
        ctx = _mp.get_context(start)
        self._mp_pool = ctx.Pool(self._num_workers,
                                 initializer=_mp_worker_init,
                                 initargs=(self._dataset,))
        return self._mp_pool

    def _shutdown_pool(self):
        if self._mp_pool is not None:
            self._mp_pool.terminate()
            self._mp_pool.join()
            self._mp_pool = None

    def close(self):
        """Stop the worker processes now (they also stop when the loader
        is collected)."""
        self._shutdown_pool()

    def __del__(self):
        try:
            self._shutdown_pool()
        except Exception:
            pass

    def _threaded_iter(self):
        """``num_workers`` threads load and collate up to ``prefetch``
        batches ahead (at least one a thread); results come in order."""
        batches = list(self._batch_sampler)
        window = max(self._prefetch, self._num_workers, 1)
        pool = ThreadPoolExecutor(self._num_workers,
                                  thread_name_prefix="mxtpu-data")
        pending = collections.deque()
        try:
            submitted = 0
            while pending or submitted < len(batches):
                while submitted < len(batches) and len(pending) < window:
                    pending.append(pool.submit(self._load,
                                               batches[submitted]))
                    submitted += 1
                yield pending.popleft().result(timeout=self._timeout)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
