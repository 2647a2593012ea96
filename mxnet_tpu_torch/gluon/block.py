"""Gluon Block / HybridBlock as ``torch.nn.Module`` (counterpart of
mxnet_tpu/gluon/block.py).

``collect_params()`` returns the JAX package's dotted keys (own parameters
first, then children in registration order), so weights carry across by
name (``convert.load_jax_params``), and ``save_parameters`` /
``load_parameters`` read and write the JAX package's checkpoint: an npz
keyed by those names, bf16 in its dtype sidecar (``_dtype_codec``),
written on an IO thread as the JAX package writes it.

``Block.__call__`` is the NDArray boundary: NDArray arguments are
unwrapped, the children see tensors, and the outputs come back as NDArrays
when any argument was one, so ``net(mx.np.array(...))`` returns an NDArray
whose ``backward()`` reaches the parameters. Raw tensors in give raw tensors
out. ``Parameter.data()`` is an NDArray over the parameter's tensor, as in
the JAX package.

PyTorch runs eagerly, so ``hybridize()`` compiles nothing: it marks the
block as the serving boundary. ``jit_trace_count()`` counts the input
signatures (shapes and dtypes) a hybridized block has seen for the first
time, which is what a jit trace counted in the JAX package, so the serving
warmup's proof that every served shape was seen before keeps its meaning.

``call_cached_graph``, the serving entry, is on the card what the JAX
package's per-signature jit cache is on the TPU: one ``torch.cuda.CUDAGraph``
per predict-mode input signature, by TrainStep's rule. The first call of a
signature runs eagerly (and counts in ``jit_trace_count``); the second
captures the forward (``capture_count`` counts it) on a side stream, into a
private memory pool of that graph's own, after one eager run there; every
later call copies its arguments into the graph's static inputs, replays it
on the caller's current stream and returns COPIES of the static outputs,
made on that stream right after the replay, which the caller owns: the next
replay overwrites the static outputs, never a result already handed out.
One lock per block covers the copy-in, the replay and the copies, so many
threads may call at once; a call from another stream than the previous
replay's first waits for that replay. A weight whose tensor was replaced
since a capture (``initialize``, ``cast``) moves
gluon/parameter.py:storage_epoch; the next call then compares the weights'
addresses and, where they moved, drops the block's graphs and captures
again (counted), so no replay reads a replaced tensor and no call raises
for it. Values written in place (``set_data``, ``convert.load_jax_params``,
the optimizer) are what the graph reads and need nothing. On the CPU the
forward stays eager. Training steps are captured by ``gluon.TrainStep``.

``register_op_hook`` calls its callback after each descendant block's
forward with the JAX package's block and tensor names; inside a
hybridized block only that block reports, as the JAX package's jit
boundary does. A captured CUDA graph would call a callback once, at its
capture, and never at a replay, so on the card ``call_cached_graph`` and
``gluon.TrainStep``'s graph raise while any op hook is registered on the
net; the CPU and the phased step run it.
"""
from __future__ import annotations

import math
import os
import re
import threading

import numpy as _np
import torch

from .. import _checkpoint_io, _random
from .. import autograd as _ag
from .. import device as _device
from .._dtype_codec import DTYPE_KEY, decode_entry, dtype_name, read_sidecar
from ..ndarray.ndarray import NDArray
from . import _graph
from .parameter import Parameter, one_device, storage_epoch

__all__ = ["Block", "HybridBlock", "check_no_op_hooks"]

#: thread-local hook state: ``suppress`` (shape-inference passes report
#: nothing) and ``boundary`` (the hybridized block whose forward runs)
_HOOKS = threading.local()
# how many active hybridized blocks this thread's forward is inside: the
# JAX package traces such a forward, so what it sees there is not concrete
_HYBRID = threading.local()


def in_hybridized_forward():
    """Whether this thread runs inside an active hybridized block's
    forward (where the JAX package's forward is a trace)."""
    return getattr(_HYBRID, "depth", 0) > 0


#: whether any op hook was ever registered in the process: until then
#: neither a hybridized forward nor a CUDA graph looks for hooks
_op_hooks_registered = False


def check_no_op_hooks(block, where):
    """Raise where an op hook of ``register_op_hook`` is registered on
    ``block`` or a descendant: ``where`` (a CUDA graph) would skip it."""
    if not _op_hooks_registered:
        return
    for m in block.modules():
        if getattr(m, "_op_hook_handles", None):
            raise RuntimeError(
                f"{where}: {type(m).__name__} has an op hook "
                "(register_op_hook), which a captured CUDA graph would call "
                "once at its capture and never at a replay; run the block "
                "on the CPU or phased (MXTPU_WHOLE_STEP=0) to monitor it")


def _to_ndarrays(out):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_to_ndarrays(o) for o in out)
    return out


class Block(torch.nn.Module):
    """Container of Parameters and child Blocks."""

    def __init__(self):
        super().__init__()
        object.__setattr__(self, "_reg_params", {})

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            value._owners.append((self, name))
            if value._var is not None:
                self._parameters[name] = value._var
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    def __call__(self, *args, **kwargs):
        if any(isinstance(a, NDArray) for a in args) or any(
                isinstance(v, NDArray) for v in kwargs.values()):
            args = [a._data if isinstance(a, NDArray) else a for a in args]
            kwargs = {k: v._data if isinstance(v, NDArray) else v
                      for k, v in kwargs.items()}
            return _to_ndarrays(self._call(*args, **kwargs))
        return self._call(*args, **kwargs)

    def _call(self, *args, **kwargs):
        # torch autograd records only inside autograd.record()
        with torch.set_grad_enabled(_ag.is_recording()):
            return torch.nn.Module.__call__(self, *args, **kwargs)

    # -- children ----------------------------------------------------------
    def register_child(self, block, name=None):
        """Add ``block`` as the child ``name``, by default the number of
        children so far (block.py:152)."""
        self.add_module(name or str(len(self._modules)), block)
        return block

    def setattr(self, name, value):
        """Set the attribute ``name`` of every parameter (block.py:320),
        e.g. ``setattr('grad_req', 'null')``."""
        for p in self.collect_params().values():
            setattr(p, name, value)

    # -- parameters --------------------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        out = {prefix + name: p for name, p in self._reg_params.items()}
        for cname, child in self._modules.items():
            if isinstance(child, Block):
                out.update(child._collect_params_with_prefix(
                    prefix + cname + "."))
        return out

    def collect_params(self, select=None):
        """Dict of dotted name -> Parameter; ``select`` is a regex over the
        names."""
        params = self._collect_params_with_prefix()
        if select is None:
            return params
        pat = re.compile(select)
        return {k: v for k, v in params.items() if pat.match(k)}

    @property
    def params(self):
        """This block's own Parameters by attribute name, its children's
        not included (block.py:185)."""
        return self._reg_params

    def _replace_param(self, name, param):
        old = self._reg_params.get(name)
        if old is not None and old is not param:
            old._owners[:] = [o for o in old._owners
                              if not (o[0] is self and o[1] == name)]
            self._parameters.pop(name, None)
        self.__setattr__(name, param)

    def share_parameters(self, shared):
        """Take the Parameters of ``shared`` (a ``collect_params()`` dict)
        whose names this block has (block.py:204): each becomes the same
        Parameter object, so data and gradients are shared; other names
        keep their own."""
        if shared is None:
            return self
        if not isinstance(shared, dict):
            raise ValueError("share_parameters expects the dict "
                             f"collect_params() returns, got {type(shared)}")

        def walk(block, prefix):
            for name in list(block._reg_params):
                if prefix + name in shared:
                    block._replace_param(name, shared[prefix + name])
            for cname, child in block._modules.items():
                if isinstance(child, Block):
                    walk(child, prefix + cname + ".")

        walk(self, "")
        return self

    def initialize(self, init=None, device=None, generator=None,
                   force_reinit=False, ctx=None, verbose=False):  # noqa: ARG002
        """Initialize every parameter on ``device`` (default: the current
        device, ``cuda:0`` outside a device scope; raises without CUDA),
        drawing from ``generator`` (default: a CPU
        generator seeded 0). Parameters are drawn in ``collect_params()``
        order; a deferred one draws at the first forward.

        After the parameters, two seeds are drawn from ``generator`` for
        the net's training noise: one CPU generator (from which each
        attention layer seeds its own dropout-seed generator on
        ``device``, once, here) and one generator on ``device`` (the
        Dropout layers' masks), handed to every block that has none of
        its own. A training run is then reproducible from ``generator``
        alone. ``ctx`` is ``device``'s old name (a list of one device is
        taken too); ``verbose`` is accepted and changes nothing, as in the
        JAX package (block.py:188)."""
        device = one_device(device if device is not None else ctx,
                            type(self).__name__)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, p in self.collect_params().items():
            p._structured_name = name
            p.initialize(default_init=init, device=device,
                         generator=generator, force_reinit=force_reinit)
        seeds = torch.randint(0, 2 ** 62, (2,), generator=generator,
                              device=generator.device).tolist()
        self._set_generators(
            torch.Generator().manual_seed(seeds[0]),
            torch.Generator(device=device).manual_seed(seeds[1]))
        _random.register_net(self)   # a checkpoint finds its generators
        return self

    def _set_generators(self, cpu_generator, device_generator):
        """Hand the net's noise generators down; a block that draws noise
        overrides this to keep the one it needs."""
        for child in self.children():
            if isinstance(child, Block):
                child._set_generators(cpu_generator, device_generator)

    def _noise_generators(self):
        """The ``torch.Generator`` objects this block and its children
        draw noise from during a forward (a CUDA-graph capture of the
        step registers them, so that each replay draws anew); a block
        that draws noise overrides this."""
        gens = []
        for child in self.children():
            if isinstance(child, Block):
                gens.extend(child._noise_generators())
        return gens

    @property
    def device(self):
        """The device of this block's parameters (of its buffers where it
        has none: a quantized layer's int8 weights)."""
        for p in self.collect_params().values():
            return p.device
        for b in self.buffers():
            return b.device
        raise RuntimeError(f"{type(self).__name__} has no parameters")

    def _clear_cached(self):
        """Drop what was captured of this block's and its children's
        forwards, after the forward itself changed (block.py:200; a
        ``quantize_net`` module rewrite)."""
        for child in self.children():
            if isinstance(child, Block):
                child._clear_cached()

    def hybridize(self, active=True, **kwargs):
        """Pass ``active`` and the flags (``static_alloc``,
        ``static_shape``, ...) down to the children (block.py:316)."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter (and its gradient buffer) to ``dtype``."""
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def reset_device(self, device=None, ctx=None):
        """Move every parameter to ``device`` (block.py:304); gradient
        buffers start from zeros there."""
        for p in self.collect_params().values():
            p.reset_device(device=device, ctx=ctx)

    reset_ctx = reset_device

    def register_op_hook(self, callback, monitor_all=False):
        """Call ``callback(block_name, tensor_name, tensor)`` after the
        forward of this block and of each descendant, for each output
        (``<name>_output<i>``) and, with ``monitor_all``, each input
        (``<name>_input<i>``) first (block.py:419). ``block_name`` is the
        dotted child path (the root's class name); tensors arrive as
        NDArrays. A hybridized block reports for itself alone, as the JAX
        package's jit boundary does. On the card a CUDA graph
        (``call_cached_graph``, ``gluon.TrainStep``) raises while an op
        hook is registered, rather than skip it at its replays."""
        def wrap(v):
            return NDArray(v) if isinstance(v, torch.Tensor) else v

        def make_hook(prefix):
            def hook(block, inputs, output):
                if getattr(_HOOKS, "suppress", 0):
                    return
                top = getattr(_HOOKS, "boundary", None)
                if top is not None and block is not top:
                    return
                name = prefix or type(block).__name__
                if monitor_all:
                    for i, a in enumerate(inputs):
                        callback(name, f"{name}_input{i}", wrap(a))
                outs = (output if isinstance(output, (list, tuple))
                        else [output])
                for i, o in enumerate(outs):
                    callback(name, f"{name}_output{i}", wrap(o))
            return hook

        def walk(block, prefix):
            handles = block.__dict__.setdefault("_op_hook_handles", [])
            handles.append(block.register_forward_hook(make_hook(prefix)))
            for cname, child in block._modules.items():
                if isinstance(child, Block):
                    walk(child, f"{prefix}.{cname}" if prefix else cname)

        global _op_hooks_registered
        _op_hooks_registered = True
        walk(self, "")
        return self

    def summary(self, *inputs):  # noqa: ARG002 - the reference's signature
        """Print each block's dotted name, type and parameter count, then
        the total, which it returns (block.py:451)."""
        rows = []

        def walk(block, prefix):
            n_params = sum(math.prod(p.shape)
                           for p in block._reg_params.values()
                           if p.shape is not None)
            rows.append((prefix or type(block).__name__,
                         type(block).__name__, n_params))
            for name, child in block._modules.items():
                if isinstance(child, Block):
                    walk(child, f"{prefix}.{name}" if prefix else name)

        walk(self, "")
        total = sum(r[2] for r in rows)
        print(f"{'Layer':<40}{'Type':<24}{'Params':>12}")
        print("-" * 76)
        for name, typ, n in rows:
            print(f"{name:<40}{typ:<24}{n:>12}")
        print("-" * 76)
        print(f"Total params: {total}")
        return total

    def zero_grad(self):
        """Zero the gradient buffer of every initialized parameter that has
        one. (Named like ``nn.Module.zero_grad`` and doing the same job, on
        the Parameters' own buffers.)"""
        for p in self.collect_params().values():
            if p.grad_req != "null" and p._var is not None:
                p.zero_grad()

    # -- checkpoint --------------------------------------------------------
    def save_parameters(self, filename, deduplicate=False):  # noqa: ARG002
        """Save the initialized parameters as an npz keyed by their
        ``collect_params()`` names, bf16 through the dtype sidecar: the JAX
        package's file (mxnet_tpu/gluon/block.py:save_parameters), which it
        loads, bit for bit. The file is written through an open file, so
        ``filename`` keeps its name (``numpy.savez`` of a path would add
        ``.npz``). BatchNorm's running statistics are saved like any other
        parameter.

        As in the JAX package, the write is asynchronous: the host copies
        are taken before the call returns (training may change the weights
        at once), and the file is written on the path's IO thread
        (``_checkpoint_io``). :meth:`load_parameters`, ``mx.nd.load`` and
        ``mx.waitall()`` wait for it and raise a failed write's error; any
        other reader (another process, ``numpy.load``, a copy) calls
        ``mx.waitall()`` first. ``mx.nd.save`` is complete on return."""
        arrays = {name: p._tensor()
                  for name, p in self._collect_params_with_prefix().items()
                  if p._var is not None}
        _checkpoint_io.async_save_npz(filename, arrays)

    def load_parameters(self, filename, device=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current", ctx=None):
        """Load a file of :meth:`save_parameters` or of the JAX package's,
        with its exceptions: a parameter the file lacks raises
        ``KeyError`` unless ``allow_missing``; a name the block lacks
        raises ``KeyError`` unless ``ignore_extra``; a saved dtype that
        differs raises ``AssertionError`` unless ``cast_dtype``, which
        casts the saved value to the parameter's dtype
        (``dtype_source='current'``) or retypes the parameter and its
        gradient buffer to the saved one (``'saved'``); another
        ``dtype_source`` raises ``ValueError``. Names are checked before
        anything is written. ``filename + '.npz'`` is read where
        ``filename`` does not exist.

        An initialized parameter takes the value in place
        (``Parameter.set_data``), so a CUDA graph captured over the weights
        (served rungs, ``gluon.TrainStep``) replays on the loaded values;
        a retype (``'saved'``) replaces the storage, and the graphs capture
        again. A deferred parameter takes its shape from the file on the
        device it was given, an uninitialized one on ``device`` (``ctx``;
        default the current device). A save of this path still on its IO
        thread is waited for first, and its error raised."""
        path = str(filename)
        _checkpoint_io.wait_for_path(path)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        if cast_dtype and dtype_source not in ("current", "saved"):
            raise ValueError(f"dtype_source must be 'current' or 'saved', "
                             f"got {dtype_source!r}")
        params = self._collect_params_with_prefix()
        with _np.load(path, allow_pickle=False) as npz:
            sidecar = read_sidecar(npz)
            loaded = set(npz.files) - {DTYPE_KEY}
            missing = [n for n in params if n not in loaded]
            if missing and not allow_missing:
                raise KeyError(f"Parameter {missing[0]} missing in file "
                               f"{filename}; set allow_missing=True to skip")
            extra = sorted(loaded - set(params))
            if extra and not ignore_extra:
                raise KeyError(f"file {filename} contains extra parameters "
                               f"{extra}; set ignore_extra=True to skip")
            values = {}
            for name, p in params.items():
                if name not in loaded:
                    continue
                arr = decode_entry(name, npz[name], sidecar)
                value = arr if isinstance(arr, torch.Tensor) \
                    else torch.from_numpy(_np.ascontiguousarray(arr))
                if value.dtype != p.dtype and not cast_dtype:
                    raise AssertionError(
                        f"Failed loading Parameter '{name}' from saved "
                        f"params: dtype incompatible expected "
                        f"{dtype_name(p.dtype)} vs saved "
                        f"{dtype_name(value.dtype)}. Set cast_dtype=True to "
                        f"cast the dtype of saved params.")
                values[name] = value
        for name, value in values.items():
            p = params[name]
            if value.dtype != p.dtype and dtype_source == "saved":
                p.cast(value.dtype)
            if p._var is not None:
                p.set_data(value)
            elif p._deferred is not None:
                p._load_init(value, None)
            else:
                p._load_init(value, _device.resolve(
                    device if device is not None else ctx))

    def trainable_param_names(self):
        """Names of the parameters with ``grad_req != 'null'``, sorted."""
        return [n for n, p in sorted(self.collect_params().items())
                if p.grad_req != "null"]


class _ServedGraphs:
    """The predict-mode CUDA graphs of one HybridBlock, one per input
    signature (``call_cached_graph``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graphs = {}       # signature -> (StaticGraph, single output)
        self.captures = 0
        self.stream = None     # the capture stream
        self.epoch = None      # storage_epoch() at the last storage check
        self.fingerprint = None
        self.last = None       # (stream, event) of the newest replay

    def _params(self, block):
        return [p._tensor() for p in block.collect_params().values()]

    def _storage_moved(self, block):
        """True when a weight the graphs read lives elsewhere now."""
        epoch = storage_epoch()
        if epoch == self.epoch:
            return False
        fp = _graph.storage_fingerprint(self._params(block))
        moved = fp != self.fingerprint
        self.epoch, self.fingerprint = epoch, fp
        return moved

    def call(self, block, sig, args):
        check_no_op_hooks(block, "call_cached_graph")
        dev = args[0].device
        with self.lock:
            if self.graphs and self._storage_moved(block):
                self.graphs.clear()
            entry = self.graphs.get(sig)
            if entry is None:
                if sig not in block._signatures:
                    return block(*args)    # first call: eager, noted
                entry = self._capture(block, sig, args, dev)
            g, single = entry
            cur = torch.cuda.current_stream(dev)
            if self.last is not None and self.last[0] != cur:
                cur.wait_event(self.last[1])
            g.replay(args)
            outs = [o.clone() for o in g.outputs]
            ev = torch.cuda.Event()
            ev.record(cur)
            self.last = (cur, ev)
        return outs[0] if single else tuple(outs)

    def _capture(self, block, sig, args, dev):
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        g = _graph.StaticGraph(args, dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            out = block(*g.inputs)   # warm-up on the capture stream
        single = isinstance(out, torch.Tensor)
        del out
        g.capture(lambda inputs: [block(*inputs)] if single
                  else list(block(*inputs)), self.stream)
        self.captures += 1
        self.graphs[sig] = (g, single)
        self.epoch = storage_epoch()
        self.fingerprint = _graph.storage_fingerprint(self._params(block))
        return g, single


class HybridBlock(Block):
    """Block that can be the serving boundary (``call_cached_graph``)."""

    def __init__(self):
        super().__init__()
        object.__setattr__(self, "_active", False)
        object.__setattr__(self, "_signatures", set())
        object.__setattr__(self, "_trace_counts", {})
        object.__setattr__(self, "_sig_lock", threading.Lock())
        object.__setattr__(self, "_served", _ServedGraphs())
        object.__setattr__(self, "_flags", {})

    def hybridize(self, active=True, **kwargs):
        """Make this block the boundary; nested blocks stay plain, as in
        the JAX package, where the outermost hybridized block is the one
        jit program. The flags (``static_alloc=True``,
        ``static_shape=True``, ...) are kept in ``_flags`` as there
        (block.py:564) and change nothing: a captured CUDA graph
        (``call_cached_graph``, ``TrainStep``) is static by nature. A
        subgraph ``backend`` is queue work and raises."""
        kwargs.pop("backend_opts", None)
        if kwargs.pop("backend", None) is not None:
            raise NotImplementedError(
                "hybridize(backend=...) is not ported (subgraph backends)")
        object.__setattr__(self, "_active", bool(active))
        self._flags.update(kwargs)
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(False)

    def _call(self, *args, **kwargs):
        if not self._active:
            return super()._call(*args, **kwargs)
        self._note_signature(args)
        _HYBRID.depth = getattr(_HYBRID, "depth", 0) + 1
        try:
            if (not _op_hooks_registered
                    or getattr(_HOOKS, "boundary", None) is not None):
                return super()._call(*args, **kwargs)
            _HOOKS.boundary = self     # descendants' op hooks stay silent
            try:
                return super()._call(*args, **kwargs)
            finally:
                _HOOKS.boundary = None
        finally:
            _HYBRID.depth -= 1

    def _clear_cached(self):
        """Also drop this block's served CUDA graphs (the next call of each
        signature captures again; ``capture_count`` counts it)."""
        with self._served.lock:
            self._served.graphs.clear()
        super()._clear_cached()

    def infer_shape(self, *args):
        """Run the forward once, unrecorded and with op hooks silent, so
        that deferred parameters take their shapes (block.py:653)."""
        args = [a._data if isinstance(a, NDArray) else a for a in args]
        _HOOKS.suppress = getattr(_HOOKS, "suppress", 0) + 1
        try:
            with _ag.pause():
                self.forward(*args)
        finally:
            _HOOKS.suppress -= 1

    @staticmethod
    def _signature(args):
        return (bool(_ag.is_training()),) + tuple(
            (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
            else (type(a),) for a in args)

    def _note_signature(self, args):
        sig = self._signature(args)
        with self._sig_lock:
            if sig not in self._signatures:
                self._signatures.add(sig)
                self._trace_counts[sig[0]] = \
                    self._trace_counts.get(sig[0], 0) + 1

    def jit_trace_count(self, training=False):
        """How many input signatures the train/predict variant has seen
        for the first time (the JAX package's per-variant trace count)."""
        return self._trace_counts.get(bool(training), 0)

    def capture_count(self):
        """CUDA graphs ``call_cached_graph`` has captured so far, the
        captures again after a weight's storage moved included (0 on the
        CPU)."""
        return self._served.captures

    def captured_graphs(self):
        """``[{"shapes", "dtypes", "pool_bytes"}]``, one per live graph:
        the input signature and what the card's reserved memory grew by
        while it was captured (its private pool)."""
        with self._served.lock:
            graphs = list(self._served.graphs.items())
        return [{"shapes": [list(s[0]) for s in sig[1:]],
                 "dtypes": [str(s[1]) for s in sig[1:]],
                 "pool_bytes": g.pool_bytes} for sig, (g, _) in graphs]

    def call_cached_graph(self, *args):
        """Thread-safe predict-mode entry, the serving hot path: forces
        predict mode, no recording and ``torch.inference_mode()``; on the
        card through the block's CUDA graphs (module docstring). Raises
        unless ``hybridize()`` was called, as the JAX package does; a
        failed capture or replay raises."""
        if not self._active:
            raise RuntimeError(
                f"{type(self).__name__}.call_cached_graph requires "
                "hybridize() — the serving engine only runs the hybridized "
                "boundary")
        with _ag.pause(), torch.inference_mode():
            if not any(isinstance(a, torch.Tensor) and a.is_cuda
                       or isinstance(a, NDArray) and a._data.is_cuda
                       for a in args):
                return self(*args)
            nd = any(isinstance(a, NDArray) for a in args)
            tensors = [a._data if isinstance(a, NDArray) else a
                       for a in args]
            if not all(isinstance(t, torch.Tensor) for t in tensors):
                raise TypeError(
                    "call_cached_graph on the card takes tensor or NDArray "
                    "arguments only")
            out = self._served.call(self, self._signature(tensors), tensors)
            return _to_ndarrays(out) if nd else out
