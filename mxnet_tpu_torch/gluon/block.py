"""Gluon Block / HybridBlock as ``torch.nn.Module`` (counterpart of
mxnet_tpu/gluon/block.py).

``collect_params()`` returns the JAX package's dotted keys (own parameters
first, then children in registration order), so weights carry across by
name (``convert.load_jax_params``).

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
Training steps are captured in CUDA graphs by ``gluon.TrainStep``; the
served forward is not captured yet.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd as _ag
from .. import device as _device
from ..ndarray.ndarray import NDArray
from .parameter import Parameter

__all__ = ["Block", "HybridBlock"]


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

    def initialize(self, init=None, device=None, generator=None,
                   force_reinit=False):
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
        alone."""
        device = _device.resolve(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for p in self.collect_params().values():
            p.initialize(default_init=init, device=device,
                         generator=generator, force_reinit=force_reinit)
        seeds = torch.randint(0, 2 ** 62, (2,), generator=generator,
                              device=generator.device).tolist()
        self._set_generators(
            torch.Generator().manual_seed(seeds[0]),
            torch.Generator(device=device).manual_seed(seeds[1]))
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
        """The device of this block's parameters."""
        for p in self.collect_params().values():
            return p.device
        raise RuntimeError(f"{type(self).__name__} has no parameters")

    def hybridize(self, active=True):
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active)

    def cast(self, dtype):
        """Cast every parameter (and its gradient buffer) to ``dtype``."""
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def zero_grad(self):
        """Zero the gradient buffer of every initialized parameter that has
        one. (Named like ``nn.Module.zero_grad`` and doing the same job, on
        the Parameters' own buffers.)"""
        for p in self.collect_params().values():
            if p.grad_req != "null" and p._var is not None:
                p.zero_grad()

    def trainable_param_names(self):
        """Names of the parameters with ``grad_req != 'null'``, sorted."""
        return [n for n, p in sorted(self.collect_params().items())
                if p.grad_req != "null"]


class HybridBlock(Block):
    """Block that can be the serving boundary (``call_cached_graph``)."""

    def __init__(self):
        super().__init__()
        object.__setattr__(self, "_active", False)
        object.__setattr__(self, "_signatures", set())
        object.__setattr__(self, "_trace_counts", {})
        object.__setattr__(self, "_sig_lock", threading.Lock())

    def hybridize(self, active=True):
        """Make this block the boundary; nested blocks stay plain, as in
        the JAX package, where the outermost hybridized block is the one
        jit program."""
        object.__setattr__(self, "_active", bool(active))
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(False)

    def _call(self, *args, **kwargs):
        if self._active:
            self._note_signature(args)
        return super()._call(*args, **kwargs)

    def _note_signature(self, args):
        training = bool(_ag.is_training())
        sig = (training,) + tuple(
            (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
            else (type(a),) for a in args)
        with self._sig_lock:
            if sig not in self._signatures:
                self._signatures.add(sig)
                self._trace_counts[training] = \
                    self._trace_counts.get(training, 0) + 1

    def jit_trace_count(self, training=False):
        """How many input signatures the train/predict variant has seen
        for the first time (the JAX package's per-variant trace count)."""
        return self._trace_counts.get(bool(training), 0)

    def call_cached_graph(self, *args):
        """Thread-safe predict-mode entry, the serving hot path: forces
        predict mode, no recording and ``torch.inference_mode()``. Raises
        unless ``hybridize()`` was called, as the JAX package does."""
        if not self._active:
            raise RuntimeError(
                f"{type(self).__name__}.call_cached_graph requires "
                "hybridize() — the serving engine only runs the hybridized "
                "boundary")
        with _ag.pause(), torch.inference_mode():
            return self(*args)
