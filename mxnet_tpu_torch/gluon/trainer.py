"""Gluon Trainer (counterpart of mxnet_tpu/gluon/trainer.py).

Applies an Optimizer to a set of Parameters on one device. There is no
kvstore yet: ``allreduce_grads`` has nothing to reduce, and the arguments
that ask for one (a distributed ``kvstore``, ``mesh=``, ``sharding_plan=``,
``compression_params=``, ``update_on_kvstore=``) raise
``NotImplementedError``. ``save_states`` / ``load_states`` wait too;
``convert.load_jax_trainer_states`` carries states across from the JAX
package.

``step(batch_size)`` sets ``rescale_grad = scale / batch_size`` and hands
every dense parameter with a fresh gradient to the Optimizer in one
list-form call (``update_fused`` for every rule that has a ``_rule``), which
updates weights and states in place. Each step ends in
``_record_step_complete``, which ``gluon.TrainStep`` calls too.
"""
from __future__ import annotations

import time

from .. import optimizer as opt_mod
from .parameter import Parameter

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "None", "device", "local")


def _later(what):
    return NotImplementedError(
        f"Trainer({what}) is not ported yet: the PyTorch port trains on one "
        f"device; kvstores, meshes and sharding plans come with the "
        f"multi-device slice")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None, kvstore=None,
                 compression_params=None, update_on_kvstore=None,
                 batch_axis=0, mesh=None, sharding_plan=None):  # noqa: ARG002
        if isinstance(params, dict):
            param_list = [params[k] for k in sorted(params)]
            self._param_names = sorted(params)
        elif isinstance(params, (list, tuple)):
            param_list = list(params)
            self._param_names = [p.name for p in param_list]
        else:
            raise ValueError("params must be dict/list of Parameters")
        for p in param_list:
            if not isinstance(p, Parameter):
                raise ValueError(f"expected Parameter, got {type(p)}")
        if not (kvstore is None or kvstore in _LOCAL_KVSTORES):
            raise _later(f"kvstore={kvstore!r}")
        if mesh is not None:
            raise _later("mesh=...")
        if sharding_plan is not None:
            raise _later("sharding_plan=...")
        if compression_params is not None:
            raise _later("compression_params=...")
        if update_on_kvstore:
            raise _later("update_on_kvstore=True")
        self._params = param_list
        self._scale = 1.0
        optimizer_params = optimizer_params or {}
        self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._states = [None] * len(self._params)
        self._states_created = [False] * len(self._params)
        # param index -> gradient version seen at its last update; a
        # matching version means the gradient is STALE (nothing was
        # backpropagated into it since)
        self._grad_versions = {}
        # host bookkeeping of completed steps (_record_step_complete)
        self._steps_completed = 0
        self._examples_completed = 0
        self._last_step_end = None
        self._last_step_seconds = None

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _ensure_states(self, i, weight):
        if not self._states_created[i]:
            self._states[i] = self._optimizer.create_state_multi_precision(
                i, weight)
            self._states_created[i] = True

    def allreduce_grads(self, ignore_stale_grad=False):  # noqa: ARG002
        """Nothing to reduce: one device holds the one copy of every
        gradient."""
        return

    def step(self, batch_size, ignore_stale_grad=False):
        """Optimizer update with the gradients scaled by 1/batch_size."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads(ignore_stale_grad)
        self.update(batch_size, ignore_stale_grad, _skip_rescale=True)
        self._record_step_complete(batch_size)

    def _record_step_complete(self, batch_size):
        """Close one training step on the host, for ``step()`` and
        ``gluon.TrainStep`` alike: count it and its examples, and time the
        interval since the previous step's end (the whole iteration; the
        first step is counted, not timed). Telemetry reads these when it is
        ported."""
        now = time.perf_counter()
        if self._last_step_end is not None:
            self._last_step_seconds = now - self._last_step_end
        self._last_step_end = now
        self._steps_completed += 1
        self._examples_completed += int(batch_size)

    def _mark_grads_consumed(self, indices):
        """Mark the gradients of the parameters ``indices`` stale, as an
        update does: what ``gluon.TrainStep`` records after a step whose
        update ran on the card without this trainer's Python."""
        for i in indices:
            self._grad_versions[i] = self._params[i]._grad_version

    def update(self, batch_size, ignore_stale_grad=False,
               _skip_rescale=False):
        if not _skip_rescale:
            self._optimizer.rescale_grad = self._scale / batch_size
        # every dense parameter goes to ONE list-form call, which buckets
        # by (dtype, multi-precision)
        f_idx, f_w, f_g, f_s = [], [], [], []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            # stale = gradient buffer untouched since the last update
            fresh = self._grad_versions.get(i) != p._grad_version
            if ignore_stale_grad and not fresh:
                continue
            w = p._tensor()
            self._ensure_states(i, w)
            f_idx.append(i)
            f_w.append(w)
            f_g.append(p.grad())
            f_s.append(self._states[i])
            self._grad_versions[i] = p._grad_version
        if f_idx:
            self._optimizer.update_multi_precision(f_idx, f_w, f_g, f_s)

    def zero_grad(self):
        for p in self._params:
            if p.grad_req != "null" and p._var is not None:
                p.zero_grad()

    def save_states(self, fname):  # noqa: ARG002
        raise NotImplementedError(
            "Trainer.save_states is not ported yet: it comes with "
            "save_parameters / load_parameters in the next training slice")

    def load_states(self, fname):  # noqa: ARG002
        raise NotImplementedError(
            "Trainer.load_states is not ported yet: it comes with "
            "save_parameters / load_parameters in the next training slice")
