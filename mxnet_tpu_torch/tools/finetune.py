"""The BERT-base fine-tune step of the port, built the way a user would
(counterpart of bench.py:build_bert_finetune, which times the same model
with a bare ``p - 1e-5 * g``; here the update is the Trainer's, the entry
point users call).

``BERTForQA(bert_12_768_12)`` with its SQuAD span head, bf16 weights with
f32 masters through ``amp.convert_hybrid_block`` and
``multi_precision=True``, AdamW with weight decay and a global-norm clip, a
synthetic batch with SQuAD shapes from a seeded generator. Shared by
chip_smoke.py and tools/profile_training.py. ``train_step=True`` runs the
same step through ``gluon.TrainStep``, which captures it as one CUDA graph
only without the global-norm clip (``clip_global_norm=None``): with it, it
runs phased, as the JAX package's does, for the reason
``ineligible_reason()`` gives.

``sharding_plan=`` trains under a ``sharding.ShardingPlan`` (or a function
of the net that returns one, for ``ShardingPlan.from_layout(axes, net=net,
devices=...)``): the Trainer places every parameter and its state by it.

``optimizer=`` names the rule (``"lamb"`` for the large-batch recipe of
You et al., arXiv:1904.00962), ``init=`` the global initializer
(``mx.initializer.Xavier()``), and ``amp_loop=True`` makes each step
MXNet's AMP loop: ``amp.init()`` before the conversion and
``amp.init_trainer``, the backward inside ``amp.scale_loss``, then
``amp.unscale``, the loss scaler's overflow check, ``trainer.step`` only
without an overflow, and ``update_scale``.
"""
from __future__ import annotations

import functools

import torch

from .. import amp, autograd
from .. import device as _device
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..gluon.model_zoo import bert
from ..gluon.train_step import TrainStep
from ..gluon.trainer import Trainer

__all__ = ["build_bert_finetune"]

VOCAB = 30522


def build_bert_finetune(batch=8, seq=384, dropout=0.1, dtype="bfloat16",
                        learning_rate=1e-4, device=None, seed=0,
                        clip_global_norm=1.0, train_step=False,
                        optimizer="adamw", init=None, amp_loop=False,
                        sharding_plan=None, **model_kwargs):
    """``(net, trainer, step)``: ``step()`` runs one recorded forward on
    the one fixed batch, backward on the per-sample loss vector and
    ``trainer.step(batch)``, and returns that loss vector (on the device,
    f32). ``model_kwargs`` override the BERT-base config (``num_layers=2``
    cuts the depth). Weights and batch are drawn from ``seed``. With
    ``train_step=True``, ``step`` is ``functools.partial`` of a
    ``gluon.TrainStep`` over the same net, loss and trainer and the fixed
    batch (``step.func`` is the TrainStep); otherwise ``step.batch`` is
    that batch, ``(tokens, segments, starts, ends)``. With
    ``amp_loop=True`` a step is the AMP loop of the module note, and
    ``step.overflows`` collects each step's overflow verdict."""
    if train_step and amp_loop:
        raise ValueError("train_step=True runs no AMP loop")
    device = _device.resolve(device)
    net = bert.BERTForQA(bert.bert_12_768_12(
        vocab_size=VOCAB, max_length=512, dropout=dropout, **model_kwargs))
    net.initialize(init=init, device=device,
                   generator=torch.Generator().manual_seed(seed))
    opt = dict(learning_rate=learning_rate, wd=0.01,
               clip_global_norm=clip_global_norm)
    if amp_loop:
        amp.init()
    if dtype == "bfloat16":
        amp.convert_hybrid_block(net, "bfloat16")
        opt["multi_precision"] = True
    elif dtype != "float32":
        raise ValueError(f"dtype must be bfloat16 or float32, got {dtype!r}")
    if callable(sharding_plan):
        sharding_plan = sharding_plan(net)
    trainer = Trainer(net.collect_params(), optimizer, opt,
                      sharding_plan=sharding_plan)
    if amp_loop:
        amp.init_trainer(trainer)
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, VOCAB, (batch, seq), generator=gen,
                           dtype=torch.int32).to(device)
    segments = torch.zeros_like(tokens)
    starts = torch.randint(0, seq, (batch,), generator=gen).to(device)
    ends = torch.randint(0, seq, (batch,), generator=gen).to(device)
    loss_fn = SoftmaxCrossEntropyLoss()

    def span_loss(out, s, e):
        # the loss in f32, as mixed-precision training takes it
        return loss_fn(out[0].float(), s) + loss_fn(out[1].float(), e)

    if train_step:
        return net, trainer, functools.partial(
            TrainStep(net, span_loss, trainer, n_data=2), tokens, segments,
            starts, ends)

    def step():
        with autograd.record():
            s_logits, e_logits = net(tokens, segments)
            # the loss in f32, as mixed-precision training takes it
            loss = (loss_fn(s_logits.float(), starts)
                    + loss_fn(e_logits.float(), ends))
            if amp_loop:
                with amp.scale_loss(loss, trainer) as scaled:
                    autograd.backward(scaled)
        if not amp_loop:
            autograd.backward(loss)
            trainer.step(batch)
            return loss.detach()
        amp.unscale(trainer)
        scaler = trainer._amp_loss_scaler
        overflow = scaler.has_overflow(trainer._params)
        if not overflow:
            trainer.step(batch)
        scaler.update_scale(overflow)
        step.overflows.append(overflow)
        return loss.detach()

    step.overflows = []
    step.batch = (tokens, segments, starts, ends)
    return net, trainer, step
