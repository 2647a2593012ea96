"""BERT model family (counterpart of mxnet_tpu/gluon/model_zoo/bert.py).

Line for line in its math with the JAX module: fused QKV projection
reshaped as (b, s, 3, h, d); the flash-attention kernel when no mask is
passed (the CUDA kernel on the card, its plain version on the CPU); the
masked einsum path with a -1e9 additive bias and an f32 softmax; post-LN
encoder cells; a masked-LM decoder tied to the word embedding; task heads
``BERTClassifier`` and ``BERTForQA``; configs ``bert_12_768_12`` and
``bert_24_1024_16``.
"""
from __future__ import annotations

import math

import torch

from ... import autograd as _ag
from ... import env as _env
from ...ops import nn as _nn
from ...ops.flash_attention import flash_attention, next_dropout_seed
from ..block import HybridBlock
from ..nn import Dense, Dropout, Embedding, HybridSequential, LayerNorm
from ..parameter import Parameter

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "BERTEncoder", "BERTModel", "BERTClassifier", "BERTForQA",
           "bert_12_768_12", "bert_24_1024_16", "get_bert_model"]


class MultiHeadAttention(HybridBlock):
    """Self-attention with fused QKV projection.

    On the flash path, attention-probability dropout runs inside the kernel
    from a seed that lives on the device, drawn each call in one op from
    ``dropout_generator``, the layer's own ``torch.Generator`` on its device
    (ops/flash_attention.py:next_dropout_seed; Philox on the card, whose
    counter a CUDA graph that registered the generator advances on every
    replay, so a captured step draws a new mask each time). That generator
    is seeded once, at ``initialize``, from ``seed_generator``, an explicit
    CPU ``torch.Generator``: the one given here, else the one
    ``initialize(generator=...)`` derives for the whole net from its
    generator; no call draws on the CPU. (The JAX package draws the seed
    from its global key stream; the two streams differ, so a parity test
    sets the seeds itself.)"""

    def __init__(self, units, num_heads, dropout=0.0, dtype="float32",
                 seed_generator=None):
        super().__init__()
        self.seed_generator = seed_generator
        self.dropout_generator = None
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by "
                             f"num_heads {num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._head_dim = units // num_heads
        self.qkv = Dense(3 * units, flatten=False, dtype=dtype,
                         in_units=units)
        self.out_proj = Dense(units, flatten=False, dtype=dtype,
                              in_units=units)
        self.dropout = Dropout(dropout)

    def _set_generators(self, cpu_generator, device_generator):
        if self.seed_generator is None:
            self.seed_generator = cpu_generator
        seed = int(torch.randint(0, 2 ** 62, (1,),
                                 generator=self.seed_generator))
        self.dropout_generator = torch.Generator(
            device=device_generator.device).manual_seed(seed)
        super()._set_generators(cpu_generator, device_generator)

    def _noise_generators(self):
        mine = [self.dropout_generator] if self.dropout._rate > 0 and \
            self.dropout_generator is not None else []
        return mine + super()._noise_generators()

    def _next_dropout_seed(self):
        """The next call's dropout seed, a one-element int32 tensor drawn
        on the layer's device from ``dropout_generator``."""
        if self.dropout_generator is None:
            raise RuntimeError(
                "attention dropout needs its dropout generator, seeded from "
                "the net's seed generator at initialize(): call "
                "initialize() on the net")
        return next_dropout_seed(self.dropout_generator)

    def forward(self, x, mask=None):
        # x: (B, S, D); mask: (B, S) or (B, S, S), both 1=valid/0=masked
        b, s, _ = x.shape
        h, d = self._num_heads, self._head_dim
        qkv = self.qkv(x).reshape(b, s, 3, h, d)
        q = qkv[:, :, 0].transpose(1, 2)  # (B, H, S, d), strided views
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        drop_active = self.dropout._rate > 0 and _ag.is_training()
        if mask is None and _env.get("MXTPU_FLASH_ATTENTION"):
            # fused kernel path (ops/flash_attention.py): no (S, S) score
            # matrix in device memory; attention-prob dropout runs inside
            # the kernel with the counter-hash mask
            if drop_active:
                ctx = flash_attention(q, k, v, dropout_p=self.dropout._rate,
                                      dropout_seed=self._next_dropout_seed())
            else:
                ctx = flash_attention(q, k, v)
            ctx = ctx.transpose(1, 2).reshape(b, s, h * d)
            return self.out_proj(ctx)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
        if mask is not None:
            bias = (1.0 - mask.float()) * -1e9
            if mask.dim() == 2:
                bias = bias.reshape(b, 1, 1, s)
            else:
                bias = bias.reshape((b, 1) + tuple(mask.shape[1:]))
            scores = scores.float() + bias
        att = _nn.softmax(scores.float(), axis=-1).to(x.dtype)
        att = self.dropout(att)
        out = torch.einsum("bhqk,bhkd->bhqd", att, v)
        out = out.transpose(1, 2).reshape(b, s, h * d)
        return self.out_proj(out)


class PositionwiseFFN(HybridBlock):
    """Feed-forward: Dense(hidden) -> GELU -> Dense(units)."""

    def __init__(self, units, hidden_size, dropout=0.0, dtype="float32"):
        super().__init__()
        self.ffn_1 = Dense(hidden_size, flatten=False, dtype=dtype,
                           in_units=units)
        self.ffn_2 = Dense(units, flatten=False, dtype=dtype,
                           in_units=hidden_size)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        h = _nn.activation(self.ffn_1(x), "gelu")
        return self.dropout(self.ffn_2(h))


class TransformerEncoderCell(HybridBlock):
    """Post-LN transformer layer (BERT convention)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 dtype="float32"):
        super().__init__()
        self.attention = MultiHeadAttention(units, num_heads, dropout,
                                            dtype)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout, dtype)
        self.layer_norm_att = LayerNorm(in_channels=units, dtype=dtype)
        self.layer_norm_ffn = LayerNorm(in_channels=units, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x, mask=None):
        att = self.dropout(self.attention(x, mask))
        x = self.layer_norm_att(x + att)
        ffn = self.ffn(x)
        return self.layer_norm_ffn(x + ffn)


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, dtype="float32"):
        super().__init__()
        self.layers = HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderCell(
                units, hidden_size, num_heads, dropout, dtype))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class BERTModel(HybridBlock):
    """Token + segment + position embeddings → encoder → (sequence,
    pooled) outputs; optional tied masked-LM decoder."""

    def __init__(self, vocab_size=30522, token_type_vocab_size=2,
                 max_length=512, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, dropout=0.1,
                 use_pooler=True, use_decoder=True, dtype="float32"):
        super().__init__()
        self._units = units
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self.word_embed = Embedding(vocab_size, units, dtype=dtype)
        self.token_type_embed = Embedding(token_type_vocab_size, units,
                                          dtype=dtype)
        self.position_embed = Embedding(max_length, units, dtype=dtype)
        self.embed_layer_norm = LayerNorm(in_channels=units, dtype=dtype)
        self.embed_dropout = Dropout(dropout)
        self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                   num_heads, dropout, dtype)
        if use_pooler:
            self.pooler = Dense(units, activation="tanh", flatten=False,
                                dtype=dtype, in_units=units)
        if use_decoder:
            # masked-LM transform; the vocab projection shares word_embed's
            # weight (tied decoder)
            self.decoder_transform = Dense(units, activation="gelu",
                                           flatten=False, dtype=dtype,
                                           in_units=units)
            self.decoder_norm = LayerNorm(in_channels=units, dtype=dtype)
            self.decoder_bias = Parameter("decoder_bias",
                                          shape=(vocab_size,),
                                          init="zeros", dtype=dtype)

    def _embed(self, inputs, token_types):
        b, s = inputs.shape
        pos = torch.arange(s, device=inputs.device).reshape(1, s)
        pos = pos.expand(b, s)
        x = (self.word_embed(inputs)
             + self.token_type_embed(token_types)
             + self.position_embed(pos))
        return self.embed_dropout(self.embed_layer_norm(x))

    def forward(self, inputs, token_types=None, valid_length=None,
                masked_positions=None):
        b, s = inputs.shape
        if token_types is None:
            token_types = torch.zeros((b, s), dtype=torch.int32,
                                      device=inputs.device)
        mask = None
        if valid_length is not None:
            mask = (torch.arange(s, device=inputs.device).reshape(1, s)
                    < valid_length.reshape(-1, 1)).float()
        x = self._embed(inputs, token_types)
        seq = self.encoder(x, mask)
        outputs = [seq]
        if self._use_pooler:
            outputs.append(self.pooler(seq[:, 0]))
        if self._use_decoder and masked_positions is not None:
            idx = masked_positions.long().reshape(
                tuple(masked_positions.shape) + (1,))
            picked = torch.take_along_dim(seq, idx, dim=1)
            h = self.decoder_norm(self.decoder_transform(picked))
            logits = (torch.matmul(h, self.word_embed.weight._tensor().T)
                      + self.decoder_bias._tensor())
            outputs.append(logits)
        return outputs[0] if len(outputs) == 1 else tuple(outputs)


class BERTClassifier(HybridBlock):
    """[CLS]-pooled classification head (sentence pair tasks / NSP)."""

    def __init__(self, bert, num_classes=2, dropout=0.0):
        super().__init__()
        self.bert = bert
        self.dropout = Dropout(dropout)
        self.classifier = Dense(num_classes, flatten=False,
                                in_units=bert._units)

    def forward(self, inputs, token_types=None, valid_length=None):
        _, pooled = self.bert(inputs, token_types, valid_length)
        return self.classifier(self.dropout(pooled))


class BERTForQA(HybridBlock):
    """SQuAD-style span head: Dense(2) over the sequence output giving
    start/end logits."""

    def __init__(self, bert, dropout=0.0):
        super().__init__()
        self.bert = bert
        self.dropout = Dropout(dropout)
        self.span_classifier = Dense(2, flatten=False,
                                     in_units=bert._units)

    def forward(self, inputs, token_types=None, valid_length=None):
        out = self.bert(inputs, token_types, valid_length)
        seq = out[0] if isinstance(out, tuple) else out
        logits = self.span_classifier(self.dropout(seq))  # (B, S, 2)
        start = logits[:, :, 0]
        end = logits[:, :, 1]
        return start, end


_BERT_CONFIGS = {
    "bert_12_768_12": dict(num_layers=12, units=768, hidden_size=3072,
                           num_heads=12),
    "bert_24_1024_16": dict(num_layers=24, units=1024, hidden_size=4096,
                            num_heads=16),
}


def get_bert_model(model_name="bert_12_768_12", vocab_size=30522,
                   max_length=512, dropout=0.1, use_pooler=True,
                   use_decoder=True, dtype="float32", **kwargs):
    if model_name not in _BERT_CONFIGS:
        raise ValueError(
            f"unknown BERT config {model_name}; "
            f"choose from {sorted(_BERT_CONFIGS)}")
    cfg = dict(_BERT_CONFIGS[model_name])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, use_pooler=use_pooler,
                     use_decoder=use_decoder, dtype=dtype, **cfg)


def bert_12_768_12(**kwargs):
    """BERT-base."""
    return get_bert_model("bert_12_768_12", **kwargs)


def bert_24_1024_16(**kwargs):
    """BERT-large."""
    return get_bert_model("bert_24_1024_16", **kwargs)
