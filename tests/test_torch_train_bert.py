"""The training slice as a whole on the CPU: a tiny BERTForQA takes
fine-tune steps in the PyTorch port and in the JAX package, from the same
weights on the same batch, through the entry points a user calls
(``autograd.record()`` -> backward on the per-sample loss -> ``Trainer.step``).

Tiny model: 2 layers, units 64, 4 heads, hidden 128, vocab 100, seq 37,
batch 4. On the CPU both packages' ``flash_attention`` take their plain
versions; the port's backward is its explicit ``flash_attention_bwd_reference``
inside the ``torch.autograd.Function``, the JAX package's is ``jax.vjp`` of
``attention_reference``.
"""
import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import _random as jrandom
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import (load_jax_params,
                                     load_jax_trainer_states, to_tensor)
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

CFG = dict(vocab_size=100, max_length=64, num_layers=2, units=64,
           hidden_size=128, num_heads=4, dropout=0.0)
B, S = 4, 37
OPT = dict(learning_rate=1e-3, wd=0.01, clip_global_norm=1.0)


def batch():
    rs = onp.random.RandomState(5)
    tok = rs.randint(0, CFG["vocab_size"], (B, S)).astype("int32")
    seg = rs.randint(0, 2, (B, S)).astype("int32")
    y0 = rs.randint(0, S, (B,)).astype("int32")
    y1 = rs.randint(0, S, (B,)).astype("int32")
    return tok, seg, y0, y1


def jax_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def build_pair(seed=11):
    mx.seed(seed)
    jnet = jbert.BERTForQA(jbert.get_bert_model("bert_12_768_12", **CFG))
    jnet.initialize()
    tnet = tbert.BERTForQA(tbert.get_bert_model("bert_12_768_12", **CFG))
    tnet.initialize(device=mt.cpu())
    load_jax_params(tnet, jax_params(jnet))
    return jnet, tnet


def jax_step(jnet, jtr, data):
    tok, seg, y0, y1 = (mx.np.array(a) for a in data)
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        s, e = jnet(tok, seg)
        L = lf(s, y0) + lf(e, y1)
    L.backward()
    grads = {k: p.grad().asnumpy() for k, p in jnet.collect_params().items()
             if p.grad_req != "null"}
    jtr.step(B)
    return L.asnumpy(), grads


def torch_step(tnet, ttr, data):
    tok, seg, y0, y1 = (torch.from_numpy(a) for a in data)
    lf = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.autograd.record():
        s, e = tnet(tok, seg)
        L = lf(s, y0) + lf(e, y1)
    mt.autograd.backward(L)
    grads = {k: p.grad().float().numpy().copy()
             for k, p in tnet.collect_params().items()
             if p.grad_req != "null"}
    ttr.step(B)
    return L.detach().float().numpy(), grads


def test_three_f32_steps_match_jax():
    """Loss of each of 3 steps, gradients after step 1 and parameters after
    step 3 within 1e-4 (f32 on both sides; the frameworks sum in another
    order through 2 layers). Two parameters have an analytically zero
    gradient, since sum(softmax - onehot) = 0 over the sequence: the last
    LayerNorm's beta and the span bias. Their computed gradient is rounding
    noise (< 1e-6), which AdamW turns into steps of up to lr each, in
    either direction: those are held to 3 * lr * 2 instead."""
    jnet, tnet = build_pair()
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(OPT))
    ttr = mt.gluon.Trainer(tnet.collect_params(), "adamw", dict(OPT))
    data = batch()
    for step in range(3):
        jl, jg = jax_step(jnet, jtr, data)
        tl, tg = torch_step(tnet, ttr, data)
        onp.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
        if step == 0:
            assert sorted(tg) == sorted(jg)
            for k in jg:
                onp.testing.assert_allclose(tg[k], jg[k], atol=1e-4, rtol=0,
                                            err_msg=k)
            qkv = tg["bert.encoder.layers.0.attention.qkv.weight"]
            assert onp.abs(qkv).max() > 1e-4  # gradient reaches q, k, v
            noise = {k for k in jg if onp.abs(jg[k]).max() < 1e-6
                     and onp.abs(jg[k]).max() > 0}
            assert noise <= {"bert.encoder.layers.1.layer_norm_ffn.beta",
                             "span_classifier.bias"}
    jp = jax_params(jnet)
    for k, p in tnet.collect_params().items():
        atol = 6 * OPT["learning_rate"] if k in noise else 1e-4
        onp.testing.assert_allclose(p._tensor().detach().numpy(), jp[k],
                                    atol=atol, rtol=0, err_msg=k)
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == 3


def _np_state(state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return tuple(_np_state(s) for s in state)
    return state.asnumpy()


def jax_trainer_states(jtr, names):
    opt = jtr.optimizer
    return {
        "states": {n: _np_state(s) for n, s, made in zip(
            names, jtr._states, jtr._states_created) if made},
        "index_update_count": {names[i]: t for i, t in
                               opt._index_update_count.items()},
        "num_update": opt.num_update,
    }


def test_bf16_multi_precision_steps_match_jax():
    """bf16 weights with f32 masters through amp.convert_hybrid_block in
    both packages, 3 steps. Before each step the port takes the JAX side's
    weights and optimizer states (load_jax_trainer_states), so each step is
    compared on its own: bf16 forward and backward round at other points
    in the two frameworks, which moves a small gradient by up to its own
    size, and AdamW's first steps move every weight by about lr whatever
    the gradient's size. So with lr 2e-5 a master may differ by a few
    1e-5: masters within 1e-4, weights within 1 bf16 ulp of the master's
    difference (|w| < 0.5: 1 ulp <= 2e-3)."""
    jnet, tnet = build_pair(seed=12)
    mx.amp.convert_hybrid_block(jnet, "bfloat16")
    mt.amp.convert_hybrid_block(tnet, "bfloat16")
    opt = dict(learning_rate=2e-5, wd=0.01, multi_precision=True)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(opt))
    ttr = mt.gluon.Trainer(tnet.collect_params(), "adamw", dict(opt))
    names = sorted(jnet.collect_params())
    assert names == ttr._param_names
    data = batch()
    w_name = "bert.encoder.layers.1.ffn.ffn_1.weight"
    assert tnet.collect_params()[w_name]._tensor().dtype == torch.bfloat16
    assert (tnet.collect_params()["bert.embed_layer_norm.gamma"]._tensor().dtype
            == torch.float32)
    for step in range(3):
        load_jax_params(tnet, jax_params(jnet))
        if step:
            load_jax_trainer_states(ttr, jax_trainer_states(jtr, names))
        jl, _ = jax_step(jnet, jtr, data)
        tl, _ = torch_step(tnet, ttr, data)
        # a bf16 loss: 8 mantissa bits of a value near 2 * ln(37)
        onp.testing.assert_allclose(tl, jl, atol=0.1, rtol=0)
        for i, name in enumerate(names):
            jst, tst = jtr._states[i], ttr._states[i]
            p = tnet.collect_params()[name]
            if p._tensor().dtype == torch.bfloat16:
                jm = jst[0].asnumpy()
                onp.testing.assert_allclose(tst[0].numpy(), jm, atol=1e-4,
                                            rtol=0, err_msg=name)
                jw = to_tensor(jnet.collect_params()[name].data().asnumpy())
                diff = (p._tensor().detach().float() - jw.float()).abs().max()
                assert diff <= 2e-3 + 1e-4, name
                # the weight is the master rounded to bf16, exactly
                assert torch.equal(p._tensor().detach(),
                                   tst[0].to(torch.bfloat16)), name
    assert ttr.optimizer._index_update_count == \
        jtr.optimizer._index_update_count


def test_attention_dropout_gradients_match_jax():
    """Attention dropout alone (rate 0.1 on the attention Dropout only):
    the keep mask is the same counter hash in both packages once the seed
    is the same, so the port is given the seeds the JAX package draws, and
    the gradients then agree within 1e-4."""
    jnet, tnet = build_pair(seed=13)
    for jl, tl in zip(jnet.bert.encoder.layers, tnet.bert.encoder.layers):
        jl.attention.dropout._rate = 0.1
        tl.attention.dropout._rate = 0.1
    # replay the JAX key stream to learn the seeds its forward will draw,
    # then put the stream back
    mx.seed(99)
    key0 = jrandom._rng.key
    seeds = [int(jax.random.randint(jrandom.next_key(), (1,), 0,
                                    2 ** 31 - 1)[0])
             for _ in range(CFG["num_layers"])]
    jrandom._rng.key = key0
    for tl, seed in zip(tnet.bert.encoder.layers, seeds):
        tl.attention._next_dropout_seed = lambda seed=seed: seed
    data = batch()
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                           {"learning_rate": 0.0})
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd",
                           {"learning_rate": 0.0})
    jl, jg = jax_step(jnet, jtr, data)
    tl, tg = torch_step(tnet, ttr, data)
    onp.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    for k in jg:
        onp.testing.assert_allclose(tg[k], jg[k], atol=1e-4, rtol=0,
                                    err_msg=k)
    # and the mask did something: another seed gives other gradients
    for tl_ in tnet.bert.encoder.layers:
        tl_.attention._next_dropout_seed = lambda: 1
    _, tg2 = torch_step(tnet, ttr, data)
    k = "bert.encoder.layers.0.attention.qkv.weight"
    assert onp.abs(tg2[k] - tg[k]).max() > 1e-5


def test_dropout_seeds_come_from_the_initialize_generator():
    """Repair of the seed draw: the per-call seed comes from each attention
    layer's own generator, seeded at ``initialize(generator=...)`` from an
    explicit CPU generator derived from it, so two nets initialized from
    the same generator draw the same seeds and masks."""
    def make(seed):
        net = tbert.BERTForQA(tbert.get_bert_model(
            "bert_12_768_12", **dict(CFG, dropout=0.1)))
        net.initialize(device=mt.cpu(),
                       generator=torch.Generator().manual_seed(seed))
        return net

    a, b, c = make(3), make(3), make(4)
    att = a.bert.encoder.layers[0].attention
    assert att.seed_generator.device.type == "cpu"
    assert att.seed_generator is a.bert.encoder.layers[1].attention \
        .seed_generator
    tok, seg, _, _ = (torch.from_numpy(x) for x in batch())
    outs = []
    for net in (a, b, c):
        with mt.autograd.record():
            outs.append(net(tok, seg)[0].detach())
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    # predict mode: no dropout, no draw
    state = att.seed_generator.get_state()
    a(tok, seg)
    assert torch.equal(att.seed_generator.get_state(), state)
    with pytest.raises(RuntimeError, match="seed generator"):
        tbert.MultiHeadAttention(64, 4, dropout=0.1)._next_dropout_seed()
