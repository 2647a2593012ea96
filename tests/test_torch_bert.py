"""The PyTorch port's BERT (mxnet_tpu_torch/gluon/model_zoo/bert.py) against
the JAX package's, the whole slice's model on the CPU.

A tiny BERTForQA (2 layers, units 64, 4 heads, hidden 128, vocab 100) is
built in both packages; the JAX weights are carried across with
convert.load_jax_params, and the same numpy token ids go through both.
Start/end logits agree in f32 within atol 1e-4 (the two frameworks sum in
another order through 2 layers of matmuls and LayerNorms).
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch.convert import load_jax_params, to_tensor
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

CFG = dict(vocab_size=100, max_length=64, num_layers=2, units=64,
           hidden_size=128, num_heads=4)
B, S = 3, 37
ATOL = 1e-4


def jax_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


@pytest.fixture(scope="module")
def pair():
    mx.seed(11)
    jnet = jbert.BERTForQA(jbert.get_bert_model("bert_12_768_12", **CFG))
    jnet.initialize()
    tnet = tbert.BERTForQA(tbert.get_bert_model("bert_12_768_12", **CFG))
    tnet.initialize(device=cpu())
    rs = onp.random.RandomState(5)
    tok = rs.randint(0, CFG["vocab_size"], (B, S)).astype("int32")
    seg = rs.randint(0, 2, (B, S)).astype("int32")
    load_jax_params(tnet, jax_params(jnet))
    return jnet, tnet, tok, seg


def test_collect_params_keys_and_shapes_match(pair):
    jnet, tnet, _, _ = pair
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(jp) == list(tp)
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
    assert "bert.encoder.layers.0.attention.qkv.weight" in tp
    assert "bert.decoder_bias" in tp
    # nn.Module sees the same dotted names
    assert [n for n, _ in tnet.named_parameters()] == list(tp)


@pytest.mark.parametrize("flash", ["1", "0"])
@pytest.mark.parametrize("with_valid_length", [False, True])
def test_qa_logits_match_jax(pair, monkeypatch, flash, with_valid_length):
    # flash=1 and no valid_length: the flash path (plain version on the
    # CPU on both sides); otherwise the masked/einsum path
    monkeypatch.setenv("MXTPU_FLASH_ATTENTION", flash)
    jnet, tnet, tok, seg = pair
    vl = onp.array([S, 20, 5], "int32")
    jargs = [mx.np.array(tok), mx.np.array(seg)]
    targs = [torch.from_numpy(tok), torch.from_numpy(seg)]
    if with_valid_length:
        jargs.append(mx.np.array(vl))
        targs.append(torch.from_numpy(vl))
    js, je = jnet(*jargs)
    with torch.no_grad():
        ts, te = tnet(*targs)
    assert ts.shape == (B, S) and ts.dtype == torch.float32
    onp.testing.assert_allclose(ts.numpy(), js.asnumpy(), atol=ATOL,
                                rtol=0)
    onp.testing.assert_allclose(te.numpy(), je.asnumpy(), atol=ATOL,
                                rtol=0)


def test_mlm_decoder_and_pooler_match_jax(pair):
    jnet, tnet, tok, seg = pair
    mp = onp.array([[1, 4], [0, 36], [7, 7]], "int32")
    jseq, jpool, jmlm = jnet.bert(mx.np.array(tok), mx.np.array(seg),
                                  None, mx.np.array(mp))
    with torch.no_grad():
        tseq, tpool, tmlm = tnet.bert(torch.from_numpy(tok),
                                      torch.from_numpy(seg), None,
                                      torch.from_numpy(mp))
    for got, want in ((tseq, jseq), (tpool, jpool), (tmlm, jmlm)):
        onp.testing.assert_allclose(got.numpy(), want.asnumpy(), atol=ATOL,
                                    rtol=0)


def test_bf16_weights_carry_across_bit_for_bit():
    mx.seed(3)
    cfg = dict(CFG, num_layers=1)
    jnet = jbert.get_bert_model("bert_12_768_12", dtype="bfloat16", **cfg)
    jnet.initialize()
    params = jax_params(jnet)
    w = params["encoder.layers.0.attention.qkv.weight"]
    assert w.dtype.name == "bfloat16"
    tnet = tbert.get_bert_model("bert_12_768_12", dtype="bfloat16", **cfg)
    tnet.initialize(device=cpu())
    load_jax_params(tnet, params)
    got = tnet.collect_params()["encoder.layers.0.attention.qkv.weight"]
    assert got._tensor().dtype == torch.bfloat16
    assert (got._tensor().detach().view(torch.int16).numpy()
            == w.view(onp.int16)).all()
    # the bit view agrees with the value jnp itself gives in f32
    onp.testing.assert_array_equal(
        to_tensor(w).float().numpy(), onp.asarray(jnp.asarray(w,
                                                              jnp.float32)))


def test_load_jax_params_is_strict(pair):
    jnet, _, _, _ = pair
    params = jax_params(jnet)
    fresh = tbert.BERTForQA(tbert.get_bert_model("bert_12_768_12", **CFG))
    fresh.initialize(device=cpu())
    missing = dict(params)
    missing.pop("span_classifier.bias")
    with pytest.raises(KeyError, match="span_classifier.bias"):
        load_jax_params(fresh, missing)
    with pytest.raises(KeyError, match="extra.weight"):
        load_jax_params(fresh, dict(params, **{"extra.weight": onp.ones(2)}))
    bad = dict(params)
    bad["span_classifier.weight"] = onp.ones((3, 64), "f")
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(fresh, bad)


def test_deferred_dense_infers_in_units():
    from mxnet_tpu_torch.gluon.nn import Dense

    d = Dense(5)
    d.initialize(device=cpu())
    assert d.weight._is_deferred
    out = d(torch.ones(2, 3, 4))
    assert out.shape == (2, 5)
    assert d.weight.shape == (5, 12)
