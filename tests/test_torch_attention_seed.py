"""The per-step values a captured CUDA graph reads from device memory, on
the CPU: the attention-dropout seed (a seed tensor drawn from each
attention layer's own generator, read by the plain attention and kept by
the forward for its backward; its mask the JAX package's
``_dropout_keep`` for the same seed value) and the optimizer ladder's
scalar rows (``ladder_scalars``: each row ``_scalars`` of its tensor; the
plain device-scalar step bit for bit with the plain by-value step).
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import pallas_attention as jpa
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.kernels import opt as kopt
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.optimizer import optimizer as topt


def _qkv(seed=0, shape=(2, 3, 37, 16)):
    r = onp.random.RandomState(seed)
    return [torch.from_numpy(r.randn(*shape).astype("f")) for _ in range(3)]


def _seed_tensor(value):
    bits = value & 0xFFFFFFFF
    return torch.tensor([bits - (1 << 32) if bits >> 31 else bits],
                        dtype=torch.int32)


@pytest.mark.parametrize("value", [7, 2 ** 31 + 12345])
def test_plain_attention_reads_its_seed_from_a_tensor(value):
    """Forward and backward of the plain versions with a one-element int32
    seed tensor equal the same calls with the int seed of the same 32
    bits (above 2^31 too: the tensor holds the bits, not the value)."""
    q, k, v = _qkv()
    t = _seed_tensor(value)
    o_int, l_int = fa.flash_attention_reference(q, k, v, dropout_p=0.2,
                                                dropout_seed=value)
    o_t, l_t = fa.flash_attention_reference(q, k, v, dropout_p=0.2,
                                            dropout_seed=t)
    assert torch.equal(o_int, o_t) and torch.equal(l_int, l_t)
    do = _qkv(1)[0]
    g_int = fa.flash_attention_bwd_reference(q, k, v, o_int, l_int, do,
                                             dropout_p=0.2, dropout_seed=value)
    g_t = fa.flash_attention_bwd_reference(q, k, v, o_t, l_t, do,
                                           dropout_p=0.2, dropout_seed=t)
    assert all(torch.equal(a, b) for a, b in zip(g_int, g_t))
    with pytest.raises(ValueError, match="one int32"):
        fa.flash_attention_reference(q, k, v, dropout_p=0.2,
                                     dropout_seed=t.to(torch.int64))


def test_generator_draws_different_well_mixed_seeds():
    """Each call draws one new seed tensor; 256 consecutive seeds are all
    different, flip about half their 31 bits from one to the next, and are
    no arithmetic sequence (seed + 1, or a Weyl step, would shift the
    mask: the hash adds the seed to q * H1 + k * H2)."""
    gen = torch.Generator().manual_seed(123456789)
    seeds = [fa.next_dropout_seed(gen) for _ in range(256)]
    assert all(s.dtype == torch.int32 and s.shape == (1,) for s in seeds)
    u = onp.array([int(s) for s in seeds], dtype=onp.int64)
    assert u.min() >= 0 and u.max() < 2 ** 31 - 1
    assert len(set(u.tolist())) == 256
    flips = [bin(int(a) ^ int(b)).count("1") for a, b in zip(u, u[1:])]
    assert 14 <= onp.mean(flips) <= 17 and min(flips) >= 4
    assert len(set(onp.diff(u).tolist())) > 250


def test_backward_uses_the_forward_seed():
    """The forward keeps a copy of its seed tensor: moving the caller's
    seed on before the backward leaves the gradients those of the
    forward's mask."""
    q, k, v = (x.requires_grad_() for x in _qkv(2))
    do = _qkv(3)[0]
    seed = _seed_tensor(99)
    out = fa.flash_attention(q, k, v, dropout_p=0.3, dropout_seed=seed)
    seed.add_(1)                          # moves on before the backward
    out.backward(do)
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    out = fa.flash_attention(q, k, v, dropout_p=0.3, dropout_seed=99)
    out.backward(do)
    assert all(torch.equal(a, x.grad) for a, x in zip(got, (q, k, v)))


def test_generator_seed_mask_equals_jax_dropout_keep():
    """For the seed value a layer's generator gives, the port's mask is the
    JAX package's _dropout_keep bit for bit (b*h = 6, S = 64)."""
    gen = torch.Generator().manual_seed(2 ** 40 + 5)
    for _ in range(3):
        seed = fa.next_dropout_seed(gen)
        bh = torch.arange(6).reshape(6, 1, 1)
        qp = torch.arange(64).reshape(1, 64, 1)
        kp = torch.arange(64).reshape(1, 1, 64)
        mine = fa._dropout_keep(fa._seed_value(seed), bh, qp, kp, 0.1)
        theirs = jpa._dropout_keep(
            jnp.uint32(int(seed)),
            jnp.arange(6, dtype=jnp.uint32).reshape(6, 1, 1),
            jnp.arange(64).reshape(1, 64, 1),
            jnp.arange(64).reshape(1, 1, 64), 0.1)
        assert onp.array_equal(mine.numpy(), onp.asarray(theirs))


def test_attention_layers_take_generators_from_the_net_generator():
    """initialize() gives each attention layer its own generator on the
    net's device, seeded from the net's generator: the same generator
    gives the same seeds, the layers differ; a training call draws from
    it (its state moves), a predict-mode call not at all, the CPU
    generator is never drawn again after initialize, and the layer's
    generator is among the net's noise generators (what a capture
    registers)."""
    cfg = dict(vocab_size=50, max_length=32, num_layers=2, units=32,
               hidden_size=64, num_heads=4, dropout=0.1)

    def make(seed):
        net = tbert.get_bert_model("bert_12_768_12", **cfg)
        net.initialize(device=mt.cpu(),
                       generator=torch.Generator().manual_seed(seed))
        return net

    a, b = make(1), make(1)
    atts = [layer.attention for layer in a.encoder.layers]
    gens = [att.dropout_generator for att in atts]
    seeds = [g.initial_seed() for g in gens]
    assert seeds == [layer.attention.dropout_generator.initial_seed()
                     for layer in b.encoder.layers]
    assert len(set(seeds)) == len(seeds)
    assert all(g.device.type == "cpu" for g in gens)
    assert all(any(g is n for n in a._noise_generators()) for g in gens)
    cpu_state = atts[0].seed_generator.get_state()
    states = [g.get_state() for g in gens]
    tok = torch.randint(0, 50, (2, 9), dtype=torch.int32)
    a(tok, torch.zeros_like(tok))                      # predict mode
    assert all(torch.equal(g.get_state(), st) for g, st in zip(gens, states))
    with mt.autograd.record():
        a(tok, torch.zeros_like(tok))
    assert not any(torch.equal(g.get_state(), st)
                   for g, st in zip(gens, states))
    assert torch.equal(atts[0].seed_generator.get_state(), cpu_state)


@pytest.mark.parametrize("mp", [False, True])
def test_ladder_scalar_rows_equal_scalars_and_plain_steps(mp):
    """For each rule: each row of ladder_scalars is _scalars of its
    tensor's (lr, wd, t), the rescale and t in f32, as the by-value table
    carries them; and the plain device-scalar step
    (bucket_step_dev_reference, reading those rows) is bit for bit the
    plain by-value step, in f32 (mp False) and in bf16 with f32 masters."""
    steps = [(0.01, 0.001, 1), (0.02, 0.0, 7), (0.01, 0.001, 1000)]
    r = onp.random.RandomState(4)
    for name in ("SGD", "NAG", "Signum", "Adam", "AdamW"):
        cls = getattr(topt, name)
        kw = dict(learning_rate=0.01, wd=0.001, multi_precision=True)
        if name in ("SGD", "NAG", "Signum"):
            kw["momentum"] = 0.9
        opt = cls(**kw)
        hyper = dict(opt._hyper(), rescale_grad=1 / 3)
        rows = kopt.ladder_scalars(cls, hyper, 1 / 3, steps)
        assert rows.dtype == onp.float32
        assert rows.shape == (3, kopt.SCALAR_STRIDE)
        h0, h1, _ = kopt._hyper_f32(name, hyper)
        for row, (lr, wd, t) in zip(rows, steps):
            want = kopt._scalars(name, h0, h1, lr, wd, t)
            assert tuple(row[:6]) == tuple(want), name
            # the rescale, then the update count (for the rules that
            # compute their own powers of t)
            assert row[6] == onp.float32(1 / 3) and row[7] == onp.float32(t)

        def members():
            out = []
            for n in (5, 300, 1):
                w = torch.from_numpy(r.randn(n).astype("f"))
                g = torch.from_numpy(r.randn(n).astype("f"))
                if mp:
                    w, g = w.to(torch.bfloat16), g.to(torch.bfloat16)
                st = opt.create_state_multi_precision(0, w) if mp else \
                    opt.create_state(0, w)
                out.append((w, st, g))
            return out
        state = r.get_state()
        a = members()
        r.set_state(state)
        b = members()
        kopt.bucket_step_reference(
            cls, None, False, mp,
            [(w, st, g, *s) for (w, st, g), s in zip(a, steps)], 1.0, hyper)
        kopt.bucket_step_dev(cls, None, mp, b, torch.from_numpy(rows), hyper)
        for (wa, sa, _), (wb, sb, _) in zip(a, b):
            assert torch.equal(wa, wb), name
            for la, lb in zip(kopt._leaves(sa), kopt._leaves(sb)):
                assert torch.equal(la, lb), name
