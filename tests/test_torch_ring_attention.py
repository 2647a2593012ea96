"""The port's ring attention (mxnet_tpu_torch/parallel/ring_attention.py,
K6: a flash hop on every hop) against the JAX package's
``ring_flash_attention_sharded`` and ``ring_attention_sharded`` over 4 of
the 8 virtual CPU devices of tests/conftest.py (its Pallas kernels in
interpret mode), with the same numpy inputs and output gradient. The
port's mesh holds 4 ``cpu`` positions, so each hop runs the hop kernels'
plain versions (ops/ring_hop.py). Causal and not; (2, 2, 64, 16) and
local shards of 25 rows (S = 100 over 4: the JAX package tile-pads them
to 128, the port pads nothing); D = 12, where the JAX package takes its
plain ring and the port its flash ring (the plain hops take any head dim;
on the card D = 12 takes K4/K5 per hop). Forward within rtol 1e-5, atol
1e-6; gradients within rtol 2e-4, atol 2e-5, the JAX package's own
tolerances for its flash gradients.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu.parallel import ring_attention as jring
from mxnet_tpu_torch.kernels import build as kbuild
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import ring_attention as tring


def _meshes(axes, n):
    return (jmesh.make_mesh(axes, jax.devices()[:n]),
            tmesh.make_mesh(axes, [torch.device("cpu")] * n))


def _inputs(seed, shape):
    rs = onp.random.RandomState(seed)
    return [rs.randn(*shape).astype("f") * 0.5 for _ in range(4)]


def _jax_side(fn, arrs, mesh, causal):
    q, k, v, g = (jnp.asarray(a) for a in arrs)
    out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, causal=causal),
                       q, k, v)
    return [onp.asarray(out)] + [onp.asarray(x) for x in vjp(g)]


def _port_side(fn, arrs, mesh, causal):
    q, k, v = (torch.from_numpy(a.copy()).requires_grad_()
               for a in arrs[:3])
    out = fn(q, k, v, mesh, causal=causal)
    out.backward(torch.from_numpy(arrs[3].copy()))
    return [out.detach().numpy()] + [t.grad.numpy() for t in (q, k, v)]


def _hold(port, ref):
    onp.testing.assert_allclose(port[0], ref[0], rtol=1e-5, atol=1e-6)
    for p, r in zip(port[1:], ref[1:]):
        onp.testing.assert_allclose(p, r, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 2, 64, 16), (1, 2, 100, 16)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_matches_the_jax_package(shape, causal):
    jm, tm = _meshes({"sp": 4}, 4)
    arrs = _inputs(0, shape)
    _hold(_port_side(tring.ring_flash_attention_sharded, arrs, tm, causal),
          _jax_side(jring.ring_flash_attention_sharded, arrs, jm, causal))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_ring_and_a_ragged_head_dim_match_the_jax_package(causal):
    """D = 12 is not a multiple of 8: the JAX package's flash ring takes
    its plain ring (differentiated by autodiff), the port's runs the flash
    hops as at any other head dim; both plain rings agree too."""
    jm, tm = _meshes({"sp": 4}, 4)
    arrs = _inputs(1, (1, 2, 100, 12))
    ref = _jax_side(jring.ring_attention_sharded, arrs, jm, causal)
    _hold(_port_side(tring.ring_attention_sharded, arrs, tm, causal), ref)
    _hold(_port_side(tring.ring_flash_attention_sharded, arrs, tm, causal),
          _jax_side(jring.ring_flash_attention_sharded, arrs, jm, causal))


def test_hops_run_the_kernels_by_the_hop_schedule(monkeypatch):
    """n^2 forward and backward hops, or n(n+1)/2 causal: the diagonal hop
    runs causal, past hops in full, future hops none; every hop takes the
    position's q and the resident block at the local shard's shape, the
    forward hops the position's running state (acc, lse), the backward
    hops the position's dout, global lse and delta and the three float32
    sums. On CPU tensors no kernel launches, K6 counts nothing and the
    ring takes the plain route both ways."""
    calls = []

    def spy(name, fn):
        def wrapper(q, k, v, *rest, causal, scale, **kw):
            calls.append((name, causal, tuple(q.shape), tuple(k.shape),
                          len(rest)))
            return fn(q, k, v, *rest, causal=causal, scale=scale, **kw)
        return wrapper

    monkeypatch.setattr(tring, "ring_hop_fwd",
                        spy("fwd", tring.ring_hop_fwd))
    monkeypatch.setattr(tring, "ring_hop_bwd",
                        spy("bwd", tring.ring_hop_bwd))
    _, tm = _meshes({"sp": 4}, 4)
    before = {c.name: c.value for c in kbuild.COUNTERS.values()}
    arrs = _inputs(2, (1, 2, 64, 16))
    for causal, hops, diag in ((False, 16, 0), (True, 10, 4)):
        calls.clear()
        tring.ROUTES.clear()
        _port_side(tring.ring_flash_attention_sharded, arrs, tm, causal)
        for name, rest in (("fwd", 2), ("bwd", 6)):
            mine = [c for c in calls if c[0] == name]
            assert len(mine) == hops
            assert sum(c[1] for c in mine) == diag
            assert {c[2:] for c in mine} == {((1, 2, 16, 16), (1, 2, 16, 16),
                                              rest)}
        assert tring.ROUTES == {"plain": 2}
    assert {c.name: c.value for c in kbuild.COUNTERS.values()} == before
    assert tring.LAUNCHES.value == before["ring_flash_attention"]


def test_other_mesh_axes_carry_replicas():
    """Over a (dp 2, sp 4) mesh the ring runs once over the sp positions;
    the JAX package computes the same on every dp replica."""
    jm, tm = _meshes({"dp": 2, "sp": 4}, 8)
    arrs = _inputs(3, (2, 2, 64, 16))
    _hold(_port_side(tring.ring_flash_attention_sharded, arrs, tm, True),
          _jax_side(jring.ring_flash_attention_sharded, arrs, jm, True))
    assert tm.positions("sp") == [torch.device("cpu")] * 4


def test_bodies_take_shard_lists_and_interpret_does_nothing():
    """The per-position bodies take the shard lists; without autograd the
    flash ring returns the same outputs as through its Function, whatever
    ``interpret`` says, and a bf16 ring stays within bf16 rounding of the
    f32 one."""
    _, tm = _meshes({"sp": 4}, 4)
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, (1, 2, 64, 16))[:3])
    shards = [tmesh.split(t, tm, "sp", 2) for t in (q, k, v)]
    with torch.no_grad():
        plain = tring.ring_flash_attention(*shards, causal=True)
        for interpret in (True, False):
            again = tring.ring_flash_attention(*shards, causal=True,
                                               interpret=interpret)
            assert all(torch.equal(a, b) for a, b in zip(plain, again))
    assert isinstance(plain, list) and len(plain) == 4
    whole = tring.ring_flash_attention_sharded(
        q.requires_grad_(), k, v, tm, causal=True)
    assert torch.equal(whole.detach(), tmesh.assemble(plain, 2))
    bf = tring.ring_flash_attention_sharded(
        *(t.detach().bfloat16() for t in (q, k, v)), tm, causal=True)
    assert bf.dtype == torch.bfloat16
    err = (bf.float() - whole.detach()).abs().max()
    assert err <= 2 ** -7 * whole.detach().abs().max()
