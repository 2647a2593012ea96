"""``parallel.make_data_parallel_step`` and ``make_shard_map_step``
(mxnet_tpu_torch/parallel/data_parallel.py) on four CPU positions against
the JAX package's builders on four of the eight virtual CPU devices
(tests/conftest.py), 64-bit types on: a two-layer MLP's loss and SGD
update written once for each framework, three steps from the same
parameters and batches. Losses and parameters within rtol 1e-5, atol
1e-6."""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu  # noqa: F401 - the JAX package's settings (64-bit types)
from mxnet_tpu.parallel import data_parallel as jdp
from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.parallel import mesh as tmesh

R = onp.random.RandomState(11)
PARAMS = {"w1": R.randn(6, 10).astype("f") * 0.5,
          "b1": R.randn(10).astype("f") * 0.1,
          "w2": R.randn(10, 3).astype("f") * 0.5}
BATCHES = [(R.randn(16, 6).astype("f"), R.randn(16, 3).astype("f"))
           for _ in range(3)]


def _jax_loss(p, batch):
    x, y = batch
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] - y) ** 2)


def _torch_loss(p, batch):
    x, y = batch
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] - y) ** 2)


def _jax_update(p, g, state, lr):
    new_state = jax.tree_util.tree_map(lambda m, d: 0.9 * m + d, state, g)
    return (jax.tree_util.tree_map(lambda w, m: w - lr * m, p, new_state),
            new_state)


def _torch_update(p, g, state, lr):
    new_state = {k: 0.9 * state[k] + g[k] for k in state}
    return {k: p[k] - lr * new_state[k] for k in p}, new_state


def _run(builder):
    jm = jmesh.make_mesh({"dp": 4}, jax.devices()[:4])
    tm = tmesh.make_mesh({"dp": 4}, [torch.device("cpu")] * 4)
    jstep = getattr(jdp, builder)(_jax_loss, _jax_update, jm)
    tstep = getattr(tpar, builder)(_torch_loss, _torch_update, tm)
    jp = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    js = {k: jnp.zeros_like(v) for k, v in jp.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in PARAMS.items()}
    ts = {k: torch.zeros_like(v) for k, v in tp.items()}
    for x, y in BATCHES:
        jp, js, jl = jstep(jp, js, (jnp.asarray(x), jnp.asarray(y)), 0.05)
        tp, ts, tl = tstep(tp, ts, (torch.from_numpy(x),
                                    torch.from_numpy(y)), 0.05)
        onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl),
                                    rtol=1e-5, atol=1e-6)
    for k in PARAMS:
        onp.testing.assert_allclose(tp[k].numpy(), onp.asarray(jp[k]),
                                    rtol=1e-5, atol=1e-6, err_msg=k)
        onp.testing.assert_allclose(ts[k].numpy(), onp.asarray(js[k]),
                                    rtol=1e-5, atol=1e-6, err_msg=k)
    return tp


@pytest.mark.parametrize("builder", ["make_data_parallel_step",
                                     "make_shard_map_step"])
def test_step_builders_match_jax(builder):
    _run(builder)


def test_builders_agree_and_refuse_what_waits():
    """The whole-batch step and the per-shard mean agree (equal shards of
    a mean loss); a batch that does not split over the axis raises;
    ``param_specs`` gives the same step and checks each spec."""
    a = _run("make_data_parallel_step")
    b = _run("make_shard_map_step")
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-6)
    tm = tmesh.make_mesh({"dp": 4}, [torch.device("cpu")] * 4)
    p = {k: torch.from_numpy(v) for k, v in PARAMS.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    odd = (torch.zeros(6, 6), torch.zeros(6, 3))
    for builder in ("make_data_parallel_step", "make_shard_map_step"):
        step = getattr(tpar, builder)(_torch_loss, _torch_update, tm)
        with pytest.raises(tmesh.ShardingError, match="divisible"):
            step(p, s, odd, 0.1)
    # param_specs lays the parameters out: the same logical step, and a
    # spec its mesh axis does not divide raises naming the parameter
    step = tpar.make_data_parallel_step(
        _torch_loss, _torch_update, tm,
        param_specs={"w1": None, "b1": tmesh.PartitionSpec(), "w2": None})
    plain = tpar.make_data_parallel_step(_torch_loss, _torch_update, tm)
    even = tuple(torch.from_numpy(a) for a in BATCHES[0])
    for x, y in zip(step(p, s, even, 0.1), plain(p, s, even, 0.1)):
        for k in (x if isinstance(x, dict) else {"loss": x}):
            want = y[k] if isinstance(y, dict) else y
            got = x[k] if isinstance(x, dict) else x
            assert torch.equal(got, want), k
    bad = tpar.make_data_parallel_step(
        _torch_loss, _torch_update, tm,
        param_specs={"w1": tmesh.PartitionSpec(None, "dp")})
    with pytest.raises(tmesh.ShardingError, match="parameter w1"):
        bad(p, s, even, 0.1)
