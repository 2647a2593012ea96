"""The optimizer ladder as one launch per bucket, and its global-norm
pre-pass, on the card (csrc/opt_ladder.cu through kernels/opt.py:
bucket_step and bucket_sqnorm): a mixed bucket and a bucket split over
several launches against the plain ladder, the norm against
``Optimizer._fused_sqnorm``, two norm runs bit for bit, and a member the
kernel cannot take raising instead of running plain. Marked ``cuda``; every
test skips without a card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_opt.py

Tolerances: the kernel does the plain ladder's f32 operations in the same
order without contraction, so f32 leaves agree within 2 ulp (rtol 3e-7;
atol 1e-6 near a cancellation; Adam's ``1 - beta^t`` comes from libm's
powf on the kernel's side and numpy's power on the plain side) and the
bf16 weight is the master rounded, exactly. The norm sums in another order
than ``torch.sum``: rtol 1e-5.
"""
import pytest
import torch

from mxnet_tpu_torch.kernels import dispatch, opt as kopt
from mxnet_tpu_torch.optimizer import optimizer as topt

ADAMW = dict(beta1=0.9, beta2=0.999, eps=1e-8, rescale_grad=0.125)
SGD = dict(momentum=0.9, rescale_grad=0.125)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _members(dev, sizes, mp, n_state, seed, misalign=()):
    """``[(w, st, g)]`` as the Trainer holds them; the sizes in
    ``misalign`` lie 4 bytes off a 16-byte boundary."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.bfloat16 if mp else torch.float32
    out = []
    for n in sizes:
        off = (4 // torch.empty((), dtype=dt).element_size()
               if n in misalign else 0)

        def buf(scale, dtype=torch.float32, off=off, n=n):
            x = torch.randn(n + off, device=dev, generator=gen) * scale
            return x.to(dtype)[off:]

        master = buf(0.05)
        leaves = [buf(1e-3).abs() for _ in range(n_state)]
        inner = None if not leaves else (leaves[0] if n_state == 1
                                         else tuple(leaves))
        w = buf(1.0, dt)
        w.copy_(master.to(dt))
        out.append((w, (master, inner) if mp else inner, buf(0.01, dt)))
    return out


def _clone(x):
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.clone()
    return tuple(_clone(y) for y in x)


def _check(kernel, plain, what):
    for a, w in zip(kopt._leaves(kernel), kopt._leaves(plain)):
        assert a.dtype == w.dtype, what
        if a.dtype == torch.bfloat16:
            continue                     # checked against its master below
        torch.testing.assert_close(a, w, rtol=3e-7, atol=1e-6,
                                   msg=lambda m: f"{what}: {m}")


def _run(cls, mp, hyper, members, scal, gn, clip, scale, steps=2):
    """The bucket through the kernel and through its plain version from
    the same state; the launches and tensors the kernel counted."""
    plain = [(w.clone(), _clone(st), g) for w, st, g in members]
    before = (kopt.LAUNCHES.value, kopt.TENSORS.value)
    for step in range(steps):
        items = [(w, st, g) + s[:2] + (s[2] + step,)
                 for (w, st, g), s in zip(members, scal)]
        kopt.bucket_step(cls, clip, gn, mp, items, scale, hyper)
        pitems = [(w, st, g) + s[:2] + (s[2] + step,)
                  for (w, st, g), s in zip(plain, scal)]
        kopt.bucket_step_reference(cls, clip, gn, mp, pitems, scale, hyper)
    torch.cuda.synchronize()
    for k, ((w, st, _), (pw, pst, _)) in enumerate(zip(members, plain)):
        _check((w, st), (pw, pst), f"{cls.__name__} member {k}")
        if mp:
            assert torch.equal(w, st[0].to(torch.bfloat16))
    return (kopt.LAUNCHES.value - before[0], kopt.TENSORS.value - before[1])


@pytest.mark.cuda
def test_cuda_mixed_bucket_is_one_launch_and_matches_plain(cuda_device):
    """BERT's sizes (a 768 bias, 3 elements, a 30522 vector, a 3072 x 768
    matrix), an odd size and a view 4 bytes off alignment in one bf16
    bucket with masters, per-tensor lr, wd and t that differ, the global
    norm's scale and a clip: one launch a step, every tensor updated; then
    SGD momentum in f32, and a bucket of one through param_step."""
    sizes = [768, 3, 30522, 3072 * 768, 4099, 1000]
    members = _members(cuda_device, sizes, True, 2, 1, misalign=(1000,))
    scal = [(1e-3 * (1 + k), 0.01 * (k % 3), 1 + 2 * k)
            for k in range(len(sizes))]
    assert _run(topt.AdamW, True, ADAMW, members, scal, True, 0.02,
                0.5) == (2, 2 * len(sizes))
    members = _members(cuda_device, sizes, False, 1, 2, misalign=(4099,))
    assert _run(topt.SGD, False, SGD, members, scal, False, None,
                1.0) == (2, 2 * len(sizes))
    (w, st, g), = _members(cuda_device, [2049], False, 2, 3)
    pw, pst = w.clone(), _clone(st)
    kopt.param_step(topt.Adam, None, False, False, w, st, g, 1e-3, 0.0, 4,
                    1.0, ADAMW)
    topt.Optimizer._fused_param_step(topt.Adam, None, False, False, pw, pst,
                                     g, 1e-3, 0.0, 4, 1.0, ADAMW)
    torch.cuda.synchronize()
    _check((w, st), (pw, pst), "param_step")


@pytest.mark.cuda
def test_cuda_bucket_over_the_table_capacity_splits(cuda_device):
    """1100 tiny tensors (1..7 elements) take ceil(1100 / capacity)
    launches a step and agree with the plain ladder."""
    sizes = [1 + k % 7 for k in range(1100)]
    members = _members(cuda_device, sizes, False, 1, 4)
    scal = [(1e-2, 1e-3 * (k % 2), 1) for k in range(len(sizes))]
    launches = -(-len(sizes) // kopt.TABLE_CAPACITY)
    assert launches > 1
    assert _run(topt.NAG, False, SGD, members, scal, False, None, 1.0,
                steps=1) == (launches, len(sizes))


@pytest.mark.cuda
def test_cuda_sqnorm_matches_plain_and_repeats_its_bits(cuda_device):
    """bf16 gradients of BERT's sizes and f32 ones, one of them misaligned,
    and 1100 tiny ones (a split): the bucket's sum of squares within rtol
    1e-5 of ``_fused_sqnorm``, written into ``out``; a second run gives the
    same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    for dt, sizes in ((torch.bfloat16, [768, 3, 30522, 3072 * 768, 4099]),
                      (torch.float32, [1000, 8192, 8193, 5]),
                      (torch.float32, [1 + k % 7 for k in range(1100)])):
        gs = [torch.randn(n + 1, device=cuda_device, generator=gen
                          ).to(dt)[1 if n == 1000 else 0:][:n]
              for n in sizes]
        out = torch.zeros(3, device=cuda_device)
        before = kopt.SQNORM_LAUNCHES.value
        first = kopt.bucket_sqnorm(gs, 0.25, out=out[1]).clone()
        again = kopt.bucket_sqnorm(gs, 0.25)
        assert kopt.SQNORM_LAUNCHES.value == before + 2
        want = topt.Optimizer._fused_sqnorm(gs, 0.25)
        torch.testing.assert_close(out[1], want, rtol=1e-5, atol=0)
        assert out[0] == 0 and out[2] == 0
        assert torch.equal(first, again)


@pytest.mark.cuda
def test_cuda_member_the_kernel_cannot_run_raises(cuda_device):
    """A CUDA member decided ``kernel`` that the kernel cannot run (a
    transposed view) raises; nothing runs the plain ladder on the card."""
    (w, st, g), = _members(cuda_device, [64 * 48], False, 1, 5)
    w2 = w.view(64, 48).t()
    before = dispatch.COUNTS.get(("opt_sgd", "kernel"), 0)
    with pytest.raises(ValueError, match="contiguous"):
        kopt.bucket_step(topt.SGD, None, False, False,
                         [(w2, st.view(64, 48).t(), g.view(64, 48).t(),
                           0.1, 0.0, 1)], 1.0, SGD)
    assert dispatch.COUNTS[("opt_sgd", "kernel")] == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        kopt.bucket_sqnorm([g.view(64, 48).t()], 1.0)
