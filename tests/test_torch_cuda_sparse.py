"""Sparse arrays and the row-sparse training path on the card, at a small
size: chip_smoke.py's phase 23a (the matrix-factorization tool with lazy
Adam rows, against a CPU twin, untouched rows bit for bit, LAMB and a
hybridized model dense), 23b (``sparse.dot`` and its dense operand's
gradient against the CPU) and 23c (the slice's new names on the card
against the CPU), then pinned host memory and ``check_consistency``'s
default devices. Marked ``cuda``; every test skips without a card. The
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_sparse.py
"""
import numpy as onp
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import _sweep_cases as sc


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_matrix_factorization_phase(card):  # noqa: ARG001
    out = chip_smoke.phase_sparse_mf(torch, mt, users=5000, items=800,
                                     rank=16, batch=512, steps=20)
    assert out["rmse_after"] < out["rmse_before"]
    assert out["untouched_rows"]["user"] > 0
    assert all(0 < r <= 512 for r in out["rows_touched"]["item"])


@pytest.mark.cuda
def test_sparse_dot_phase(card):  # noqa: ARG001
    out = chip_smoke.phase_sparse_dot(torch, mt, rows=512, cols=1 << 14,
                                      nnz=8, d=16)
    assert out["csr_dense"]["max_share_vs_cpu"] <= 1e-5


@pytest.mark.cuda
def test_new_names_on_the_card(card):  # noqa: ARG001
    out = chip_smoke.sweep_on_card(torch, mt, sc.REST_CASES, "23c",
                                   "sparse_sweep")
    assert out["failed"] == 0 and out["swept"] == len(sc.REST_CASES)


@pytest.mark.cuda
def test_sparse_storage_stays_on_the_card(card):
    d = onp.zeros((6, 4), "float32")
    d[[1, 4]] = onp.arange(8, dtype="float32").reshape(2, 4) + 1
    x = mt.np.array(d)
    for stype in ("csr", "row_sparse"):
        s = x.tostype(stype)
        assert s.device == card and s.indices.device == card
        onp.testing.assert_array_equal(s.asnumpy(), d)
    r = x.tostype("row_sparse")
    kept = mt.nd.sparse.retain(r, mt.np.array(onp.array([4], "int32")))
    assert kept.device == card and kept.indices.asnumpy().tolist() == [4]
    both = mt.nd.sparse.add(r, kept)
    assert both.device == card
    onp.testing.assert_array_equal(both.asnumpy()[4], 2 * d[4])


@pytest.mark.cuda
def test_pinned_memory_and_consistency(card):  # noqa: ARG001
    x = mt.np.array([1.0, 2.0], ctx=mt.cpu_pinned())
    assert x.device.type == "cpu" and x._data.is_pinned()
    y = mt.np.array([3.0]).copyto(mt.cpu_pinned())
    assert y._data.is_pinned()
    out = mt.test_utils.check_consistency(lambda v: (v * v).sum(),
                                          [onp.arange(4.0, dtype="f")])
    assert float(out) == 14.0
