"""Matrix factorization with two sparse-gradient embeddings (counterpart of
example/matrix_factorization.py):

    python -m mxnet_tpu_torch.tools.matrix_factorization [--users 200]
        [--items 300] [--rank 8] [--steps 400] [--batch-size 256]
        [--lr 0.05] [--cpu]

The example's model and loop: a synthetic low-rank ratings matrix (factors
``randn / sqrt(rank)`` and noise ``0.05 * randn`` from
``RandomState(0)``), two ``nn.Embedding(sparse_grad=True)`` tables
initialized ``Normal(1 / sqrt(rank))``, Adam with ``lazy_update`` through
the Trainer, ``L2Loss``, batches of ``randint`` user and item ids; the
rmse over the example's fixed pairs after the first step and after the
last, which must fall below 0.8 of the first. Runs on ``cuda:0`` unless
``--cpu``.

At the example's sizes the ratings matrix is built dense, as there. At
larger ones (MovieLens-20M's 138 493 users x 27 278 items would be 3.8e9
floats) :class:`Ratings` computes each sampled rating from the two
factors, on the device, plus noise that a seeded hash of the pair gives,
so every pair has one fixed rating without the matrix.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from .. import _random, autograd, gluon, initializer
from .. import device as _device
from .train_mnist import device_scope

__all__ = ["Ratings", "MF", "build_mf", "draw_batch", "train_step", "rmse",
           "eval_pairs", "main"]

#: the largest users x items built as a dense matrix, as the example does
DENSE_LIMIT = 1 << 24


def _hash32(x):
    """A 32-bit integer hash (lowbias32) of int64 values, in int64 ops."""
    m = 0xFFFFFFFF
    x = x & m
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & m
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


class Ratings:
    """The example's synthetic ratings: ``u_true @ i_true.T + noise``.
    Dense (the example's own construction, from the same RandomState) up
    to :data:`DENSE_LIMIT` entries, else each rating from the factors on
    the device and the pair's hashed normal noise."""

    def __init__(self, users, items, rank, rs, device):
        self.users, self.items = users, items
        u_true = rs.randn(users, rank).astype("f") / rank ** 0.5
        i_true = rs.randn(items, rank).astype("f") / rank ** 0.5
        self.dense = users * items <= DENSE_LIMIT
        self.device = device
        if self.dense:
            noise = 0.05 * rs.randn(users, items).astype("f")
            self.matrix = u_true @ i_true.T + noise
        else:
            self.u = torch.from_numpy(u_true).to(device)
            self.i = torch.from_numpy(i_true).to(device)
            self.salt = [int(_hash32(torch.tensor(s)).item())
                         for s in (0x5EED, 0x5EED + 1)]

    def _noise(self, uid, iid):
        key = uid.long() * self.items + iid.long()
        a = _hash32(key ^ self.salt[0])
        b = _hash32(a ^ self.salt[1])
        u1 = (a.double() + 0.5) / 4294967296.0
        u2 = (b.double() + 0.5) / 4294967296.0
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2 * math.pi * u2)
        return (0.05 * z).float()

    def lookup(self, uid, iid):
        """The ratings of the pairs (host int arrays), a float32 tensor on
        the device."""
        if self.dense:
            return torch.from_numpy(
                np.ascontiguousarray(self.matrix[uid, iid])).to(self.device)
        u = torch.from_numpy(np.asarray(uid)).to(self.device)
        i = torch.from_numpy(np.asarray(iid)).to(self.device)
        return (self.u[u] * self.i[i]).sum(1) + self._noise(u, i)


class MF(gluon.nn.HybridBlock):
    """The example's model: the rating is the dot product of a user's and
    an item's factors, two ``sparse_grad`` embedding tables."""

    def __init__(self, users, items, rank):
        super().__init__()
        self.user = gluon.nn.Embedding(users, rank, sparse_grad=True)
        self.item = gluon.nn.Embedding(items, rank, sparse_grad=True)

    def forward(self, uid, iid):
        return (self.user(uid) * self.item(iid)).sum(axis=-1)


def build_mf(users, items, rank, lr=0.05, device=None):
    """``(net, trainer, lossfn)`` as the example builds them: the weights
    drawn ``Normal(1 / sqrt(rank))`` from a generator seeded 0, Adam with
    ``lazy_update``."""
    device = _device.resolve(device)
    _random.seed(0)
    net = MF(users, items, rank)
    net.initialize(initializer.Normal(1.0 / rank ** 0.5), device=device,
                   generator=torch.Generator().manual_seed(0))
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr, "lazy_update": True})
    return net, trainer, gluon.loss.L2Loss()


def draw_batch(ratings, rs, batch_size):
    """The example's batch: ``randint`` user and item ids from ``rs``,
    and their ratings. Returns ``(uid, iid, y)``, int32 and float32
    tensors on the ratings' device."""
    uid = rs.randint(0, ratings.users, batch_size)
    iid = rs.randint(0, ratings.items, batch_size)
    y = ratings.lookup(uid, iid)
    dev = ratings.device
    return (torch.from_numpy(uid.astype(np.int32)).to(dev),
            torch.from_numpy(iid.astype(np.int32)).to(dev), y)


def train_step(net, trainer, lossfn, uid, iid, y):
    """One step of the example: the per-sample loss recorded, backward,
    ``trainer.step(batch)``."""
    with autograd.record():
        loss = lossfn(net(uid, iid), y)
    autograd.backward(loss)
    trainer.step(uid.shape[0])
    return loss


def eval_pairs(users, items):
    """The example's fixed pairs: each user four times, items ``7k mod
    items``."""
    uid = np.arange(users).repeat(4) % users
    iid = (np.arange(users * 4) * 7) % items
    return uid, iid


def rmse(net, ratings, pairs=None):
    """The rmse of the net's predictions over ``pairs`` (the example's by
    default), read on the host."""
    uid, iid = pairs if pairs is not None else eval_pairs(ratings.users,
                                                          ratings.items)
    dev = ratings.device
    with autograd.pause():
        pred = net(torch.from_numpy(uid.astype(np.int32)).to(dev),
                   torch.from_numpy(iid.astype(np.int32)).to(dev))
    truth = ratings.lookup(uid, iid)
    return float(torch.sqrt(torch.mean((pred.detach() - truth) ** 2)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--users", type=int, default=200)
    ap.add_argument("--items", type=int, default=300)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = _device.cpu() if args.cpu else _device.gpu(0)
    rs = np.random.RandomState(0)
    with device_scope(device):
        ratings = Ratings(args.users, args.items, args.rank, rs, device)
        net, trainer, lossfn = build_mf(args.users, args.items, args.rank,
                                        args.lr, device)
        first = None
        t0 = time.perf_counter()
        for step in range(args.steps):
            train_step(net, trainer, lossfn, *draw_batch(
                ratings, rs, args.batch_size))
            if step == 0:
                first = rmse(net, ratings)
        final = rmse(net, ratings)
    print(f"rmse {first:.4f} -> {final:.4f} over {args.steps} steps "
          f"({time.perf_counter() - t0:.2f} s)")
    if not final < first * 0.8:
        raise SystemExit("FAIL: rmse did not improve")
    print("matrix factorization example OK")
    return first, final


if __name__ == "__main__":
    main()
