"""1-bit and 2-bit gradient compression with error feedback (counterpart of
mxnet_tpu/kvstore/gradient_compression.py).

A worker adds its residual to the gradient, quantizes the sum against a
threshold, keeps what the quantization lost as the next residual, and packs
the codes into ``uint8``: four 2-bit codes a byte ({-1, 0, 1} as {2, 0, 1},
the first element in the lowest bits) or eight 1-bit codes, padded with
zero codes. The receiving side unpacks and dequantizes. The JAX package
computes this in XLA, with no Pallas kernel behind it; here it is plain
PyTorch on the gradient's own device. The codes are integer arithmetic, so
the packed bytes and, for the same float operations, the residuals are
the JAX package's bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["GradientCompression"]


def _scalar(value, like):
    """``value`` as a 0-d tensor of ``like``'s dtype and device: a Python
    float enters JAX's arithmetic weakly typed, as the operand's dtype."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _pack(codes, per_byte, bits):
    """``codes`` (uint8, each below ``2**bits``) flattened, padded to a
    multiple of ``per_byte`` and packed, the first code lowest."""
    flat = codes.reshape(-1)
    pad = (-flat.numel()) % per_byte
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    lanes = flat.reshape(-1, per_byte)
    packed = lanes[:, 0].clone()
    for i in range(1, per_byte):
        packed |= lanes[:, i] << (i * bits)
    return packed


def _unpack(packed, per_byte, bits, shape):
    mask = (1 << bits) - 1
    lanes = torch.stack([(packed >> (i * bits)) & mask
                         for i in range(per_byte)], dim=1)
    n = 1
    for s in shape:
        n *= s
    return lanes.reshape(-1)[:n].reshape(shape)


def _compress_2bit(grad, residual, threshold):
    g = grad + residual
    thr = _scalar(threshold, g)
    one = torch.ones((), dtype=torch.int8, device=g.device)
    q = torch.where(g > thr, one, torch.where(g < -thr, -one,
                                              torch.zeros_like(one)))
    new_residual = g - q.to(grad.dtype) * thr
    codes = torch.where(q < 0, torch.full_like(q, 2, dtype=torch.uint8),
                        q.to(torch.uint8))
    return _pack(codes, 4, 2), new_residual


def _decompress_2bit(packed, threshold, shape, dtype):
    codes = _unpack(packed, 4, 2, shape)
    q = torch.where(codes == 2, torch.full_like(codes, -1, dtype=torch.int8),
                    codes.to(torch.int8)).to(dtype)
    return q * _scalar(threshold, q)


def _compress_1bit(grad, residual, threshold):
    # split at the threshold, dequantize to +-1 (the reference's
    # quantize_1bit / dequantize_1bit)
    g = grad + residual
    q = (g > _scalar(threshold, g)).to(torch.uint8)
    deq = torch.where(q == 1, 1.0, -1.0).to(grad.dtype)
    return _pack(q, 8, 1), g - deq


def _decompress_1bit(packed, threshold, shape, dtype):  # noqa: ARG001
    bits = _unpack(packed, 8, 1, shape)
    return torch.where(bits == 1, 1.0, -1.0).to(dtype)


class GradientCompression:
    """A stateful compressor with one residual per key.

    ``compress(key, grad)`` gives the packed ``uint8`` payload (1/16 or
    1/32 of the f32 bytes) and updates the key's residual;
    ``decompress`` mirrors it; ``compress_pipeline`` does both in one call
    for stores that aggregate locally."""

    def __init__(self, type="2bit", threshold=0.5):  # noqa: A002
        if type not in ("1bit", "2bit"):
            raise ValueError(f"compression type {type!r} not in 1bit/2bit")
        self.type = type
        self.threshold = float(threshold)
        self._residuals = {}

    def get_compression_factor(self):
        return 16 if self.type == "2bit" else 32

    def compress(self, key, grad):
        """Quantize and pack ``grad`` (a tensor); updates the residual."""
        res = self._residuals.get(key)
        if res is None or res.shape != grad.shape or \
                res.dtype != grad.dtype or res.device != grad.device:
            res = torch.zeros_like(grad)
        fn = _compress_2bit if self.type == "2bit" else _compress_1bit
        packed, self._residuals[key] = fn(grad, res, self.threshold)
        return packed

    def decompress(self, packed, shape, dtype):
        fn = _decompress_2bit if self.type == "2bit" else _decompress_1bit
        return fn(packed, self.threshold, tuple(shape), dtype)

    def compress_pipeline(self, key, grad):
        """Quantize and dequantize in one call (the local aggregation
        path)."""
        return self.decompress(self.compress(key, grad), grad.shape,
                               grad.dtype)
