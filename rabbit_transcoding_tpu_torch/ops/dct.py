"""Batched 2D block DCT/IDCT as fp32 matrix products.

Port of ``rabbit_transcoding_tpu/ops/dct.py``.  A 2D DCT-II of a BxB block
is ``D @ X @ D^T``; batching every block into one ``(..., B, B)`` tensor turns
the transform into two batched matrix products.  This module turns TF32 off
when it is imported, so ``torch.matmul`` runs in full fp32 (the reference's
``Precision.HIGHEST``).

Summation order.  The reference's fp32 dot on the CPU sums each contraction
in four interleaved FMA partial sums (terms ``j = t mod 4``) and combines
them as ``(s0 + s1) + (s2 + s3)``; ``torch.matmul`` sums in one sequential
FMA chain.  The two disagree in the last bit on ~3/4 of the values, which
flips a quantised coefficient at a rounding boundary now and then.
``matmul4`` reproduces the reference's order, so the port's coefficients,
and the CUDA kernel's, equal the reference's bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import to_device

# fp32 everywhere: TF32 keeps ~10 mantissa bits, far too coarse for 10-bit
# planes in a closed codec loop (the reference pins Precision.HIGHEST for the
# same reason).  This module holds the port's only matrix products; every
# path to them imports it first.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (rows = basis functions), float32."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] /= np.sqrt(2.0)
    d = d.astype(np.float32)
    d.flags.writeable = False
    return d


@functools.lru_cache(maxsize=None)
def dct_tensor(n: int, device: torch.device) -> torch.Tensor:
    """``dct_matrix(n)`` as a float32 tensor on ``device`` (shared: do not
    write to it)."""
    return to_device(dct_matrix(n).copy(), device)


def blockify(x: torch.Tensor, block: int) -> torch.Tensor:
    """(..., H, W) -> (..., H//B, W//B, B, B).  H, W must be multiples of B."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // block, block, w // block, block)
    return x.transpose(-3, -2)


def deblockify(x: torch.Tensor) -> torch.Tensor:
    """(..., nby, nbx, B, B) -> (..., H, W)."""
    *lead, nby, nbx, b, b2 = x.shape
    return x.transpose(-3, -2).reshape(*lead, nby * b, nbx * b2)


def matmul4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (broadcast like ``torch.matmul``) summed in the reference's
    order: four partial sums over the terms j = 0, 1, 2, 3 (mod 4), combined
    as (s0 + s1) + (s2 + s3)."""
    s = [torch.matmul(a[..., t::4], b[..., t::4, :]) for t in range(4)]
    return (s[0] + s[1]) + (s[2] + s[3])


def dct2d(blocks: torch.Tensor) -> torch.Tensor:
    """Forward 2D DCT over the last two dims: D @ X @ D^T."""
    d = dct_tensor(blocks.shape[-1], blocks.device)
    return matmul4(matmul4(d, blocks), d.T)


def idct2d(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse 2D DCT over the last two dims: D^T @ C @ D."""
    d = dct_tensor(coeffs.shape[-1], coeffs.device)
    return matmul4(matmul4(d.T, coeffs), d)


def pad_to_block(x: np.ndarray, block: int) -> np.ndarray:
    """Edge-pad the trailing two dims of a host array up to a multiple of
    `block` (edge padding keeps block energy low at image borders)."""
    h, w = x.shape[-2:]
    ph = (-h) % block
    pw = (-w) % block
    if ph == 0 and pw == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 2) + [(0, ph), (0, pw)]
    return np.pad(x, pad, mode="edge")
