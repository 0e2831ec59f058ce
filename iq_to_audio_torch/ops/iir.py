"""Constant-coefficient first-order recurrences as block matmuls.

Port of the JAX package's ``ops/iir.py::first_order_scan_const`` and
``deemphasis``.  ``y[n] = a*y[n-1] + b[n]`` has the closed block form

    y[i] = a^(i+1) * y_in + sum_{j<=i} a^(i-j) * b[j]     (per block)

so each block is one lower-triangular ``(B, B)`` matmul.  The carry across
blocks is the same recurrence at block rate with coefficient ``a^B``; where
the JAX package folds it with a sequential ``lax.scan``, the port evaluates
it as a second small triangular matmul over the powers ``(a^B)^(j-i)``
(one launch instead of one per block: ~158 blocks per flagship chunk).  The
two folds differ only in f32 rounding order; the tests hold them within
-100 dB of each other.

Matmuls run in full float32: on CUDA the pipeline asserts that
``torch.backends.cuda.matmul.allow_tf32`` is False.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_BLOCK = 1024  # accelerator block; see _block_size()


def _block_size(a: float, device: torch.device) -> int:
    """Triangular-matmul block width, chosen per device as the JAX package
    chooses it per backend: 1024 on the card; on the CPU the smallest
    power-of-two block (>= 64) with ``a^B <= 0.01`` so the CPU tests compare
    like with like."""
    if device.type != "cpu":
        return _BLOCK
    mag = abs(float(a))
    if mag >= 1.0:
        return _BLOCK
    need = math.log(0.01) / math.log(mag) if mag > 0.0 else 1.0
    blk = 64
    while blk < need and blk < _BLOCK:
        blk *= 2
    return blk


@functools.lru_cache(maxsize=32)
def _scan_matrices(a: float, blk: int, nb: int, device: str):
    """Cached device constants: in-block triangle, in-block powers, and the
    cross-block fold triangle with its ``y0`` powers."""
    i = np.arange(blk)
    delta = i[:, None] - i[None, :]
    tri = np.where(delta >= 0, float(a) ** np.maximum(delta, 0), 0.0)
    powers = float(a) ** (i + 1)
    a_blk = float(np.float32(float(a) ** blk))
    j = np.arange(nb)
    dj = j[:, None] - j[None, :]
    with np.errstate(under="ignore"):
        fold = np.where(dj >= 0, a_blk ** np.maximum(dj, 0), 0.0)
        fold_y0 = a_blk ** (j + 1)
    as_t = functools.partial(torch.tensor, dtype=torch.float32, device=device)
    return (
        as_t(tri.T.astype(np.float32)),
        as_t(powers.astype(np.float32)),
        as_t(fold.T.astype(np.float32)),
        as_t(fold_y0.astype(np.float32)),
    )


def first_order_scan_const(a: float, b: torch.Tensor, y0: torch.Tensor):
    """``y[n] = a*y[n-1] + b[n]`` along the last axis for a constant ``a``.

    ``y0`` is the carried ``y[-1]`` (the batch shape of ``b``).  Returns
    ``(y, y_last)``.
    """
    orig_shape = b.shape
    n = orig_shape[-1]
    blk = min(_block_size(a, b.device), n)
    nb = -(-n // blk)
    pad = nb * blk - n
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    blocks = b.reshape(*b.shape[:-1], nb, blk)
    tri_t, powers, fold_t, fold_y0 = _scan_matrices(float(a), blk, nb, str(b.device))
    pref = blocks @ tri_t  # (..., nb, blk): the y0-independent part
    y0 = y0.to(torch.float32)
    # exact y at each block end: ends[j] = sum_{i<=j} a_B^(j-i) p_last[i]
    # + a_B^(j+1) y0
    ends = pref[..., -1] @ fold_t + y0[..., None] * fold_y0
    in_carry = torch.cat([y0[..., None], ends[..., :-1]], dim=-1)
    y = pref + in_carry[..., None] * powers
    y = y.reshape(*orig_shape[:-1], nb * blk)[..., :n]
    return y, y[..., -1]


def deemphasis(x: torch.Tensor, alpha: float, y0: torch.Tensor):
    """Single-pole FM de-emphasis ``y[n] = (1-alpha)*x[n] + alpha*y[n-1]``
    with exact ``y[-1]`` carry (reference ``decoders/nfm.py:27-62``)."""
    beta = float(np.float32(1.0) - np.float32(alpha))
    return first_order_scan_const(float(alpha), x * beta, y0)
