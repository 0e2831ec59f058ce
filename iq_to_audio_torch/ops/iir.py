"""First-order recurrences ``y[n] = a[n]*y[n-1] + b[n]``.

Port of the JAX package's ``ops/iir.py``: the de-emphasis and the DC blocker
(constant coefficient) and the SSB feedback AGC (input-dependent
coefficients), each with its carry ``y[-1]`` threaded between chunks so that
chunked output equals whole-signal output.

With a constant ``a`` (:func:`first_order_scan_const`) the recurrence has the
closed block form

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

With input-dependent coefficients (:func:`first_order_scan`) the JAX package
uses ``lax.associative_scan`` over :func:`first_order_combine`; torch has
none, so the port runs the Hillis-Steele doubling scan over the same
combine: ``ceil(log2 N)`` rounds of whole-tensor ops, never a loop over
samples.  The cumprod-and-divide form of the float64 twin would underflow in
float32 over a chunk (0.999**161_250), so it is not used.
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


def first_order_combine(e1, e2):
    """Associative combine of ``(a, b)`` recurrence elements, ``e1`` first:
    ``(a1*a2, a2*b1 + b2)``."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def first_order_prefix(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the recurrence elements along the last axis:
    ``(cum_a, cum_b)`` with ``y[n] = cum_a[n]*y[-1] + cum_b[n]``.

    Hillis-Steele: after the round of stride ``d`` element ``n`` holds the
    composition of elements ``n-2d+1 .. n``.  The counterpart of the JAX
    package's ``lax.associative_scan(first_order_combine, (a, b))``.
    """
    cum_a, cum_b = a, b
    n = a.shape[-1]
    d = 1
    while d < n:
        ca, cb = first_order_combine(
            (cum_a[..., :-d], cum_b[..., :-d]), (cum_a[..., d:], cum_b[..., d:])
        )
        cum_a = torch.cat([cum_a[..., :d], ca], dim=-1)
        cum_b = torch.cat([cum_b[..., :d], cb], dim=-1)
        d *= 2
    return cum_a, cum_b


def first_order_scan(a: torch.Tensor, b: torch.Tensor, y0):
    """Evaluate ``y[n] = a[n]*y[n-1] + b[n]`` along the last axis through
    :func:`first_order_prefix`.  ``y0`` is the carried ``y[-1]`` (the batch
    shape of ``a``/``b``).  Returns ``(y, y_last)``.
    """
    cum_a, cum_b = first_order_prefix(a, b)
    y0 = torch.as_tensor(y0, dtype=torch.float32, device=b.device)
    y = cum_a * y0[..., None] + cum_b
    return y, y[..., -1]


def dc_blocker(x: torch.Tensor, radius: float, x_prev, y_prev):
    """One-pole DC blocker ``y[n] = x[n] - x[n-1] + r*y[n-1]``.

    Returns ``(y, (x_last, y_last))``.
    """
    x_prev = torch.as_tensor(x_prev, dtype=torch.float32, device=x.device)
    y_prev = torch.as_tensor(y_prev, dtype=torch.float32, device=x.device)
    shifted = torch.cat([x_prev[..., None], x[..., :-1]], dim=-1)
    y, y_last = first_order_scan_const(float(radius), x - shifted, y_prev)
    return y, (x[..., -1], y_last)


def agc_coefficients(x: torch.Tensor, target: float, decay: float, eps: float = 1e-6):
    """``(a, b)`` of the feedback-AGC recurrence (see :func:`feedback_agc`),
    rounded as the JAX package rounds them: samples with ``|x| <= eps`` hold
    the gain (``a = 1``, ``b = 0``)."""
    mag = x.abs()
    eps32 = float(np.float32(eps))
    valid = mag > eps32
    decay32 = np.float32(decay)
    keep = float(np.float32(1.0) - decay32)
    # a fill, not a copy from the host: the call stays capturable in a CUDA graph
    pull = mag.new_full((), float(decay32 * np.float32(target)))
    a = torch.where(valid, keep, 1.0)
    b = torch.where(valid, pull / torch.clamp(mag, min=eps32), 0.0)
    return a, b


def feedback_agc(x: torch.Tensor, target: float, decay: float, gain0, eps: float = 1e-6):
    """Feedback AGC ``g += decay * (target/|x| - g)`` applied as ``x * g``:
    the gain update comes before the sample is scaled, and samples with
    ``|x| <= eps`` leave it untouched.  The gain is carried across chunks.
    Returns ``(y, gain_last)``."""
    a, b = agc_coefficients(x, target, decay, eps)
    g, g_last = first_order_scan(a, b, gain0)
    return x * g, g_last
