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

Every function computes in its input's dtype: float32, rounded as the JAX
package rounds, or float64, in which the SSB decoder runs its DC blocker and
AGC (``demod/ssb.py``).  Matmuls run in full precision: on CUDA the pipeline
asserts that ``torch.backends.cuda.matmul.allow_tf32`` is False.

With input-dependent coefficients (:func:`first_order_scan`) the JAX package
uses ``lax.associative_scan`` over :func:`first_order_combine`; torch has
none, so the port runs the Hillis-Steele doubling scan over the same
combine: ``ceil(log2 N)`` rounds of whole-tensor ops, never a loop over
samples.  A closed form's powers would leave float32's range over a chunk
(0.999**161_250), so float32 keeps the doubling scan; the float64 AGC, whose
coefficients take two values, has the closed form of :func:`_agc_gain_f64`.
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
def _scan_matrices(a: float, blk: int, nb: int, device: str, dtype: torch.dtype = torch.float32):
    """Cached device constants: in-block triangle, in-block powers, and the
    cross-block fold triangle with its ``y0`` powers."""
    i = np.arange(blk)
    delta = i[:, None] - i[None, :]
    tri = np.where(delta >= 0, float(a) ** np.maximum(delta, 0), 0.0)
    powers = float(a) ** (i + 1)
    a_blk = float(a) ** blk
    if dtype == torch.float32:
        a_blk = float(np.float32(a_blk))
    j = np.arange(nb)
    dj = j[:, None] - j[None, :]
    with np.errstate(under="ignore"):
        fold = np.where(dj >= 0, a_blk ** np.maximum(dj, 0), 0.0)
        fold_y0 = a_blk ** (j + 1)
    ndt = np.float32 if dtype == torch.float32 else np.float64
    as_t = functools.partial(torch.tensor, dtype=dtype, device=device)
    return (
        as_t(tri.T.astype(ndt)),
        as_t(powers.astype(ndt)),
        as_t(fold.T.astype(ndt)),
        as_t(fold_y0.astype(ndt)),
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
    tri_t, powers, fold_t, fold_y0 = _scan_matrices(float(a), blk, nb, str(b.device), b.dtype)
    pref = blocks @ tri_t  # (..., nb, blk): the y0-independent part
    y0 = y0.to(b.dtype)
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
    y0 = torch.as_tensor(y0, device=b.device).to(b.dtype)
    y = cum_a * y0[..., None] + cum_b
    return y, y[..., -1]


def dc_blocker(x: torch.Tensor, radius: float, x_prev, y_prev):
    """One-pole DC blocker ``y[n] = x[n] - x[n-1] + r*y[n-1]``.

    Returns ``(y, (x_last, y_last))``.
    """
    x_prev = torch.as_tensor(x_prev, device=x.device).to(x.dtype)
    y_prev = torch.as_tensor(y_prev, device=x.device).to(x.dtype)
    shifted = torch.cat([x_prev[..., None], x[..., :-1]], dim=-1)
    y, y_last = first_order_scan_const(float(radius), x - shifted, y_prev)
    return y, (x[..., -1], y_last)


def agc_coefficients(x: torch.Tensor, target: float, decay: float, eps: float = 1e-6):
    """``(a, b)`` of the feedback-AGC recurrence (see :func:`feedback_agc`),
    in float32 rounded as the JAX package rounds them: samples with
    ``|x| <= eps`` hold the gain (``a = 1``, ``b = 0``)."""
    mag = x.abs()
    ft = np.float32 if x.dtype == torch.float32 else np.float64
    eps_t = float(ft(eps))
    valid = mag > eps_t
    keep = float(ft(1.0) - ft(decay))
    # a fill, not a copy from the host: the call stays capturable in a CUDA graph
    pull = mag.new_full((), float(ft(decay) * ft(target)))
    a = torch.where(valid, mag.new_full((), keep), mag.new_full((), 1.0))
    b = torch.where(valid, pull / torch.clamp(mag, min=eps_t), mag.new_zeros(()))
    return a, b


#: longest block of the float64 AGC gain (:func:`_agc_gain_f64`)
_AGC_BLOCK = 4096


def _agc_gain_f64(x: torch.Tensor, target: float, decay: float, gain0, eps: float):
    """The feedback AGC's gain in float64 in closed form, ~30 launches where
    the doubling scan takes ~100.

    Every coefficient ``a`` is ``keep = 1 - decay`` or 1, so the product of
    the coefficients up to ``n`` is ``keep**c[n]``, ``c`` the running count of
    samples with ``|x| > eps``.  Per block of ``blk`` samples
    ``g[n] = keep**c[n] * (g_in + sum_{k<=n} b[k] * keep**-c[k])`` with ``c``
    counted from the block's start; ``blk`` keeps ``keep**-blk`` below
    ``e**300``.  The gains entering the blocks are the same recurrence at
    block rate, one lower-triangular matmul of ``keep**(T[j] - T[i])`` (``T``
    the counts to each block's end; every power at most 1), ``(nb, nb)`` for
    ``nb`` blocks: 40 for a chunk of 161,250 samples.  Returns
    ``(g, g_last)``, or None where ``keep`` is too small for a block of 64.
    """
    log_keep = math.log1p(-float(decay)) if decay < 1.0 else -math.inf
    if not log_keep > -300.0 / 64:
        return None
    n = x.shape[-1]
    blk = _AGC_BLOCK if log_keep == 0.0 else 1 << int(math.log2(-300.0 / log_keep))
    blk = min(blk, _AGC_BLOCK, n)
    nb = -(-n // blk)
    batch = x.shape[:-1]
    # padded samples are below eps: they hold the gain
    mag = torch.nn.functional.pad(x.abs(), (0, nb * blk - n)).reshape(*batch, nb, blk)
    valid = mag > eps
    b = torch.where(valid, (float(decay) * float(target)) / mag.clamp_min(eps), 0.0)
    c = valid.to(x.dtype).cumsum(-1)
    prod = torch.exp(c * log_keep)  # keep**c, in (0, 1]
    q = torch.cumsum(b / prod, -1)
    # block rate: h[j] = prod[j, -1] * (h[j-1] + q[j, -1]), h[-1] = g0
    ends = c[..., -1].cumsum(-1)  # T
    drive = prod[..., -1] * q[..., -1]
    w = torch.exp((ends[..., :, None] - ends[..., None, :]).clamp_min(0.0) * log_keep).tril_()
    g0 = torch.as_tensor(gain0, device=x.device).to(x.dtype).expand(batch)
    h = (w @ drive[..., None])[..., 0] + torch.exp(ends * log_keep) * g0[..., None]
    g_in = torch.cat([g0[..., None], h[..., :-1]], dim=-1)
    g = (prod * (g_in[..., None] + q)).reshape(*batch, nb * blk)[..., :n]
    return g, h[..., -1]


def feedback_agc(x: torch.Tensor, target: float, decay: float, gain0, eps: float = 1e-6):
    """Feedback AGC ``g += decay * (target/|x| - g)`` applied as ``x * g``:
    the gain update comes before the sample is scaled, and samples with
    ``|x| <= eps`` leave it untouched.  The gain is carried across chunks.
    Float64 takes the closed form of :func:`_agc_gain_f64`; float32, rounded
    as the JAX package rounds, the doubling scan (the closed form's powers
    leave float32's range within a chunk).  Returns ``(y, gain_last)``."""
    if x.dtype == torch.float64:
        out = _agc_gain_f64(x, target, decay, gain0, eps)
        if out is not None:
            g, g_last = out
            return x * g, g_last
    a, b = agc_coefficients(x, target, decay, eps)
    g, g_last = first_order_scan(a, b, gain0)
    return x * g, g_last
