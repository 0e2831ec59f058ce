"""Upper sideband (upstream ``decoders/ssb.py``, defaults at lines 67-80).

The channel filter has already band-limited the baseband, so the audio of
either sideband is ``real(z)``.  Then the one-pole DC blocker
``y[n] = x[n] - x[n-1] + 0.995 y[n-1]`` from zero state, and, with
``agc_enabled``, the feedback AGC: for each sample with ``|y| > 1e-6`` the
gain moves first, ``g += 0.001 (10**(-12/20) / |y| - g)``, and the sample
is then scaled, ``out = y g``; a sample with ``|y| <= 1e-6`` leaves ``g`` as
it was.  ``g[-1] = 1``.

Where this departs from the upstream's per-sample loop, and why:

* The DC blocker is the first difference followed by its pole, the pole
  evaluated as its impulse response ``0.995**k`` cut where it falls below
  ``2**-60`` (:func:`chain.block_fir`), as ``nfm.py`` does its
  de-emphasis: banded matrix products instead of eight million dependent
  steps.  The cut moves the result by less than ``2**-60`` of the input.
* The AGC is the first-order recurrence ``g[n] = a[n] g[n-1] + b[n]`` with
  ``a = 0.999, b = 0.001 target / |y|`` (``a = 1, b = 0`` where the sample
  holds the gain).  It is evaluated in blocks of :data:`BLOCK` samples by
  its closed form ``g = P (g0 + cumsum(b / P))`` with ``P = cumprod(a)``,
  every block at once, and the blocks' carries ``g0`` chained on the host
  in float64, one scalar per block.  Within a block ``P >= 0.999**BLOCK``
  (1.7e-2), so ``b / P`` neither overflows nor loses more than the float64
  rounding of a sum of ``BLOCK`` terms; the order of those sums is not the
  loop's.

With ``prec="tf32"`` the same code runs in float32 (the blocks' carries
too) after the channel filter's TF32 operands: the check's control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import chain

DC_RADIUS = 0.995
AGC_TARGET = 10.0 ** (-12.0 / 20.0)
AGC_DECAY = 0.001
#: samples whose magnitude is at most this hold the gain
AGC_EPS = 1e-6
#: samples per block of the AGC's closed form
BLOCK = 4096


def dc_block(x: torch.Tensor, prec: str) -> torch.Tensor:
    diff = x - torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), x[:-1]])
    n_taps = int(math.ceil(60.0 * math.log(2.0) / -math.log(DC_RADIUS))) + 1
    h = DC_RADIUS ** np.arange(n_taps, dtype=np.float64)
    return chain.block_fir(diff[None], h, 1, prec, per_frame=256)[0]


def agc_gain(y: torch.Tensor, g0: float = 1.0) -> torch.Tensor:
    """The gain ``g[n]`` each sample of ``y`` is scaled by, in ``y``'s dtype."""
    n = y.numel()
    nb = -(-n // BLOCK)
    mag = torch.zeros(nb * BLOCK, dtype=y.dtype, device=y.device)
    mag[:n] = y.abs()
    mag = mag.reshape(nb, BLOCK)
    valid = mag > AGC_EPS
    a = torch.where(valid, torch.full_like(mag, 1.0 - AGC_DECAY), torch.ones_like(mag))
    b = torch.where(valid, AGC_DECAY * AGC_TARGET / torch.clamp(mag, min=AGC_EPS), 0.0)
    p = torch.cumprod(a, dim=1)
    s = torch.cumsum(b / p, dim=1)
    # g at each block's end, from the carry before it: g = P_end (g0 + S_end)
    p_end = p[:, -1].cpu().numpy()
    s_end = s[:, -1].cpu().numpy()
    carries = np.empty_like(p_end)
    g = p_end.dtype.type(g0)
    for k in range(nb):
        carries[k] = g
        g = p_end[k] * (g + s_end[k])
    c = torch.from_numpy(carries).to(y.device)
    return (p * (c[:, None] + s)).reshape(-1)[:n]


def demod(z: torch.Tensor, fs_ch: float, params: dict, prec: str) -> torch.Tensor:
    y = dc_block(z.real, prec)
    if not params.get("agc_enabled", True):
        return y
    return y * agc_gain(y)
