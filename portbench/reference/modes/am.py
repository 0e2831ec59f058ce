"""Amplitude modulation (upstream ``decoders/am.py``, the DC blocker's radius
at lines 28-29): the envelope ``|z[n]|``, then the one-pole DC blocker
``y[n] = x[n] - x[n-1] + 0.995 y[n-1]`` from zero state
(``x[-1] = y[-1] = 0``).  The upstream's AM has no AGC: ``agc_enabled`` is
not read.

Where this departs from the upstream's per-sample loop, and why:

* The DC blocker is the first difference followed by its pole, the pole
  evaluated as its impulse response ``0.995**k`` cut where it falls below
  ``2**-60`` (:func:`chain.block_fir`; ``usb.py``'s blocker, imported), as
  ``nfm.py`` does its de-emphasis: banded matrix products instead of two
  million dependent steps a channel.  The cut moves the result by less than
  ``2**-60`` of the input.
* The envelope is ``torch.abs`` of the complex sample, the hypotenuse
  without overflow, where the upstream squares and adds; in float64 the two
  differ by a rounding.

With ``prec="tf32"`` the same code runs in float32 after the channel
filter's TF32 operands, and the blocker's operands are rounded to TF32: the
check's control.
"""

from __future__ import annotations

import torch

from portbench.reference.modes.usb import DC_RADIUS, dc_block

__all__ = ["DC_RADIUS", "demod"]


def demod(z: torch.Tensor, fs_ch: float, params: dict, prec: str) -> torch.Tensor:
    return dc_block(z.abs(), prec)
