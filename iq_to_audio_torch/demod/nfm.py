"""Narrowband FM: quadrature discriminator + de-emphasis (port of the JAX
package's ``demod/nfm.py``).

Reference semantics: ``decoders/nfm.py`` — polar discriminator
``angle(x[n]*conj(x[n-1]))`` with previous-sample carry, then the
single-pole de-emphasis IIR.
"""

from __future__ import annotations

import math

import torch

from ..ops.iir import deemphasis
from ..ops.trig import atan2_fast
from .base import Decoder


def polar_discriminant(yr, yi, sr, si):
    """``angle(x[n] * conj(x[n-1]))`` in real pairs, with the shifted
    sequence ``(sr, si)`` supplied by the caller.  The angle is the
    polynomial :func:`~iq_to_audio_torch.ops.trig.atan2_fast`, the JAX
    package's formula."""
    pr = yr * sr + yi * si
    pi = yi * sr - yr * si
    return atan2_fast(pi, pr)


class NFMDecoder(Decoder):
    name = "narrowband_fm"

    def __init__(self, deemph_us: float):
        self.deemph_us = deemph_us
        self.alpha: float | None = None

    def setup(self, sample_rate: float) -> None:
        tau_sec = max(self.deemph_us * 1e-6, 1e-6)
        self.alpha = math.exp(-1.0 / (sample_rate * tau_sec))

    def init_state(self, batch_shape, device):
        return {
            "prev_r": torch.ones(batch_shape, dtype=torch.float32, device=device),
            "prev_i": torch.zeros(batch_shape, dtype=torch.float32, device=device),
            "deemph_y": torch.zeros(batch_shape, dtype=torch.float32, device=device),
        }

    def process(self, state, yr, yi):
        if self.alpha is None:
            raise RuntimeError("setup() must run before process()")
        sr = torch.cat([state["prev_r"][..., None], yr[..., :-1]], dim=-1)
        si = torch.cat([state["prev_i"][..., None], yi[..., :-1]], dim=-1)
        demod = polar_discriminant(yr, yi, sr, si)
        audio, y_last = deemphasis(demod, self.alpha, state["deemph_y"])
        new_state = {
            "prev_r": yr[..., -1].clone(),
            "prev_i": yi[..., -1].clone(),
            "deemph_y": y_last.clone(),
        }
        inter = {"demod": demod, "deemph": audio, "audio": audio}
        return audio, new_state, inter
