"""Narrowband FM (upstream ``decoders/nfm.py``): the polar discriminator
``angle(z[n] * conj(z[n-1]))`` with ``z[-1] = 1``, then the single-pole
de-emphasis ``y[n] = (1 - a) x[n] + a y[n-1]``, ``a = exp(-1 / (fs tau))``,
``y[-1] = 0``, evaluated as its impulse response cut where ``a**k`` falls
below ``2**-60``."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import chain


def demod(z: torch.Tensor, fs_ch: float, params: dict, prec: str) -> torch.Tensor:
    prev = torch.cat([torch.ones(1, dtype=z.dtype, device=z.device), z[:-1]])
    disc = torch.angle(z * prev.conj())
    tau = max(float(params["deemph_us"]) * 1e-6, 1e-6)
    alpha = math.exp(-1.0 / (fs_ch * tau))
    n_taps = int(math.ceil(60.0 * math.log(2.0) / -math.log(alpha))) + 1
    h = (1.0 - alpha) * alpha ** np.arange(n_taps, dtype=np.float64)
    return chain.block_fir(disc[None], h, 1, prec, per_frame=256)[0]
