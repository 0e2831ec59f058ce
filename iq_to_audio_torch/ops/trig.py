"""Vectorised polynomial ``atan2`` for the quadrature discriminator.

The same polynomial and the same ``where`` guards as the JAX package's
``ops/trig.py::atan2_fast``: the discriminator must follow that formula, not
libm's ``atan2``, so that the two packages agree to float32 rounding.

``atan(r)`` on [0, 1] is a degree-7 fit in ``u = 2 r^2 - 1`` (max error
8.8e-8 rad in float64).  ``atan2(0, 0)`` is 0; ``inf/inf`` and equal
subnormal pairs give ``r = 1`` exactly instead of NaN.
"""

from __future__ import annotations

import numpy as np
import torch

_ATAN_COEFFS = tuple(
    float(np.float32(c))
    for c in (
        0.8704196595587864,
        -0.10187631419586549,
        0.020854675551507187,
        -0.005033370703719968,
        0.0013020613817807888,
        -0.0003535131235162185,
        0.00012262017710359455,
        -3.774350302638771e-05,
    )
)

_HALF_PI = float(np.float32(np.pi / 2))
_PI = float(np.float32(np.pi))


def atan2_fast(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Polynomial ``atan2(y, x)`` in float32; max error ~1e-7 rad."""
    y = y.to(torch.float32)
    x = x.to(torch.float32)
    ax = x.abs()
    ay = y.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    r = torch.where(
        lo == hi,
        torch.where(hi == 0.0, zero, one),
        lo / torch.where(hi == 0.0, one, hi),
    )
    u = 2.0 * r * r - 1.0
    p = torch.full_like(u, _ATAN_COEFFS[-1])
    for c in _ATAN_COEFFS[-2::-1]:
        p = p * u + c
    a = p * r  # atan(min/max) in [0, pi/4]
    a = torch.where(ay > ax, _HALF_PI - a, a)
    a = torch.where(x < 0.0, _PI - a, a)
    return torch.where(y < 0.0, -a, a)
