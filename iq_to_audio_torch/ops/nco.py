"""Host helpers of the uint32 fixed-point NCO (copy of the JAX package's).

Phase is tracked in fixed point (1 cycle == 2**32 counts) so that
``phase[n] = phase0 + inc * n mod 2**32`` is exact modular arithmetic and
chunked output equals whole-signal output to the last bit of phase.  The
device side (:mod:`.ddc`) carries the same value as a masked int64, because
torch has no usable uint32 arithmetic.
"""

from __future__ import annotations

import numpy as np

_TWO32 = 1 << 32
_RAD_PER_COUNT = float(2.0 * np.pi / _TWO32)


def nco_increment_fixed(freq_offset_hz: float, sample_rate: float, sign: int = 1) -> int:
    """uint32 fixed-point phase increment for mixing ``freq_offset_hz`` down.

    Matches the reference convention ``increment = -2*pi*f_off/fs`` with the
    probe ``sign`` multiplier (reference ``processing.py:287-289``): positive
    ``sign`` translates the target down to DC.
    """
    cycles_per_sample = (-float(sign) * float(freq_offset_hz) / float(sample_rate)) % 1.0
    inc = int(round(cycles_per_sample * _TWO32)) % _TWO32
    return inc


def nco_phase_advance(phase_fixed: int, inc_fixed: int, num_samples: int) -> int:
    """Exact host-side phase advance mirror (Python ints, mod 2**32)."""
    return (int(phase_fixed) + int(inc_fixed) * int(num_samples)) % _TWO32
