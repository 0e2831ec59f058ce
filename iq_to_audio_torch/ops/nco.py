"""Host helpers of the uint32 fixed-point NCO (copy of the JAX package's).

Phase is tracked in fixed point (1 cycle == 2**32 counts) so that
``phase[n] = phase0 + inc * n mod 2**32`` is exact modular arithmetic and
chunked output equals whole-signal output to the last bit of phase.  The
device side (:mod:`.ddc`) carries the same value as a masked int64, because
torch has no usable uint32 arithmetic.

A uint32 increment is the frequency to within ``fs / 2**33`` (0.29 mHz at
2.5 MS/s), which over a 40 s capture turns the channel by up to 0.07 rad:
nothing to the discriminator or the envelope, but SSB takes the real part,
so its audio drifts off the exact mix.  So the device's NCO runs on a
62-bit phase (1 cycle == 2**62 counts): :func:`device_increment` is the
uint32 increment shifted up 30 bits plus :func:`nco_increment_residual`,
the rest of the exact frequency, and the angle comes from the phase's top
32 bits, rounded as the JAX package rounds its uint32 phase.  With a zero
residual (a frequency on the uint32 grid) the top 32 bits are the JAX
package's phase, bit for bit.
"""

from __future__ import annotations

from fractions import Fraction

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


#: fractional bits of the device NCO's phase (:func:`device_increment`)
PHASE_BITS = 62
MASK62 = (1 << PHASE_BITS) - 1
#: bits of the device NCO's phase below the uint32 phase's 32
LOW_BITS = PHASE_BITS - 32


def nco_increment_residual(freq_offset_hz: float, sample_rate: float, sign: int = 1) -> int:
    """What :func:`nco_increment_fixed` leaves out of the exact increment, in
    ``2**-PHASE_BITS`` cycles per sample, signed (``|residual| <= 2**29``):
    ``inc / 2**32 + residual / 2**PHASE_BITS`` cycles is the exact increment
    to ``2**-PHASE_BITS``."""
    inc = nco_increment_fixed(freq_offset_hz, sample_rate, sign)
    cycles = (Fraction(-float(sign) * float(freq_offset_hz)) / Fraction(float(sample_rate))) % 1
    full = 1 << PHASE_BITS
    rest = round(cycles * full) - (inc << LOW_BITS)
    return (rest + full // 2) % full - full // 2


def device_increment(inc_fixed: int, residual: int = 0, steps: int = 1) -> int:
    """The device NCO's increment over ``steps`` input samples (the
    decimation gives it per output sample) in ``2**-PHASE_BITS`` cycles: the
    uint32 increment ``inc_fixed`` with its ``residual``
    (:func:`nco_increment_residual`), in ``[0, 2**PHASE_BITS)``."""
    return (((int(inc_fixed) << LOW_BITS) + int(residual)) * int(steps)) & MASK62


def nco_phase_advance(phase_fixed: int, inc_fixed: int, num_samples: int) -> int:
    """Exact host-side phase advance mirror (Python ints, mod 2**32)."""
    return (int(phase_fixed) + int(inc_fixed) * int(num_samples)) % _TWO32
