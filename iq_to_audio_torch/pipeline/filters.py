"""Host-side filter design and decimation math.

Filter design is cheap one-shot float64 host work (the reference also does
it on host via scipy: ``processing.py:599-620``).  The design itself is
first-party NumPy — Kaiser's published beta formula plus the windowed-sinc
construction — so the framework carries no runtime SciPy dependency;
``tests/test_filters.py`` cross-checks the taps against ``scipy.signal``
when SciPy happens to be importable.
"""

from __future__ import annotations

import math

import numpy as np


def kaiser_beta(atten_db: float) -> float:
    """Kaiser's empirical beta for a target stopband attenuation in dB
    (the same piecewise formula scipy.signal.kaiser_beta implements)."""
    a = float(atten_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def firwin_kaiser_lowpass(
    num_taps: int, cutoff: float, beta: float, fs: float
) -> np.ndarray:
    """Windowed-sinc lowpass with a Kaiser window, unity DC gain.

    Equivalent construction to ``scipy.signal.firwin(num_taps, cutoff,
    window=("kaiser", beta), fs=fs)`` for a single passband that includes
    DC: ideal-lowpass sinc at the normalised cutoff, Kaiser window
    (``np.kaiser``), then scaled so the taps sum to 1.
    """
    if num_taps < 1:
        raise ValueError("num_taps must be positive")
    if not 0.0 < cutoff < fs / 2.0:
        raise ValueError("cutoff must lie inside (0, fs/2)")
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    c = 2.0 * cutoff / fs  # cutoff as a fraction of Nyquist
    h = c * np.sinc(c * m)
    h *= np.kaiser(num_taps, beta)
    return h / h.sum()


def design_channel_filter(sample_rate: float, bandwidth: float, decimation: int) -> np.ndarray:
    """Kaiser-window lowpass for the channelizer.

    Same contract as the reference (``processing.py:599-620``): cutoff =
    min(1.05*bw/2, 0.9*fs/(2*decim)), 80 dB ripple, 1024-32768 odd taps sized
    4/transition-width.
    """
    guard = max(1_000.0, bandwidth * 0.5)
    cutoff = min(
        bandwidth * 0.5 * 1.05,
        (sample_rate / (2.0 * max(decimation, 1))) * 0.9,
    )
    if cutoff <= 0:
        raise ValueError("Invalid cutoff frequency for channel filter.")
    width = guard / sample_rate
    num_taps = int(np.clip(4.0 / max(width, 1e-8), 1024, 32768))
    if num_taps % 2 == 0:
        num_taps += 1
    beta = kaiser_beta(80.0)
    taps = firwin_kaiser_lowpass(num_taps, cutoff, beta, sample_rate)
    return np.asarray(taps, dtype=np.float64)


def compute_decimation(sample_rate: float, fs_ch_target: float) -> tuple[int, float]:
    """Decimation factor and resulting channel rate.

    Same rounding rules as the reference (``processing.py:885-890``).
    """
    decimation = max(1, int(round(sample_rate / fs_ch_target)))
    fs_channel = sample_rate / decimation
    if fs_channel > fs_ch_target * 1.5:
        decimation = max(1, int(math.floor(sample_rate / fs_ch_target)))
        fs_channel = sample_rate / decimation
    return decimation, fs_channel


def tune_chunk_size(sample_rate: float, requested: int) -> int:
    """Heuristic target chunk size (reference ``processing.py:65-81``).

    The overlap-save planner then rounds this to a whole number of
    decimation-aligned filter frames.
    """
    base = max(1, requested)
    if sample_rate <= 0:
        return base
    target_seconds = 0.25
    if sample_rate >= 2_000_000.0:
        target_seconds = 0.40
    if sample_rate >= 5_000_000.0:
        target_seconds = 0.50
    desired = int(round(sample_rate * target_seconds))
    if desired <= base:
        return base
    max_chunk = 4_194_304
    desired = min(max_chunk, max(base, desired))
    power = 1 << math.ceil(math.log2(desired))
    return int(min(max(power, base), max_chunk))
