"""Host-side float64 design rules of the plain reference.

A frozen copy of the upstream's arithmetic (``processing.py:599-620`` for the
channel filter, ``processing.py:885-890`` for the decimation,
``processing.py:623-663`` for the mixer-sign probe) and of the exact
polyphase resampler's prototype, written out again here so that the
reference takes nothing from the program under test.  Plain NumPy.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

#: taps per phase of the 48 kHz polyphase resampler
RESAMPLE_TAPS_PER_PHASE = 32
#: the resampler's kernel budget (bytes of the ``up x (down+K-1)`` matrix)
_RESAMPLE_KERNEL_BYTES = 16 << 20
_RESAMPLE_FALLBACK_DENS = (8192, 4096, 2048, 1024, 512, 128, 32, 8, 2, 1)


def kaiser_beta(atten_db: float) -> float:
    a = float(atten_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a > 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def channel_taps(sample_rate: float, bandwidth: float, decimation: int) -> np.ndarray:
    """Kaiser lowpass: cutoff min(1.05 bw/2, 0.9 fs/(2D)), 80 dB, odd length
    4 / transition width, within 1024..32768; unity DC gain."""
    guard = max(1_000.0, bandwidth * 0.5)
    cutoff = min(bandwidth * 0.5 * 1.05, (sample_rate / (2.0 * max(decimation, 1))) * 0.9)
    width = guard / sample_rate
    num_taps = int(np.clip(4.0 / max(width, 1e-8), 1024, 32768))
    if num_taps % 2 == 0:
        num_taps += 1
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    c = 2.0 * cutoff / sample_rate
    h = c * np.sinc(c * m) * np.kaiser(num_taps, kaiser_beta(80.0))
    return h / h.sum()


def decimation(sample_rate: float, fs_ch_target: float) -> tuple[int, float]:
    d = max(1, int(round(sample_rate / fs_ch_target)))
    fs_ch = sample_rate / d
    if fs_ch > fs_ch_target * 1.5:
        d = max(1, int(math.floor(sample_rate / fs_ch_target)))
        fs_ch = sample_rate / d
    return d, fs_ch


def resample_ratio(input_rate: float, output_rate: float) -> tuple[int, int]:
    """``(up, down)``: the exact reduced ratio where its kernel fits the
    budget, else the best approximation that fits."""
    exact = Fraction(float(output_rate)).limit_denominator(1 << 20) / Fraction(
        float(input_rate)
    ).limit_denominator(1 << 20)

    def kernel_bytes(f: Fraction) -> int:
        return f.numerator * (f.denominator + RESAMPLE_TAPS_PER_PHASE - 1) * 4

    frac = exact
    if kernel_bytes(exact) > _RESAMPLE_KERNEL_BYTES:
        for cap in _RESAMPLE_FALLBACK_DENS:
            frac = exact.limit_denominator(cap)
            if frac.numerator > 0 and kernel_bytes(frac) <= _RESAMPLE_KERNEL_BYTES:
                break
    return frac.numerator, frac.denominator


def resample_prototype(up: int, down: int, k: int = RESAMPLE_TAPS_PER_PHASE) -> np.ndarray:
    """``k*up``-tap Kaiser windowed sinc (rolloff 0.9125, beta 9.5), each
    phase normalised to unity DC gain."""
    n = np.arange(k * up, dtype=np.float64)
    center = (k * up - 1) / 2.0
    cutoff = 0.9125 * min(1.0, up / down)
    proto = cutoff * np.sinc(cutoff * (n - center) / up) * np.kaiser(k * up, 9.5)
    for p in range(up):
        idx = p + up * np.arange(k)
        s = proto[idx].sum()
        if abs(s) > 1e-12:
            proto[idx] /= s
    return proto


def _overlap_save(x: np.ndarray, taps: np.ndarray, block: int) -> np.ndarray:
    """Causal FIR of ``x`` (zero history) by overlap-save in float64."""
    taps = np.asarray(taps, np.complex128)
    overlap = taps.size - 1
    nfft = 1 << math.ceil(math.log2(block + overlap))
    hf = np.fft.fft(np.concatenate([taps, np.zeros(nfft - taps.size)]))
    state = np.zeros(overlap, np.complex128)
    out = []
    for start in range(0, x.size, block):
        seg = x[start : start + block]
        buf = np.concatenate([state, seg])
        buf = np.pad(buf, (0, nfft - buf.size))
        out.append(np.fft.ifft(np.fft.fft(buf) * hf)[overlap : overlap + seg.size])
        state = (
            seg[-overlap:].copy() if seg.size >= overlap
            else np.concatenate([state[seg.size :], seg])
        )
    return np.concatenate(out)


def mix_sign(
    head: np.ndarray, sample_rate: float, freq_offset: float, taps: np.ndarray, decim: int
) -> int:
    """The warm-up mixer-sign probe: the sign whose mix puts more power in
    the channel over the capture's first ``max(0.05 s, 4 L, 131072)``
    samples (``head``: complex, at least that long where the capture is)."""
    probe_len = min(head.size, max(int(sample_rate * 0.05), len(taps) * 4, 131_072))
    snippet = np.asarray(head[:probe_len], np.complex128)
    if snippet.size < len(taps):
        snippet = np.asarray(head[: min(head.size, len(taps) * 2)], np.complex128)
    if snippet.size == 0:
        return 1
    n = np.arange(snippet.size, dtype=np.float64)
    block = min(snippet.size, max(len(taps), 16_384))
    best_sign, best_power = 1, -np.inf
    for sign in (1, -1):
        osc = np.exp(-1j * sign * 2.0 * np.pi * freq_offset * n / sample_rate)
        dec = _overlap_save(snippet * osc, taps, block)[:: max(decim, 1)]
        if dec.size == 0:
            power = -np.inf
        else:
            useful = dec[min(len(taps), dec.size // 4) :]
            power = float(np.mean(np.abs(useful if useful.size else dec) ** 2))
        if power > best_power:
            best_power, best_sign = power, sign
    return best_sign
