"""USB voices keyed on and off over a white noise floor.

Each target is a suppressed-carrier upper sideband: speech-band noise
(white noise masked to the configuration's audio band, positive
frequencies only, so the signal is analytic and its energy lies above the
carrier) at a seeded in-channel SNR, keyed on and off in seeded spans (the
first span on, as an operator answering a call), shifted to its carrier
over one complex white noise floor.  Everything random comes from
``seed``: scalars from NumPy, sample streams from a ``torch.Generator`` on
the device, in a few calls per target.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

#: the modulating audio is made at ``sample_rate / AUDIO_DIV`` and
#: interpolated linearly to the sample rate
AUDIO_DIV = 100


def offsets(cfg: dict) -> list[float]:
    return [float(f) for f in cfg["assumed"]["carrier_offsets_hz"]]


def _key_envelope(rng: np.random.Generator, n_audio: int, fa: float, span_s) -> np.ndarray:
    env = np.zeros(n_audio, np.float32)
    pos, on = 0, True
    while pos < n_audio:
        length = int(rng.uniform(*span_s) * fa)
        if on:
            env[pos : pos + length] = 1.0
        pos += length
        on = not on
    return env


def _voice(gen: torch.Generator, n_audio: int, fa: float, band, device) -> torch.Tensor:
    """Complex analytic speech-band noise of unit RMS at ``fa``: the
    positive-frequency half of masked white noise, doubled."""
    w = torch.randn(n_audio, generator=gen, device=device)
    freqs = torch.fft.fftfreq(n_audio, 1.0 / fa, device=device)
    lo, hi = band
    keep = ((freqs >= lo) & (freqs <= hi)).to(torch.float32)
    m = torch.fft.ifft(torch.fft.fft(w) * (2.0 * keep))
    return m / m.abs().square().mean().sqrt()


def make(cfg: dict, seconds: float, seed: int, device) -> torch.Tensor:
    a = cfg["assumed"]
    fs = float(cfg["sample_rate"])
    n = int(round(seconds * fs))
    fa = fs / AUDIO_DIV
    n_audio = n // AUDIO_DIV + 2
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    noise_rms = float(a["noise_rms"])
    chan_noise_power = noise_rms**2 * float(cfg["pipeline"]["bandwidth"]) / fs
    idx = torch.arange(n, dtype=torch.int64, device=device)
    out = torch.zeros(n, dtype=torch.complex64, device=device)
    for off in offsets(cfg):
        snr = 10.0 ** (rng.uniform(*a["snr_db"]) / 10.0)
        amp = math.sqrt(snr * chan_noise_power)
        phase0 = rng.uniform(0.0, 2.0 * math.pi)
        env = torch.from_numpy(_key_envelope(rng, n_audio, fa, a["key_span_s"])).to(device)
        v = _voice(gen, n_audio, fa, a["audio_band_hz"], device)
        up = torch.nn.functional.interpolate(
            torch.stack([v.real * env, v.imag * env])[None], scale_factor=AUDIO_DIV,
            mode="linear", align_corners=False,
        )[0, :, :n]
        ratio = Fraction(off) / Fraction(fs)
        cycles = torch.remainder(idx * ratio.numerator, ratio.denominator).to(torch.float64)
        theta = 2.0 * math.pi * cycles / ratio.denominator + phase0
        carrier = torch.polar(torch.full_like(theta, amp), theta).to(torch.complex64)
        out += torch.complex(up[0], up[1]) * carrier
        del up, cycles, theta, carrier
    noise = torch.randn(2, n, generator=gen, device=device) * (noise_rms / math.sqrt(2.0))
    out += torch.complex(noise[0], noise[1])
    return out
