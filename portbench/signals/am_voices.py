"""Full-carrier AM voices keyed on and off over a white noise floor.

Each target is a double-sideband full-carrier AM transmission, as airband
radios send: the envelope ``A * max(0, 1 + depth * s(t))`` of real
speech-band noise ``s`` (white noise masked to the configuration's audio
band, unit RMS) on a carrier at the target's offset.  Carrier and audio are
keyed together in seeded spans (the first span on, as push-to-talk), at a
seeded carrier power over one complex white noise floor.  Everything random
comes from ``seed``: scalars from NumPy, sample streams from a
``torch.Generator`` on the device, in a few calls per target.

The carriers are mixed in blocks of :data:`BLOCK` samples, so that the
device holds the capture, one carrier's envelope and one block's phases at
a time: some 6 GB for 20 s at 20 MS/s.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

#: the modulating audio is made at ``sample_rate / AUDIO_DIV`` and
#: interpolated linearly to the sample rate
AUDIO_DIV = 100
#: samples per block of the carriers' mix
BLOCK = 1 << 25


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
    """Real speech-band noise of unit RMS at ``fa``."""
    w = torch.randn(n_audio, generator=gen, device=device)
    freqs = torch.fft.rfftfreq(n_audio, 1.0 / fa, device=device)
    lo, hi = band
    keep = ((freqs >= lo) & (freqs <= hi)).to(torch.float32)
    s = torch.fft.irfft(torch.fft.rfft(w) * keep, n=n_audio)
    return s / s.square().mean().sqrt()


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
    depth = float(a["modulation_depth"])
    out = torch.zeros(n, dtype=torch.complex64, device=device)
    for off in offsets(cfg):
        snr = 10.0 ** (rng.uniform(*a["snr_db"]) / 10.0)
        amp = math.sqrt(snr * chan_noise_power)
        phase0 = rng.uniform(0.0, 2.0 * math.pi)
        env = torch.from_numpy(_key_envelope(rng, n_audio, fa, a["key_span_s"])).to(device)
        s = _voice(gen, n_audio, fa, a["audio_band_hz"], device)
        mag = amp * env * torch.clamp(1.0 + depth * s, min=0.0)
        up = torch.nn.functional.interpolate(
            mag[None, None], scale_factor=AUDIO_DIV, mode="linear", align_corners=False,
        )[0, 0, :n]
        del env, s, mag
        ratio = Fraction(off) / Fraction(fs)
        for lo in range(0, n, BLOCK):
            idx = torch.arange(lo, min(n, lo + BLOCK), dtype=torch.int64, device=device)
            cycles = torch.remainder(idx * ratio.numerator, ratio.denominator).to(torch.float64)
            theta = (2.0 * math.pi / ratio.denominator) * cycles + phase0
            out[lo : lo + idx.numel()] += torch.polar(
                up[lo : lo + idx.numel()], theta.to(torch.float32)
            )
            del idx, cycles, theta
        del up
    noise = torch.randn(2, n, generator=gen, device=device) * (noise_rms / math.sqrt(2.0))
    out += torch.complex(noise[0], noise[1])
    return out
