"""Seeded warm-up blocks for the mixer-sign probe's tests, on the CPU
(``test_torch_mix_probe.py``) and on the card (``test_torch_cuda.py``).

Imports neither JAX nor ``conftest``, so that the card's tests, which run
with ``--noconftest``, can import it.
"""

from __future__ import annotations

import functools

import numpy as np

from iq_to_audio_torch.io.reader import convert_to_complex
from iq_to_audio_torch.pipeline.filters import design_channel_filter

FS = 2_500_000.0
DECIMATION = 26
#: the target's offset from the centre; a carrier sits at +OFFSET, -OFFSET or nowhere
OFFSET = 175_000.0
#: channel bandwidths of the benchmark's deployments: 1,601 and 7,143 taps at D = 26
BANDWIDTHS = {"nfm": 12_500.0, "usb": 2_800.0}
CODECS = ("pcm_s16le", "pcm_u8", "pcm_f32le")
#: the probe reads the first 131,072 samples; a block holds a few more
SAMPLES = 140_000
#: the airband deployment: 20 MS/s, 12.5 kHz channels, 12,801 taps at D = 208;
#: the probe reads the first 1,000,000 samples (0.05 s)
WIDE_FS = 20_000_000.0
WIDE_DECIMATION = 208
WIDE_OFFSET = 350_000.0
WIDE_SAMPLES = 1_040_000


@functools.cache
def taps(mode: str) -> np.ndarray:
    return design_channel_filter(FS, BANDWIDTHS[mode], DECIMATION)


@functools.cache
def wide_taps() -> np.ndarray:
    return design_channel_filter(WIDE_FS, BANDWIDTHS["nfm"], WIDE_DECIMATION)


def raw_block(
    codec: str, carrier: int, seed: int, samples: int = SAMPLES, fs: float = FS,
    offset: float = OFFSET,
) -> np.ndarray:
    """An interleaved raw block in ``codec``: noise 26 dB under full scale,
    plus an FM carrier at ``carrier * offset`` Hz unless ``carrier`` is 0."""
    rng = np.random.default_rng([seed, samples])
    iq = 0.05 * (rng.standard_normal(samples) + 1j * rng.standard_normal(samples))
    if carrier:
        n = np.arange(samples)
        audio = np.cumsum(rng.uniform(-1.0, 1.0, samples)) / 200.0
        phase = 2 * np.pi * carrier * offset * n / fs + 2.0 * np.sin(audio)
        iq += 0.4 * np.exp(1j * phase)
    pair = np.column_stack([iq.real, iq.imag]).reshape(-1)
    if codec == "pcm_s16le":
        return np.round(pair * 32767.0).astype(np.int16)
    if codec == "pcm_u8":
        return np.clip(np.round(pair * 127.0 + 128.0), 0, 255).astype(np.uint8)
    return pair.astype(np.float32)


def warm_block(codec: str, carrier: int, seed: int, samples: int = SAMPLES) -> np.ndarray:
    """The complex64 warm-up block the pipeline hands the probe."""
    return convert_to_complex(raw_block(codec, carrier, seed, samples), codec)


def wide_warm_block(carrier: int, seed: int) -> np.ndarray:
    """A 20 MS/s s16 warm-up block, a carrier at ``carrier * WIDE_OFFSET``."""
    raw = raw_block("pcm_s16le", carrier, seed, WIDE_SAMPLES, WIDE_FS, WIDE_OFFSET)
    return convert_to_complex(raw, "pcm_s16le")
