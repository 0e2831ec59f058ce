"""Two-channel PCM_16 WAV (I left, Q right), as SDR++ and SDR# record
baseband, written and read with the standard library's ``wave``."""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np
import torch

FULL_SCALE = 32767.0


def write(path: Path, iq: torch.Tensor, sample_rate: float) -> int:
    """Quantise complex ``iq`` (full scale 1.0) to s16 pairs and write them;
    returns the bytes written."""
    pairs = torch.stack([iq.real, iq.imag], dim=1)
    s16 = torch.clamp(torch.round(pairs * FULL_SCALE), -32768, 32767).to(torch.int16)
    raw = s16.cpu().numpy().tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(raw)
    return len(raw)


def read(path: Path, n: int | None = None, device="cpu") -> torch.Tensor:
    """The first ``n`` complex samples (all of them by default) as complex128
    on ``device``, scaled by 1/32768."""
    with wave.open(str(path), "rb") as w:
        frames = w.getnframes() if n is None else min(n, w.getnframes())
        raw = np.frombuffer(w.readframes(frames), dtype="<i2").reshape(-1, 2)
    pairs = torch.from_numpy(raw.copy()).to(device).to(torch.float64) / 32768.0
    return torch.complex(pairs[:, 0], pairs[:, 1])
