"""The plain reference chain: mix -> channel filter -> decimate -> demod ->
48 kHz polyphase resample -> clip, for one channel of a capture.

The upstream's semantics (``processing.py``, ``decoders/``), computed in
float64 with PyTorch on any device.  Every filter is a product of frames and
a banded tap matrix (:func:`block_fir`), so the same code computed with
``prec="tf32"`` is the check's control: operands rounded to TF32 (10
mantissa bits, as the tensor cores read float32 in TF32 mode), products and
sums in float32.  The demodulator of each mode is found by name in
``modes/<mode>.py``.
"""

from __future__ import annotations

import importlib
import math
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

from . import design

MODES = Path(__file__).resolve().parent / "modes"
#: working dtypes of the two precisions
DTYPES = {"f64": torch.float64, "tf32": torch.float32}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 explicit mantissa bits (nearest,
    ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "tf32":
        return tf32_round(a) @ tf32_round(b)
    return a @ b


def block_fir(x: torch.Tensor, h: np.ndarray, decim: int, prec: str, per_frame: int = 16):
    """``y[..., m] = sum_k h[k] x[..., m*decim - k]`` (zero history), for
    ``m < ceil(N / decim)``.

    Frames of ``F = per_frame * decim`` inputs times the banded matrix
    ``H[d, j*E + e] = h[e*decim + j*F - d]`` give each frame's share of the
    ``E`` outputs of itself and the ``J - 1`` frames after it; the shares
    are summed by shifted adds.
    """
    dt = DTYPES[prec]
    lead = x.shape[:-1]
    n = x.shape[-1]
    m_out = -(-n // decim)
    e_n = per_frame
    f_n = e_n * decim
    t_n = -(-m_out // e_n)
    j_n = (len(h) + f_n - 2) // f_n + 2
    xx = torch.zeros((*lead, t_n * f_n), dtype=dt, device=x.device)
    xx[..., : min(n, t_n * f_n)] = x[..., : t_n * f_n].to(dt)
    frames = xx.reshape(-1, t_n, f_n)
    d = np.arange(f_n)[:, None, None]
    j = np.arange(j_n)[None, :, None]
    e = np.arange(e_n)[None, None, :]
    k = e * decim + j * f_n - d
    band = np.where((k >= 0) & (k < len(h)), np.asarray(h, np.float64)[np.clip(k, 0, len(h) - 1)], 0.0)
    hm = torch.from_numpy(band.reshape(f_n, j_n * e_n)).to(device=x.device, dtype=dt)
    g = matmul(frames, hm, prec).reshape(-1, t_n, j_n, e_n)
    y = g[:, :, 0, :].clone()
    for jj in range(1, min(j_n, t_n)):
        y[:, jj:, :] += g[:, : t_n - jj, jj, :]
    return y.reshape(*lead, t_n * e_n)[..., :m_out]


def oscillator(n_samples: int, freq_offset: float, sample_rate: float, sign: int, device, prec: str):
    """``exp(-1j * sign * 2 pi * f * n / fs)``, with the phase reduced exactly
    (integer arithmetic) where ``f / fs`` is a ratio of small integers."""
    n = torch.arange(n_samples, dtype=torch.int64, device=device)
    ratio = Fraction(float(freq_offset)) / Fraction(float(sample_rate))
    if ratio.denominator <= (1 << 24):
        cycles = torch.remainder(n * ratio.numerator, ratio.denominator).to(torch.float64)
        cycles = cycles / ratio.denominator
    else:
        cycles = n.to(torch.float64) * (float(freq_offset) / float(sample_rate))
    osc = torch.polar(torch.ones_like(cycles), -sign * 2.0 * math.pi * cycles)
    return osc if prec == "f64" else osc.to(torch.complex64)


def resample(x: torch.Tensor, up: int, down: int, prec: str, block: int = 1 << 20):
    """All outputs of the exact polyphase resampler whose base input index
    falls inside ``x``: ``y[n] = sum_j proto[j*up + (n*down) % up] *
    x[(n*down)//up - j]``, zero history."""
    dt = DTYPES[prec]
    k = design.RESAMPLE_TAPS_PER_PHASE
    proto = torch.from_numpy(design.resample_prototype(up, down, k)).to(device=x.device, dtype=dt)
    xs = x.to(dt)
    if prec == "tf32":
        proto, xs = tf32_round(proto), tf32_round(xs)
    total = (x.numel() * up + down - 1) // down
    xpad = torch.cat([torch.zeros(k - 1, dtype=dt, device=x.device), xs])
    jj = torch.arange(k, device=x.device)
    out = torch.empty(total, dtype=dt, device=x.device)
    for lo in range(0, total, block):
        nn = torch.arange(lo, min(total, lo + block), device=x.device, dtype=torch.int64)
        ip = (nn * down) // up
        phi = (nn * down) % up
        src = ip[:, None] - jj[None, :] + (k - 1)
        taps = proto[jj[None, :] * up + phi[:, None]]
        out[lo : lo + nn.numel()] = (taps * xpad[src]).sum(dim=1)
    return out


def load_mode(name: str):
    path = MODES / f"{name}.py"
    if not path.exists():
        raise ValueError(f"the reference has no demodulator for mode {name!r} ({path})")
    return importlib.import_module(f"portbench.reference.modes.{name}")


def channel_audio(
    iq: torch.Tensor, sample_rate: float, freq_offset: float, sign: int, params: dict,
    prec: str = "f64", output_rate: float = 48_000.0,
) -> torch.Tensor:
    """One channel's audio at ``output_rate``, clipped to +-0.99, before the
    s16 encode.  ``iq``: complex samples ``(N,)`` on the device it runs on."""
    decim, fs_ch = design.decimation(sample_rate, params["fs_ch_target"])
    taps = design.channel_taps(sample_rate, params["bandwidth"], decim)
    cdt = torch.complex128 if prec == "f64" else torch.complex64
    z = iq.to(cdt) * oscillator(iq.numel(), freq_offset, sample_rate, sign, iq.device, prec)
    pair = torch.stack([z.real, z.imag])
    del z
    dec = block_fir(pair, taps, decim, prec)
    del pair
    zc = torch.complex(dec[0], dec[1])
    audio = load_mode(params["demod_mode"]).demod(zc, fs_ch, params, prec)
    up, down = design.resample_ratio(fs_ch, output_rate)
    out = audio if up == down else resample(audio, up, down, prec)
    return torch.clamp(out, -0.99, 0.99)


def encode_s16(audio: torch.Tensor) -> torch.Tensor:
    """The s16 code of clipped audio: round half to even of ``x * 32767``."""
    return torch.round(audio.to(torch.float64) * 32767.0)
