"""Spectral analysis: one-shot PSD and a bounded-memory waterfall.

Numerically matches the reference implementation (reference
``spectrum.py``): Hann window, ``10*log10(|X|^2 / (N*fs*win_power))``
scaling, fftshifted bins, hop = nfft/4 sliding windows with a carried
tail between blocks, and pairwise time-averaging so the waterfall never
holds more than ``max_slices`` rows.

FFTs go through a pluggable backend (port of the JAX package's
``analysis/spectrum.py``).  The default, ``backend="torch"``, batches every
window of a block into one ``torch.fft.fft`` call on ``device``;
``backend="matmul"`` computes each block's window batch as four real
float32 ``torch.matmul``s on ``device`` against a cached cos/sin DFT basis
(nfft at most 4096; a larger transform is refused).  ``device=None`` means
the card, as everywhere in the port: without one only an explicit
``"cpu"`` runs.  ``backend="numpy"`` is the explicit request for the host's
pocketfft in float64; it ignores ``device``.  ``backend="jax"`` is the JAX
package's name for the device FFT and is refused with a pointer to
``"torch"``.
"""

from __future__ import annotations

import logging
from collections.abc import Iterable, Iterator
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device

LOG = logging.getLogger(__name__)

_EPS = 1e-18


@dataclass
class WaterfallResult:
    freqs: np.ndarray
    times: np.ndarray
    matrix: np.ndarray


# matmul-DFT basis cache and the largest transform it is allowed to build
# (an nfft x nfft f32 cos/sin pair; 4096 -> 2 x 64 MB is the sane ceiling)
_DFT_BASIS_MAX = 4096
_dft_cache: dict[tuple[int, str], tuple] = {}

_BACKENDS = ("numpy", "torch", "matmul")


def _dft_basis(nfft: int, device: torch.device):
    """(cos, sin) of the symmetric DFT matrix W[n,k] = exp(-2πi·nk/N),
    cached as device tensors so streaming callers upload the basis once per
    nfft, not once per block."""
    key = (nfft, str(device))
    hit = _dft_cache.get(key)
    if hit is None:
        k = np.arange(nfft, dtype=np.float64)
        # reduce n·k mod N before scaling so the trig arguments stay small
        ang = (-2.0 * np.pi / nfft) * (np.outer(k, k) % nfft)
        hit = (
            torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device),
        )
        _dft_cache[key] = hit
    return hit


def _dft_matmul(x: np.ndarray, nfft: int, device: torch.device) -> np.ndarray:
    """DFT along the last axis as four real float32 matmuls on ``device``,
    in full float32: TF32 is switched off around the products."""
    cos_b, sin_b = _dft_basis(nfft, device)
    xr = torch.from_numpy(np.ascontiguousarray(np.real(x), dtype=np.float32)).to(device)
    xi = torch.from_numpy(np.ascontiguousarray(np.imag(x), dtype=np.float32)).to(device)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (xr + j·xi) @ (c + j·s), expanded into real arithmetic
        re = torch.matmul(xr, cos_b) - torch.matmul(xi, sin_b)
        im = torch.matmul(xr, sin_b) + torch.matmul(xi, cos_b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    return re.cpu().numpy().astype(np.float64) + 1j * im.cpu().numpy().astype(np.float64)


def _run_fft(x: np.ndarray, nfft: int, backend: str, device=None) -> np.ndarray:
    """FFT along the last axis, zero-padding to nfft when needed."""
    if backend == "jax":
        raise ValueError(
            'backend="jax" belongs to the JAX package; the device FFT of this '
            'package is backend="torch"'
        )
    if backend not in _BACKENDS:
        raise ValueError(f"Unknown FFT backend '{backend}' (one of {_BACKENDS})")
    if backend in ("torch", "matmul"):
        short = nfft - x.shape[-1]
        if short > 0:
            x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, short)])
        if backend == "matmul":
            if nfft > _DFT_BASIS_MAX:
                raise ValueError(
                    f'backend="matmul" builds an nfft x nfft basis and stops at '
                    f'nfft={_DFT_BASIS_MAX} (got {nfft}); use backend="torch"'
                )
            return _dft_matmul(x, nfft, resolve_device(device))
        xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.complex64))
        return torch.fft.fft(xt.to(resolve_device(device)), dim=-1).cpu().numpy()
    return np.fft.fft(x, n=nfft)


def _hann_scale(length: int, sample_rate: float) -> tuple[np.ndarray, float]:
    """Hann window of ``length`` and the matching PSD denominator."""
    window = np.hanning(length).astype(np.float64)
    win_power = np.sum(window**2) / length
    return window, length * sample_rate * win_power + _EPS


def _psd_db(spectra: np.ndarray, scale: float) -> np.ndarray:
    shifted = np.fft.fftshift(np.asarray(spectra), axes=-1)
    # |X|^2 as real^2 + imag^2: no complex product / magnitude temporaries
    # on the streaming-waterfall hot path
    power = (np.square(shifted.real) + np.square(shifted.imag)) / scale
    return 10.0 * np.log10(power + _EPS)


def _bin_freqs(nfft: int, sample_rate: float) -> np.ndarray:
    return np.fft.fftshift(np.fft.fftfreq(nfft, d=1.0 / sample_rate)).astype(np.float64)


def compute_psd(
    samples: np.ndarray,
    sample_rate: float,
    nfft: int = 1 << 18,
    *,
    fft_workers: int | None = None,  # accepted for parity; unused
    backend: str = "torch",
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """One-shot PSD (dBFS/Hz) of up to ``nfft`` complex samples."""
    if samples.size == 0:
        raise ValueError("Cannot compute PSD for an empty signal.")
    use = samples[:nfft] if samples.size > nfft else samples
    window, scale = _hann_scale(use.size, sample_rate)
    spectra = _run_fft(np.asarray(use, dtype=np.complex128) * window, nfft, backend, device)
    return _bin_freqs(nfft, sample_rate), _psd_db(spectra, scale).astype(np.float64)


def streaming_waterfall(
    chunks: Iterable[np.ndarray | None],
    sample_rate: float,
    *,
    nfft: int,
    hop: int | None = None,
    max_slices: int = 400,
    fft_workers: int | None = None,  # parity; unused
    backend: str = "torch",
    device=None,
) -> tuple[np.ndarray, np.ndarray, WaterfallResult, int]:
    """Averaged PSD plus capped waterfall over a stream of sample blocks.

    Returns ``(freqs, avg_psd_db, WaterfallResult, frames)``; raises if the
    stream is shorter than one FFT frame.
    """
    hop = max(1, hop or nfft // 4)
    window, scale = _hann_scale(nfft, sample_rate)
    freqs = _bin_freqs(nfft, sample_rate)
    store = _SliceStore(max_slices)
    running: np.ndarray | None = None
    frames = 0

    # all windows starting inside one block form a single (num, nfft) FFT
    # batch — with backend="torch" that is one device call per block
    for start, batch in _windowed_blocks(chunks, nfft=nfft, hop=hop):
        rows = _psd_db(_run_fft(batch.astype(np.complex128) * window, nfft, backend, device), scale)
        for k, row in enumerate(rows):
            running = row.astype(np.float64, copy=True) if running is None else running + row
            store.push(row, (start + k * hop) / sample_rate)
            frames += 1
        if frames and frames % 200 == 0:
            LOG.debug("Accumulated %d FFT frames for waterfall preview.", frames)

    if frames == 0 or running is None:
        raise ValueError("Input did not contain enough samples for one FFT frame.")

    times, matrix = store.collect()
    result = WaterfallResult(freqs=freqs.copy(), times=times, matrix=matrix)
    return freqs.copy(), (running / frames).astype(np.float64), result, frames


def _windowed_blocks(
    chunks: Iterable[np.ndarray | None],
    *,
    nfft: int,
    hop: int,
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield ``(start_sample, (num_windows, nfft))`` arrays, carrying the
    unconsumed tail of each block into the next so no window is lost at
    block boundaries."""
    # invariant: ``cursor`` is the GLOBAL sample index of block[0] (and of
    # carry[0] between iterations) — each yielded window w therefore starts
    # at cursor + w*hop, which is what the waterfall time axis stamps
    carry = np.empty(0, dtype=np.complex64)
    cursor = 0
    for chunk in chunks:
        if chunk is None:
            continue
        block = np.asarray(chunk, dtype=np.complex64)
        if block.size == 0:
            continue
        if carry.size:
            block = np.concatenate((carry, block))
        if block.size < nfft:
            carry = block  # still starts at cursor
            continue
        num = (block.size - nfft) // hop + 1
        gather = np.arange(num)[:, None] * hop + np.arange(nfft)[None, :]
        yield cursor, block[gather]
        consumed = num * hop
        carry = block[consumed:]  # keeps the (nfft - hop)-sample overlap
        cursor += consumed


class _SliceStore:
    """Waterfall rows with bounded memory: once the row count passes the
    cap, adjacent pairs are averaged in time (halving the count), exactly
    like the reference aggregator (reference ``spectrum.py:172-208``)."""

    def __init__(self, max_slices: int):
        self._cap = max(1, int(max_slices))
        self._rows: list[np.ndarray] = []
        self._stamps: list[float] = []

    def push(self, psd_row: np.ndarray, t: float) -> None:
        self._rows.append(np.asarray(psd_row, dtype=np.float32))
        self._stamps.append(float(t))
        while len(self._rows) > self._cap:
            self._halve()

    def _halve(self) -> None:
        rows, stamps = self._rows, self._stamps
        kept_rows: list[np.ndarray] = []
        kept_stamps: list[float] = []
        for i in range(0, len(rows), 2):
            if i + 1 < len(rows):
                merged = (rows[i].astype(np.float64) + rows[i + 1].astype(np.float64)) / 2.0
                kept_rows.append(merged.astype(np.float32))
            else:
                kept_rows.append(rows[i])
            kept_stamps.append(stamps[i])
        self._rows, self._stamps = kept_rows, kept_stamps

    def collect(self) -> tuple[np.ndarray, np.ndarray]:
        if not self._rows:
            return np.empty(0, dtype=np.float32), np.empty((0, 0), dtype=np.float32)
        return (
            np.asarray(self._stamps, dtype=np.float32),
            np.stack(self._rows, axis=0).astype(np.float32, copy=False),
        )
