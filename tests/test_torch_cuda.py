"""Tests of the port that need a CUDA card: the hand-written kernel has no
CPU mode.  Each skips without a card.

This file imports neither JAX nor the shared ``conftest`` helpers, so that
it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from iq_to_audio_torch import ProcessingConfig, ProcessingPipeline
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.ops import poly_fir as tpoly
from iq_to_audio_torch.ops.ddc import bandpass_kernel, interleave_kernel
from iq_to_audio_torch.ops.nco import nco_increment_fixed
from iq_to_audio_torch.pipeline.filters import design_channel_filter

pytestmark = pytest.mark.cuda

FS = 2_500_000.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _err_db(test, ref) -> float:
    test = np.asarray(test, np.float64)
    ref = np.asarray(ref, np.float64)
    return 20.0 * math.log10(np.linalg.norm(test - ref) / (np.linalg.norm(ref) + 1e-30) + 1e-30)


def _inputs(bandwidth, offsets, out_size, decim=26, seed=0):
    taps = design_channel_filter(FS, bandwidth, decim)
    incs = [nco_increment_fixed(o, FS) for o in offsets]
    poly = tpoly.build_poly_kernel(interleave_kernel(bandpass_kernel(taps, incs), "iq"), 2 * decim)
    n = 2 * (len(taps) - 1) + 2 * out_size * decim
    x = np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(poly), decim


@pytest.mark.parametrize(
    "bandwidth,offsets,out_size",
    [
        (12_500.0, (25_000.0,), 161_250),  # flagship chunk, one channel
        (12_500.0, (25_000.0, -40_000.0), 5_000),  # two channels
        (12_500.0, (25_000.0,) * 5, 1_000),  # five channels
        (2_000.0, (25_000.0,), 3_001),  # K = 385: the tap-block loop runs
        (12_500.0, (25_000.0,), 1),  # a single output row
    ],
)
def test_kernel_matches_plain(bandwidth, offsets, out_size):
    dev = _card()
    x, w, decim = _inputs(bandwidth, offsets, out_size)
    x, w = x.to(dev), w.to(dev)
    before = tpoly.poly_fir_il.launches
    got = tpoly.poly_fir_il(x, w, decim, out_size)
    torch.cuda.synchronize()
    assert tpoly.poly_fir_il.launches == before + 1
    want = tpoly.poly_fir_il_plain(x, w, decim, out_size)
    assert got.shape == (2 * len(offsets), out_size)
    assert _err_db(got.cpu(), want.cpu()) < -100.0


@pytest.mark.parametrize("k_block", [1, 7, 16])
def test_kernel_forced_tap_blocks(k_block):
    dev = _card()
    x, w, decim = _inputs(12_500.0, (25_000.0,), 2_000)
    x, w = x.to(dev), w.to(dev)
    got = tpoly.poly_fir_il(x, w, decim, 2_000, k_block=k_block)
    want = tpoly.poly_fir_il_plain(x, w, decim, 2_000)
    assert _err_db(got.cpu(), want.cpu()) < -100.0


def test_kernel_rejects_bad_inputs():
    dev = _card()
    x, w, decim = _inputs(12_500.0, (25_000.0,), 100)
    x, w = x.to(dev), w.to(dev)
    with pytest.raises(ValueError):
        tpoly.poly_fir_il(x[::2], w, decim, 100)  # not contiguous
    with pytest.raises(ValueError):
        tpoly.poly_fir_il(x, w, decim + 1, 100)  # wrong feature count
    with pytest.raises(ValueError):
        tpoly.poly_fir_il(x.double(), w, decim, 100)


def test_pipeline_on_card_matches_cpu(tmp_path):
    """The same capture through the card and through the CPU's plain path:
    s16 audio within 1 LSB, one kernel launch per dispatched chunk."""
    _card()
    fs, offset = 250_000.0, 25_000.0
    n = int(fs * 0.6)
    t = np.arange(n) / fs
    phase = 2 * np.pi * np.cumsum(offset + 2_500.0 * np.sin(2 * np.pi * 1_000.0 * t)) / fs
    iq = 0.7 * np.exp(1j * phase)
    path = tmp_path / "baseband_145000000Hz_cap.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(fs), codec="pcm_s16le")
    outs = []
    for device in ("cuda", "cpu"):
        out = tmp_path / f"audio_{device}.wav"
        cfg = ProcessingConfig(
            in_path=path, target_freq=145_000_000.0 + offset, output_path=out,
            chunk_size=65_536, device=device,
        )
        before = tpoly.poly_fir_il.launches
        result = ProcessingPipeline(cfg).run()
        launched = tpoly.poly_fir_il.launches - before
        assert launched == (result.dispatched_chunks if device == "cuda" else 0)
        outs.append(read_wav(out)[0][:, 0])
    assert outs[0].size == outs[1].size
    assert np.abs(outs[0] - outs[1]).max() <= 1.5 / 32768
