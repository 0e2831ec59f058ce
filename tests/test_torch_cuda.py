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
from iq_to_audio_torch.ops import ddc as tddc
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


def _pair_inputs(offsets, out_size, decim=26, seed=0):
    taps = design_channel_filter(FS, 12_500.0, decim)
    incs = [nco_increment_fixed(o, FS) for o in offsets]
    kernel = bandpass_kernel(taps, incs)
    n = len(taps) - 1 + out_size * decim
    x = np.random.default_rng(seed).uniform(-1, 1, (2, n)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(tpoly.build_poly_kernel(kernel, decim)), kernel


@pytest.mark.parametrize("channels", [1, 5])
@pytest.mark.parametrize("k_block", [None, 1, 7, 16])
def test_pair_kernel_matches_plain(channels, k_block):
    """The pair-input kernel reads the (2, T, D) -> (T, 2D) relay in place:
    against its plain version (relay with torch ops, then the tap loop)."""
    dev = _card()
    offsets = [25_000.0 - 17_000.0 * c for c in range(channels)]
    x, w, _ = _pair_inputs(offsets, 3_001)
    x, w = x.to(dev), w.to(dev)
    before = tpoly.poly_fir_pair.launches
    got = tpoly.poly_fir_pair(x, w, 26, 3_001, k_block=k_block)
    torch.cuda.synchronize()
    assert tpoly.poly_fir_pair.launches == before + 1
    want = tpoly.poly_fir_pair_plain(x, w, 26, 3_001)
    assert got.shape == (2 * channels, 3_001)
    assert _err_db(got.cpu(), want.cpu()) < -100.0


def test_pair_kernel_rejects_bad_inputs():
    dev = _card()
    x, w, _ = _pair_inputs((25_000.0,), 100)
    x, w = x.to(dev), w.to(dev)
    with pytest.raises(ValueError):
        tpoly.poly_fir_pair(x[0], w, 26, 100)  # not (2, n)
    with pytest.raises(ValueError):
        tpoly.poly_fir_pair(x[:, ::2], w, 26, 100)  # not contiguous
    with pytest.raises(ValueError):
        tpoly.poly_fir_pair(x, w, 27, 100)  # wrong feature count


def test_ddc_apply_on_card_matches_cpu():
    """``ddc_apply`` through the pair kernel on the card against the CPU's
    plain path, two chunks with the tail and phase carried."""
    dev = _card()
    x, w, kernel = _pair_inputs((25_000.0, -40_000.0), 2 * 4_000)
    taps_len = kernel.shape[-1]
    plan = tddc.DDCPlan(taps_len, 26, 26 * 4_000)
    incs = torch.tensor([nco_increment_fixed(o, FS) for o in (25_000.0, -40_000.0)])
    inc_lo = (incs * 26) & tddc.MASK32
    outs = {}
    for device in (dev, torch.device("cpu")):
        tail = x[:, : taps_len - 1].to(device)
        phase = torch.zeros(2, dtype=torch.int64, device=device)
        k, ww, il = torch.from_numpy(kernel).to(device), w.to(device), inc_lo.to(device)
        parts = []
        for c in range(2):
            lo = taps_len - 1 + c * plan.chunk_size
            xr = x[0, lo : lo + plan.chunk_size].to(device)
            xi = x[1, lo : lo + plan.chunk_size].to(device)
            yr, yi, tail, phase = tddc.ddc_apply(plan, k, xr, xi, tail, phase, il, poly_w=ww)
            parts.append(torch.stack([yr, yi]).cpu())
        outs[device.type] = (torch.cat(parts, -1), phase.cpu())
    assert _err_db(outs["cuda"][0], outs["cpu"][0]) < -100.0
    assert torch.equal(outs["cuda"][1], outs["cpu"][1])


def test_five_targets_on_card_match_cpu(tmp_path):
    """Five NFM targets through the card (O = 10: the tap-block loop runs)
    and through the CPU's plain path: every WAV within 1 LSB."""
    _card()
    fs = 250_000.0
    offsets = (25_000.0, -40_000.0, 60_000.0, -75_000.0, 95_000.0)
    n = int(fs * 0.5)
    t = np.arange(n) / fs
    iq = np.zeros(n, np.complex128)
    for k, off in enumerate(offsets):
        audio = np.sin(2 * np.pi * (700.0 + 300.0 * k) * t)
        iq += 0.14 * np.exp(1j * 2 * np.pi * np.cumsum(off + 2_500.0 * audio) / fs)
    path = tmp_path / "baseband_145000000Hz_five.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(fs), codec="pcm_s16le")
    outs = {}
    for device in ("cuda", "cpu"):
        cfg = ProcessingConfig(
            in_path=path, target_freq=145_000_000.0 + offsets[0],
            extra_target_freqs=[145_000_000.0 + o for o in offsets[1:]],
            output_path=tmp_path / f"five_{device}.wav", chunk_size=65_536, device=device,
        )
        before = tpoly.poly_fir_il.launches
        result = ProcessingPipeline(cfg).run()
        launched = tpoly.poly_fir_il.launches - before
        assert launched == (result.dispatched_chunks if device == "cuda" else 0)
        outs[device] = [read_wav(p)[0][:, 0] for p in result.output_paths]
    assert len(outs["cuda"]) == 5
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.size == want.size
        assert np.abs(got - want).max() <= 1.5 / 32768
