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

from mix_probe_cases import CODECS, DECIMATION, OFFSET, taps, warm_block
from mix_probe_cases import FS as PROBE_FS
from mix_probe_cases import WIDE_DECIMATION, WIDE_FS, WIDE_OFFSET, wide_taps, wide_warm_block

from iq_to_audio_torch import ProcessingConfig, ProcessingPipeline
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.ops import mix_probe
from iq_to_audio_torch.ops import poly_fir as tpoly
from iq_to_audio_torch.ops import ddc as tddc
from iq_to_audio_torch.ops.ddc import bandpass_kernel, interleave_kernel
from iq_to_audio_torch.ops.nco import device_increment, nco_increment_fixed
from iq_to_audio_torch.pipeline import capture as tcapture
from iq_to_audio_torch.pipeline import pipeline as tpipeline
from iq_to_audio_torch.pipeline.filters import design_channel_filter
from iq_to_audio_torch.ref.chain import choose_mix_sign, mix_sign_powers, pick_mix_sign
from iq_to_audio_torch.utils import spans

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
    taps = design_channel_filter(FS * decim / 26, bandwidth, decim)
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
    """``k_block`` taps per block, rounded up to whole super-taps: blocks of
    1, 2 and 4 super-taps (odd and even counts, a ragged last block)."""
    dev = _card()
    x, w, decim = _inputs(12_500.0, (25_000.0,), 2_000)
    x, w = x.to(dev), w.to(dev)
    got = tpoly.poly_fir_il(x, w, decim, 2_000, k_block=k_block)
    want = tpoly.poly_fir_il_plain(x, w, decim, 2_000)
    assert _err_db(got.cpu(), want.cpu()) < -100.0


@pytest.mark.parametrize("out_size", [1, 3, 63, 257, 161_249])
@pytest.mark.parametrize("layout", ["il", "pair"])
def test_kernel_ragged_rows(out_size, layout):
    """Output counts that are no multiple of 4 and below one tile; rows past
    the end are computed and not stored."""
    dev = _card()
    if layout == "il":
        x, w, _ = _inputs(12_500.0, (25_000.0,), out_size)
        fn, plain = tpoly.poly_fir_il, tpoly.poly_fir_il_plain
    else:
        x, w, _ = _pair_inputs((25_000.0,), out_size)
        fn, plain = tpoly.poly_fir_pair, tpoly.poly_fir_pair_plain
    x, w = x.to(dev), w.to(dev)
    got = fn(x, w, 26, out_size)
    assert got.shape == (2, out_size)
    assert _err_db(got.cpu(), plain(x, w, 26, out_size).cpu()) < -100.0


@pytest.mark.parametrize("decim", [25, 3, 260])
@pytest.mark.parametrize("layout", ["il", "pair"])
def test_kernel_odd_and_wide_decimation(decim, layout):
    """Odd D (rows of the pair 4-byte aligned, a zero-padded last feature
    block) and D = 260, wider than one tap of the former kernel could be."""
    dev = _card()
    out_size = 1_003
    if layout == "il":
        x, w, _ = _inputs(12_500.0, (25_000.0, -40_000.0), out_size, decim=decim)
        fn, plain = tpoly.poly_fir_il, tpoly.poly_fir_il_plain
    else:
        x, w, _ = _pair_inputs((25_000.0, -40_000.0), out_size, decim=decim)
        fn, plain = tpoly.poly_fir_pair, tpoly.poly_fir_pair_plain
    x, w = x.to(dev), w.to(dev)
    got = fn(x, w, decim, out_size)
    assert _err_db(got.cpu(), plain(x, w, decim, out_size).cpu()) < -100.0


#: the airband deployment's five carriers (20 MS/s, D = 208, 12,801 taps)
AIRBAND_OFFSETS = (-6_600_000.0, -3_150_000.0, 350_000.0, 4_975_000.0, 7_025_000.0)


@pytest.mark.parametrize("layout", ["il", "pair"])
def test_kernel_at_the_airband_geometry(layout):
    """The chunk of the airband cell: 12,801 taps at D = 208 (F = 416,
    K = 62), five channels (O = 10), 20,000 output rows, against the plain
    version; two launches bit for bit."""
    dev = _card()
    decim, out_size = 208, 20_000
    taps = design_channel_filter(20e6, 12_500.0, decim)
    assert len(taps) == 12_801
    incs = [nco_increment_fixed(o, 20e6) for o in AIRBAND_OFFSETS]
    kernel = bandpass_kernel(taps, incs)
    rng = np.random.default_rng(208)
    if layout == "il":
        w = tpoly.build_poly_kernel(interleave_kernel(kernel, "iq"), 2 * decim)
        x = rng.uniform(-1, 1, 2 * (len(taps) - 1) + 2 * out_size * decim)
        fn, plain = tpoly.poly_fir_il, tpoly.poly_fir_il_plain
    else:
        w = tpoly.build_poly_kernel(kernel, decim)
        x = rng.uniform(-1, 1, (2, len(taps) - 1 + out_size * decim))
        fn, plain = tpoly.poly_fir_pair, tpoly.poly_fir_pair_plain
    assert w.shape == (62, 416, 10)
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    w = torch.from_numpy(w).to(dev)
    got = fn(x, w, decim, out_size)
    again = fn(x, w, decim, out_size)
    torch.cuda.synchronize()
    assert got.shape == (10, out_size) and torch.equal(got, again)
    assert _err_db(got.cpu(), plain(x, w, decim, out_size).cpu()) < -100.0


@pytest.mark.parametrize("shift", [1, 2, 3])
@pytest.mark.parametrize("layout", ["il", "pair"])
def test_kernel_misaligned_input(shift, layout):
    """A contiguous view that starts ``shift`` floats into its storage (and,
    for the pair, rows of odd length): the kernel falls back to 8- or 4-byte
    copies, not to the plain version."""
    dev = _card()
    out_size = 2_001
    if layout == "il":
        x, w, _ = _inputs(12_500.0, (25_000.0,), out_size)
        x = torch.cat([torch.zeros(shift), x]).to(dev)[shift:]
        fn, plain = tpoly.poly_fir_il, tpoly.poly_fir_il_plain
    else:
        x, w, _ = _pair_inputs((25_000.0,), out_size)
        x = torch.cat([torch.zeros(2 * shift), x[:, : x.shape[1] - shift].reshape(-1)])
        x = x.to(dev)[2 * shift :].view(2, -1)
        fn, plain = tpoly.poly_fir_pair, tpoly.poly_fir_pair_plain
    w = w.to(dev)
    assert x.is_contiguous() and (layout == "pair" or x.data_ptr() % 16 != 0)
    before = fn.launches
    got = fn(x, w, 26, out_size)
    assert fn.launches == before + 1
    assert _err_db(got.cpu(), plain(x, w, 26, out_size).cpu()) < -100.0


@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5])
def test_kernel_every_output_width(channels):
    """O = 2..10 outputs per row, both layouts, and two identical calls give
    the same bits (no atomics, no reduction across CTAs)."""
    dev = _card()
    offsets = [25_000.0 - 17_000.0 * c for c in range(channels)]
    x, w, _ = _inputs(12_500.0, offsets, 4_097)
    xp, wp, _ = _pair_inputs(offsets, 4_097)
    for fn, plain, a, b in (
        (tpoly.poly_fir_il, tpoly.poly_fir_il_plain, x.to(dev), w.to(dev)),
        (tpoly.poly_fir_pair, tpoly.poly_fir_pair_plain, xp.to(dev), wp.to(dev)),
    ):
        got = fn(a, b, 26, 4_097)
        again = fn(a, b, 26, 4_097)
        assert got.shape == (2 * channels, 4_097)
        assert torch.equal(got, again)
        assert _err_db(got.cpu(), plain(a, b, 26, 4_097).cpu()) < -100.0


@pytest.mark.parametrize("layout", ["il", "pair"])
@pytest.mark.parametrize("channels,out_size,k_block", [(1, 40_001, None), (5, 9_001, None), (2, 3_001, 7)])
def test_kernel_many_tiles(layout, channels, out_size, k_block):
    """Streams of 12 to 157 CTAs (fewer and more than the card has SMs), the
    last tile ragged, twice with the same bits."""
    dev = _card()
    offsets = [25_000.0 - 17_000.0 * c for c in range(channels)]
    if layout == "il":
        x, w, _ = _inputs(12_500.0, offsets, out_size)
        fn, plain = tpoly.poly_fir_il, tpoly.poly_fir_il_plain
    else:
        x, w, _ = _pair_inputs(offsets, out_size)
        fn, plain = tpoly.poly_fir_pair, tpoly.poly_fir_pair_plain
    x, w = x.to(dev), w.to(dev)
    got = fn(x, w, 26, out_size, k_block=k_block)
    assert torch.equal(got, fn(x, w, 26, out_size, k_block=k_block))
    assert _err_db(got.cpu(), plain(x, w, 26, out_size).cpu()) < -100.0


@pytest.mark.parametrize("layout", ["il", "pair"])
def test_kernel_failed_launch_leaves_no_packed_taps(layout, monkeypatch):
    """A call that fails inside the library (here: a tap block the card has
    no shared memory for, let past the wrapper's own check) must not leave
    its unfilled scratch behind as the packed taps: the next call with the
    same tap tensor packs them and is right."""
    dev = _card()
    out_size = 1_000
    offsets = [25_000.0 - 17_000.0 * c for c in range(5)]
    if layout == "il":
        x, w, _ = _inputs(2_000.0, offsets, out_size)
        fn, plain = tpoly.poly_fir_il, tpoly.poly_fir_il_plain
    else:
        x, w, _ = _pair_inputs(offsets, out_size, bandwidth=2_000.0)
        fn, plain = tpoly.poly_fir_pair, tpoly.poly_fir_pair_plain
    x, w = x.to(dev), w.to(dev)
    K = w.shape[0]
    assert tpoly.smem_bytes(K, 52, 10) > 227 * 1024
    before = fn.launches
    with monkeypatch.context() as patch:
        patch.setattr(tpoly, "smem_bytes", lambda *a: 0)
        with pytest.raises(RuntimeError, match="CUDA error"):
            fn(x, w, 26, out_size, k_block=K)
    assert fn.launches == before and id(w) not in tpoly._PACKED
    got = fn(x, w, 26, out_size)
    assert fn.launches == before + 1 and id(w) in tpoly._PACKED
    assert _err_db(got.cpu(), plain(x, w, 26, out_size).cpu()) < -100.0


def test_kernel_repacks_taps_written_in_place():
    """The split taps are kept per tap tensor; writing the tensor in place
    must show in the next call."""
    dev = _card()
    x, w, decim = _inputs(12_500.0, (25_000.0,), 1_000)
    x, w = x.to(dev), w.to(dev)
    first = tpoly.poly_fir_il(x, w, decim, 1_000)
    w.mul_(2.0)
    second = tpoly.poly_fir_il(x, w, decim, 1_000)
    assert _err_db(second.cpu(), (2.0 * first).cpu()) < -120.0


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


def test_pipeline_on_card_matches_cpu(tmp_path, monkeypatch):
    """The same capture through the card and through the CPU's plain path:
    s16 audio within 1 LSB, one kernel launch per dispatched chunk."""
    _card()
    monkeypatch.setenv("IQ2A_CHANNELIZER", "conv")
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


def _pair_inputs(offsets, out_size, decim=26, seed=0, bandwidth=12_500.0):
    taps = design_channel_filter(FS * decim / 26, bandwidth, decim)
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
    incs = [nco_increment_fixed(o, FS) for o in (25_000.0, -40_000.0)]
    inc_lo = torch.tensor([device_increment(i, 0, 26) for i in incs])
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


def _five_targets_card_and_cpu(tmp_path, monkeypatch, seconds):
    """Five NFM targets through the card (O = 10: the tap-block loop runs)
    and through the CPU's plain path: every WAV within 1 LSB.  Returns the
    card run's result and its step."""
    _card()
    monkeypatch.setenv("IQ2A_CHANNELIZER", "conv")
    from iq_to_audio_torch.pipeline import pipeline as tpipeline

    steps = []
    build = tpipeline.build_chunk_step

    def recording_build(**kw):
        steps.append(build(**kw))
        return steps[-1]

    monkeypatch.setattr(tpipeline, "build_chunk_step", recording_build)
    fs = 250_000.0
    offsets = (25_000.0, -40_000.0, 60_000.0, -75_000.0, 95_000.0)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    iq = np.zeros(n, np.complex128)
    for k, off in enumerate(offsets):
        audio = np.sin(2 * np.pi * (700.0 + 300.0 * k) * t)
        iq += 0.14 * np.exp(1j * 2 * np.pi * np.cumsum(off + 2_500.0 * audio) / fs)
    path = tmp_path / "baseband_145000000Hz_five.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(fs), codec="pcm_s16le")
    outs, results = {}, {}
    for device in ("cuda", "cpu"):
        cfg = ProcessingConfig(
            in_path=path, target_freq=145_000_000.0 + offsets[0],
            extra_target_freqs=[145_000_000.0 + o for o in offsets[1:]],
            output_path=tmp_path / f"five_{device}.wav", chunk_size=65_536, device=device,
        )
        before = tpoly.poly_fir_il.launches
        results[device] = result = ProcessingPipeline(cfg).run()
        launched = tpoly.poly_fir_il.launches - before
        assert launched == (result.dispatched_chunks if device == "cuda" else 0)
        outs[device] = [read_wav(p)[0][:, 0] for p in result.output_paths]
    assert len(outs["cuda"]) == 5
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.size == want.size
        assert np.abs(got - want).max() <= 1.5 / 32768
    return results["cuda"], steps[0]


def test_five_targets_on_card_match_cpu(tmp_path, monkeypatch):
    _five_targets_card_and_cpu(tmp_path, monkeypatch, 0.5)


def test_five_targets_over_many_upload_groups_match_cpu(tmp_path, monkeypatch):
    """Each block is read straight into a pinned upload slot while the
    other slot's copy may be in flight: over six or more groups through
    the two-slot ring, a slot refilled before its copy ended would show
    in the WAVs."""
    result, step = _five_targets_card_and_cpu(tmp_path, monkeypatch, 3.0)
    assert result.dispatched_chunks // step.super_chunks >= 6


# --- the library formulations, the FFT bank and the run modes on the card ---


@pytest.mark.parametrize("channels", [1, 5])
def test_formulations_on_card_match_hand_kernel(channels):
    """conv1d, J-conv and shifted matmul < -100 dB and the FFT bank < -90 dB
    against the hand kernel, from one stream."""
    from iq_to_audio_torch.ops.osfir import OverlapSavePlan, os_fir_bank

    dev = _card()
    decim, m = 26, 5_000
    offsets = [25_000.0 - 170_000.0 * c for c in range(channels)]
    taps = design_channel_filter(FS, 12_500.0, decim)
    L = len(taps)
    incs = [nco_increment_fixed(o, FS) for o in offsets]
    pair = bandpass_kernel(taps, incs)
    kil = interleave_kernel(pair, "iq")
    j = min(128 // kil.shape[0], m)
    rng = np.random.default_rng(channels)
    x = torch.from_numpy(rng.uniform(-1, 1, 2 * (L - 1) + 2 * m * decim).astype(np.float32)).to(dev)
    hand = tddc.fir_il(
        x, decim, m, L, poly_w=torch.from_numpy(tpoly.build_poly_kernel(kil, 2 * decim)).to(dev)
    ).cpu()
    others = {
        "conv1d": {"kernel_il": torch.from_numpy(kil).to(dev)},
        "jconv": {"j_kernel": torch.from_numpy(tddc.j_lanes_kernel(kil, decim, j)).to(dev), "j_lanes": j},
        "mm": {"mm_kernel": torch.from_numpy(tddc.shift_matmul_kernel(kil, decim, j)).to(dev), "j_lanes": j},
    }
    for name, kw in others.items():
        got = tddc.fir_il(x, decim, m, L, **kw).cpu()
        assert got.shape == hand.shape, name
        assert _err_db(got, hand) < -100.0, name
    os_plan = OverlapSavePlan.for_chunk(L, decim, m * decim)
    assert not os_plan.poly and os_plan.fft_size & (os_plan.fft_size - 1) == 0
    bank = torch.from_numpy(tddc.bank_from_kernel(pair, os_plan)).to(dev)
    xc = tddc.complex_from_interleaved(x, "iq")
    dec, _ = os_fir_bank(os_plan, bank, xc[L - 1 :], xc[: L - 1])
    got = torch.view_as_real(dec).permute(0, 2, 1).reshape(-1, m).cpu()
    assert _err_db(got, hand) < -90.0


def test_fullrate_stages_on_card_match_cpu():
    dev = _card()
    decim, n = 26, 26 * 4_000
    taps = design_channel_filter(FS, 12_500.0, decim)
    L = len(taps)
    incs = [nco_increment_fixed(o, FS) for o in (25_000.0, -40_000.0)]
    kernel = torch.from_numpy(bandpass_kernel(taps, incs))
    rng = np.random.default_rng(9)
    xr, xi = torch.from_numpy(rng.uniform(-1, 1, (2, n)).astype(np.float32))
    tail = torch.from_numpy(rng.uniform(-1, 1, (2, L - 1)).astype(np.float32))
    phase = torch.tensor([12345 << 30, 4_000_000_000 << 30], dtype=torch.int64)
    inc_t = torch.tensor([device_increment(i) for i in incs], dtype=torch.int64)
    plan = tddc.DDCPlan(L, decim, n)
    outs = {}
    for device in (dev, torch.device("cpu")):
        args = [t.to(device) for t in (kernel, xr, xi, tail, phase, inc_t)]
        outs[device.type] = [o.cpu() for o in tddc.ddc_fullrate_stages(plan, *args)]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert _err_db(got, want) < -100.0


def _nfm_capture(tmp_path, seconds=0.6):
    fs, offset = 250_000.0, 25_000.0
    n = int(fs * seconds)
    t = np.arange(n) / fs
    phase = 2 * np.pi * np.cumsum(offset + 2_500.0 * np.sin(2 * np.pi * 1_000.0 * t)) / fs
    iq = 0.7 * np.exp(1j * phase)
    path = tmp_path / "baseband_145000000Hz_cap.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(fs), codec="pcm_s16le")
    return path, 145_000_000.0 + offset


@pytest.mark.parametrize("mode", ["pass_through", "dump_iq", "stages", "fft", "mm", "jconv"])
def test_run_modes_on_card_match_cpu(tmp_path, monkeypatch, mode):
    """Each run mode on the card against the same run on the CPU's conv
    path; the hand kernel launches once per chunk unless the run is pinned
    to the FFT channelizer.  The JAX package's ``IQ2A_MM`` / ``IQ2A_CONVJ``
    select nothing here: the run stays on the hand kernel."""
    _card()
    path, target = _nfm_capture(tmp_path)
    kw = {}
    if mode == "pass_through":
        kw["demod_mode"] = "none"
    if mode == "dump_iq":
        kw["dump_iq_path"] = tmp_path / "chan.cf32"
    if mode == "stages":
        kw["plot_stages_path"] = tmp_path / "stages.png"
    outs = {}
    for device in ("cuda", "cpu"):
        monkeypatch.setenv("IQ2A_CHANNELIZER", "fft" if (mode, device) == ("fft", "cuda") else "conv")
        monkeypatch.delenv("IQ2A_MM", raising=False)
        monkeypatch.delenv("IQ2A_CONVJ", raising=False)
        if device == "cuda" and mode == "mm":
            monkeypatch.setenv("IQ2A_MM", "1")
        if device == "cuda" and mode == "jconv":
            monkeypatch.setenv("IQ2A_CONVJ", "1")
        if "dump_iq_path" in kw:
            kw["dump_iq_path"] = tmp_path / f"chan_{device}.cf32"
        cfg = ProcessingConfig(
            in_path=path, target_freq=target, output_path=tmp_path / f"out_{device}.wav",
            chunk_size=65_536, device=device, mix_sign_override=1, **kw,
        )
        before = tpoly.poly_fir_il.launches
        result = ProcessingPipeline(cfg).run()
        launched = tpoly.poly_fir_il.launches - before
        hand = device == "cuda" and mode != "fft"
        assert launched == (result.dispatched_chunks if hand else 0)
        if device == "cuda":
            assert result.channelizer == ("fft" if mode == "fft" else "conv")
        outs[device] = read_wav(result.output_paths[0])[0]
    assert outs["cuda"].shape == outs["cpu"].shape
    if mode == "fft":
        assert _err_db(outs["cuda"], outs["cpu"]) < -60.0
    else:
        assert np.abs(outs["cuda"] - outs["cpu"]).max() <= 1.5 / 32768
    if mode == "dump_iq":
        a = np.fromfile(tmp_path / "chan_cuda.cf32", np.float32)
        b = np.fromfile(tmp_path / "chan_cpu.cf32", np.float32)
        assert a.size == b.size and _err_db(a, b) < -100.0


def test_native_channelizer_refused_on_card(tmp_path, monkeypatch):
    _card()
    monkeypatch.setenv("IQ2A_CHANNELIZER", "native")
    path, target = _nfm_capture(tmp_path, 0.2)
    cfg = ProcessingConfig(in_path=path, target_freq=target, output_path=tmp_path / "o.wav")
    with pytest.raises(ValueError, match="native runs on the CPU device only"):
        ProcessingPipeline(cfg).run()


@pytest.mark.parametrize("backend", ["torch", "matmul"])
def test_analysis_backends_on_card(backend):
    from iq_to_audio_torch.analysis import compute_psd

    _card()
    t = np.arange(9_600) / 48_000.0
    iq = (0.5 * np.exp(2j * np.pi * 5_000.0 * t)).astype(np.complex64)
    _, want = compute_psd(iq, 48_000.0, nfft=4096, backend="numpy")
    _, got = compute_psd(iq, 48_000.0, nfft=4096, backend=backend)  # device=None: the card
    hot = want > want.max() - 80.0
    np.testing.assert_allclose(got[hot], want[hot], atol=0.3)


def test_resident_rate_on_card():
    """The full step's resident rate from CUDA-graph replays: the wrapper
    counts the two warm-up groups and the captured ones (a replay launches
    no wrapper), the profiler sees the hand kernel once per chunk of a
    replay, and the graph's rate is within 0.5-1.05x of the rate its
    device-busy time implies."""
    from iq_to_audio_torch.pipeline.benchmark import measure_step_resident_msps

    _card()
    before = tpoly.poly_fir_il.launches
    out = measure_step_resident_msps(250_000.0, target_chunk=65_536, seconds_target=0.2)
    assert out["device"].startswith("cuda") and out["channelizer"] == "conv"
    assert out["method"] == "cuda_graph" and out["msps"] > 0
    groups = out["calls"]
    assert tpoly.poly_fir_il.launches - before == (groups + 2) * out["super_chunks"]
    assert out["kernel_events"] == groups * out["super_chunks"]
    assert 0.5 <= out["msps"] / out["busy_msps"] <= 1.05


def test_hetero_resident_probe_on_card():
    """The burst executor's probe of the hand kernel times graph replays,
    within 0.5-1.05x of its device-busy bound."""
    from iq_to_audio_torch.pipeline.hetero import HeteroExecutor

    _card()
    ex = HeteroExecutor(cpu_workers=0)
    msps = ex.measure_resident_compute(1601, 26)
    probe = ex.last_compute_probe
    assert probe["method"] == "cuda_graph" and msps == probe["msps"] > 0
    assert probe["kernel_events"] == probe["calls"]
    assert 0.5 <= probe["msps"] / probe["busy_msps"] <= 1.05


def test_sharded_step_world_of_one_on_card():
    """A world of one (an in-process one-rank NCCL group): the sharded step
    launches the hand kernel once per chunk and its audio equals the plain
    single-device step's within the distributed scans' rounding."""
    import torch.distributed as dist

    from iq_to_audio_torch.demod import create_decoder
    from iq_to_audio_torch.ops.resample import ResamplePlan, design_resampler_kernel
    from iq_to_audio_torch.parallel.launch import run_world
    from iq_to_audio_torch.pipeline.step import build_chunk_step

    dev = _card()
    taps = design_channel_filter(FS, 12_500.0, 26)
    plan = tddc.DDCPlan(len(taps), 26, 26 * 20_000)
    rs_plan = ResamplePlan.create(FS / 26, 48_000.0, plan.out_size)
    incs = [nco_increment_fixed(25_000.0, FS)]
    pair = bandpass_kernel(taps, incs)
    rs_np = design_resampler_kernel(rs_plan.up, rs_plan.down)
    rng = np.random.default_rng(3)
    raws = [rng.integers(-8000, 8000, 2 * plan.chunk_size, dtype=np.int16) for _ in range(3)]
    offsets = [rs_plan.chunk_offset(k * plan.out_size) for k in range(3)]
    alpha = math.exp(-1.0 / (FS / 26 * 300e-6))
    before = tpoly.poly_fir_il.launches
    (sharded,) = run_world(
        _sharded_rank, 1, "cuda", (plan, rs_plan, incs, interleave_kernel(pair, "iq"), rs_np,
                                   raws, offsets, alpha),
    )
    assert tpoly.poly_fir_il.launches - before == len(raws)
    assert not dist.is_initialized()
    decoder = create_decoder("nfm", deemph_us=300.0, agc_enabled=True)
    decoder.setup(FS / 26)
    step = build_chunk_step(
        ddc_plan=plan, rs_plan=rs_plan, ddc_kernel_np=pair, rs_kernel_np=rs_np, incs_fixed=incs,
        codec="pcm_s16le", iq_order="iq", decoder=decoder, device=dev, super_chunks=1,
    )
    state, accs = step.init_state(), step.init_accs()
    cap = step.audio_capacity
    for k, (raw, off) in enumerate(zip(raws, offsets)):
        slot = k % step.acc_chunks
        state = step.fn(state, accs, torch.from_numpy(raw).to(dev), off, slot)
        count = rs_plan.out_count(k * plan.out_size, plan.out_size)
        want = accs["audio"][:, slot * cap : slot * cap + count].cpu().numpy() / 32767.0
        got = np.round(np.clip(sharded[k][:, :count], -0.99, 0.99) * 32767.0) / 32767.0
        assert _err_db(got, want) < -60.0, k


def _sharded_rank(ctx, plan, rs_plan, incs, kernel_il, rs_np, raws, offsets, alpha):
    from iq_to_audio_torch.parallel.mesh import make_mesh
    from iq_to_audio_torch.parallel.sharded import build_sharded_step, local_operands

    mesh = make_mesh(ctx.world, device="cuda")
    fn, init_state = build_sharded_step(mesh, ddc_plan=plan, rs_plan=rs_plan, num_channels=1,
                                        codec="pcm_s16le", deemph_alpha=alpha)
    state = init_state()
    inc_t, poly_w = local_operands(mesh, incs, kernel_il, plan.decimation)
    rs_k = torch.from_numpy(rs_np).to(ctx.device)
    out = []
    for raw, off in zip(raws, offsets):
        state, audio = fn(state, torch.from_numpy(raw).to(ctx.device), off, inc_t, poly_w, rs_k)
        out.append(audio.cpu().numpy())
    return out


def test_burst_on_card(tmp_path):
    """Burst mode on the card with one CPU worker: the device stream takes
    at least one segment through the hand kernel, and the spliced WAV
    matches a serial run on the card."""
    from iq_to_audio_torch.pipeline.hetero import HeteroExecutor

    _card()
    path, target = _nfm_capture(tmp_path, 4.0)

    def cfg(name):
        return ProcessingConfig(in_path=path, target_freq=target, output_path=tmp_path / name,
                                chunk_size=65_536, mix_sign_override=1)

    ProcessingPipeline(cfg("serial.wav")).run()
    before = tpoly.poly_fir_il.launches
    with HeteroExecutor(cpu_workers=1, n_segments=4, warm_seconds=0.25) as ex:
        ex.run(cfg("burst.wav"))
        stats = ex.last_stats
    launched = tpoly.poly_fir_il.launches - before
    assert stats["device"].startswith("cuda")
    assert stats["device_segments"] >= 1 and stats["device_runs"] >= 1
    assert launched > 0 and launched >= stats["device_runs"]
    assert stats["wire_probe"]["bw_up"] > 0
    a = read_wav(tmp_path / "serial.wav")[0]
    b = read_wav(tmp_path / "burst.wav")[0]
    assert a.shape == b.shape
    assert _err_db(b, a) < -60.0


def test_burst_on_card_raises_a_failed_kernel(tmp_path, monkeypatch):
    """A kernel that fails to load on the card fails the burst run and the
    resident probe; the CPU worker does not hide it."""
    from iq_to_audio_torch.pipeline.hetero import HeteroExecutor

    _card()
    path, target = _nfm_capture(tmp_path, 4.0)

    def _broken():
        raise RuntimeError("poly_fir: the kernel library failed to load")

    monkeypatch.setattr(tpoly, "_library", _broken)
    monkeypatch.delenv("IQ2A_DEVICE_MSPS", raising=False)
    cfg = ProcessingConfig(in_path=path, target_freq=target, output_path=tmp_path / "o.wav",
                           chunk_size=65_536, mix_sign_override=1)
    with HeteroExecutor(cpu_workers=1, n_segments=4, warm_seconds=0.25) as ex:
        with pytest.raises(RuntimeError, match="failed to load"):
            ex.run(cfg)
    with pytest.raises(RuntimeError, match="failed to load"):
        HeteroExecutor(cpu_workers=0).measure_resident_compute(1601, 26)
    assert not (tmp_path / "o.wav").exists()


def test_uncapturable_work_is_timed_by_the_profiler():
    """Work that synchronises with the host cannot be captured in a CUDA
    graph: the rate then comes from the profiler's device-busy time and
    says so, and the card goes on to capture the next work."""
    from iq_to_audio_torch.utils.device_clock import resident_rate

    dev = _card()
    x = torch.ones(1 << 20, device=dev)
    out = resident_rate(lambda _i: float(x.sum().item()), x.numel(), dev, calls=2,
                        seconds_target=0.01)
    assert out["method"] == "profiler_busy" and out["msps"] > 0
    again = resident_rate(lambda _i: x.mul_(1.0), x.numel(), dev, calls=2, seconds_target=0.01)
    assert again["method"] == "cuda_graph" and again["msps"] > 0


# --- the mixer-sign probe, csrc/mix_probe.cu ----------------------------------


def _probe_on_card(warm, h, dev):
    before = mix_probe.mix_sign_powers.launches
    got = mix_probe.mix_sign_powers(warm, PROBE_FS, OFFSET, h, DECIMATION, dev)
    return got, mix_probe.mix_sign_powers.launches - before


def _agree_1e10(got, want) -> None:
    assert np.allclose(got, want, rtol=1e-10, atol=0.0), (got, want)


@pytest.mark.parametrize("carrier", [1, -1, 0], ids=["plus", "minus", "noise"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("mode", ["nfm", "usb"])
def test_mix_probe_matches_twin(mode, codec, carrier):
    """The kernel's float64 powers against the host twin's on the CPU
    tests' seeds: 1e-10 relative, the same sign, one launch."""
    dev = _card()
    h = taps(mode)
    warm = warm_block(codec, carrier, seed=len(h) + carrier)
    got, launched = _probe_on_card(warm, h, dev)
    _agree_1e10(got, mix_sign_powers(warm, PROBE_FS, OFFSET, h, DECIMATION))
    assert pick_mix_sign(got) == choose_mix_sign(warm, PROBE_FS, OFFSET, h, DECIMATION)
    assert launched == 1


@pytest.mark.parametrize(
    "samples,zero", [(1_000, False), (DECIMATION - 3, False), (20_000, True), (0, False)],
    ids=["shorter_than_taps", "under_one_step", "all_zero", "empty"],
)
def test_mix_probe_edges_on_card(samples, zero):
    dev = _card()
    h = taps("nfm")
    warm = warm_block("pcm_s16le", 1, seed=3, samples=max(samples, 1))[:samples]
    if zero:
        warm = np.zeros_like(warm)
    got, launched = _probe_on_card(warm, h, dev)
    _agree_1e10(got, mix_sign_powers(warm, PROBE_FS, OFFSET, h, DECIMATION))
    assert pick_mix_sign(got) == choose_mix_sign(warm, PROBE_FS, OFFSET, h, DECIMATION)
    assert launched == (samples > 0)


@pytest.mark.parametrize("m,tc", [(1, 7_143), (7, 1_000), (58, 333), (300, 64)])
def test_mix_probe_tap_passes_on_card(monkeypatch, m, tc):
    """Tiles forced off the chooser's: one output a CTA, several tap passes
    a tile, a ragged last pass, few CTAs."""
    dev = _card()
    monkeypatch.setattr(mix_probe, "choose_tile", lambda *a: (m, tc))
    h = taps("usb")
    warm = warm_block("pcm_s16le", -1, seed=21)
    got, launched = _probe_on_card(warm, h, dev)
    _agree_1e10(got, mix_sign_powers(warm, PROBE_FS, OFFSET, h, DECIMATION))
    assert launched == 1


def test_mix_probe_is_deterministic():
    """No floating-point atomics: 20 calls give the same powers bit for bit."""
    dev = _card()
    h = taps("nfm")
    warm = warm_block("pcm_f32le", 0, seed=7)
    runs = {_probe_on_card(warm, h, dev)[0] for _ in range(20)}
    assert len(runs) == 1


def test_mix_probe_rejects_bad_inputs():
    dev = _card()
    h = taps("nfm")
    warm = warm_block("pcm_s16le", 1, seed=3)
    with pytest.raises(ValueError):
        mix_probe.mix_sign_powers(warm.astype(np.complex128), PROBE_FS, OFFSET, h, DECIMATION, dev)
    with pytest.raises(ValueError):
        mix_probe.mix_sign_powers(warm, PROBE_FS, OFFSET, h + 0j, DECIMATION, dev)


@pytest.mark.parametrize("override", [None, -1, 1])
@pytest.mark.parametrize("carrier", [1, -1])
def test_pipeline_picks_the_sign_on_card(tmp_path, monkeypatch, carrier, override):
    """A run on the card takes the twin's sign on its own warm-up block,
    decided by the kernel (``probe_on_device`` on ``iq2a.setup.mix_sign``);
    ``mix_sign_override`` skips the probe and the counter."""
    from torch.profiler import ProfilerActivity, profile

    _card()
    fs, offset = 250_000.0, 25_000.0
    n = int(fs * 0.6)
    phase = 2 * np.pi * carrier * offset * np.arange(n) / fs
    iq = 0.7 * np.exp(1j * phase)
    path = tmp_path / "baseband_145000000Hz_cap.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(fs), codec="pcm_s16le")
    seen = []
    real = tcapture.choose_mix_sign_on

    def spy(device, warm, *args):
        seen.append((device, warm, args))
        return real(device, warm, *args)

    monkeypatch.setattr(tcapture, "choose_mix_sign_on", spy)
    cfg = ProcessingConfig(
        in_path=path, target_freq=145_000_000.0 + offset, output_path=tmp_path / "a.wav",
        chunk_size=65_536, device="cuda", mix_sign_override=override,
    )
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            result = ProcessingPipeline(cfg).run()
        (rec,) = [r for r in spans.records() if r.name == "iq2a.setup.mix_sign"]
    finally:
        spans.reset()
    if override is not None:
        assert seen == [] and result.mix_sign == override
        assert "probe_on_device" not in rec.counters
        return
    ((device, warm, args),) = seen
    assert device.type == "cuda"
    assert result.mix_sign == choose_mix_sign(warm, *args) == carrier
    assert rec.counters == {"probe_on_device": 1}


@pytest.mark.parametrize("carrier", [1, -1, 0], ids=["plus", "minus", "noise"])
def test_mix_probe_at_the_airband_geometry(carrier):
    """12,801 taps at D = 208 over the first 1,000,000 samples of a 20 MS/s
    block (nine outputs a CTA, every tap in one pass): the kernel's powers
    against the host twin's, 1e-10 relative, the same sign (the CPU tests
    hold the twin's sign to the JAX package's on the same blocks), one
    launch."""
    dev = _card()
    h = wide_taps()
    warm = wide_warm_block(carrier, seed=208 + carrier)
    assert mix_probe.choose_tile(3_606, h.size, WIDE_DECIMATION, 132) == (9, 12_801)
    before = mix_probe.mix_sign_powers.launches
    got = mix_probe.mix_sign_powers(warm, WIDE_FS, WIDE_OFFSET, h, WIDE_DECIMATION, dev)
    assert mix_probe.mix_sign_powers.launches == before + 1
    _agree_1e10(got, mix_sign_powers(warm, WIDE_FS, WIDE_OFFSET, h, WIDE_DECIMATION))
    sign = choose_mix_sign(warm, WIDE_FS, WIDE_OFFSET, h, WIDE_DECIMATION)
    assert pick_mix_sign(got) == sign
    if carrier:
        assert sign == carrier
