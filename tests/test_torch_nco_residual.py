"""The port's 62-bit NCO (``ops/nco.py``): the uint32 increment with the
residual it leaves out of the exact frequency, the oscillator and the phase
advance (``ops/ddc.py``), the bandpass taps, the step's state and the native
channelizer's turn onto it; on the CPU, against exact integer and float64
arithmetic."""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from conftest import error_db, make_am_iq

from iq_to_audio_torch import ProcessingConfig, ProcessingPipeline
from iq_to_audio_torch.convert import state_from_jax, state_to_jax
from iq_to_audio_torch.demod import create_decoder
from iq_to_audio_torch.io.writer import write_stereo_wav
from iq_to_audio_torch.ops.ddc import (
    DDCPlan,
    bandpass_kernel,
    lowrate_osc,
    mix_and_advance,
    nco_advance,
)
from iq_to_audio_torch.ops.nco import (
    MASK62,
    PHASE_BITS,
    device_increment,
    nco_increment_fixed,
    nco_increment_residual,
)
from iq_to_audio_torch.pipeline import step as tstep
from iq_to_audio_torch.pipeline.filters import compute_decimation, design_channel_filter
from iq_to_audio_torch.ref.chain import RefOscillator, RefOverlapSaveFIR

torch.set_num_threads(1)

CASES = [
    # (offset Hz, sample rate, mixer sign)
    (-90_000.0, 2_500_000.0, 1),
    (105_000.0, 2_500_000.0, -1),
    (25_000.0, 250_000.0, 1),
    (14_240_001.37, 30_000_000.0, 1),
    (625_000.0, 2_500_000.0, 1),  # a quarter cycle: the uint32 increment is exact
    (0.0, 2_500_000.0, 1),
]


@pytest.mark.parametrize("off, fs, sign", CASES)
def test_residual_completes_the_increment(off, fs, sign):
    inc = nco_increment_fixed(off, fs, sign)
    res = nco_increment_residual(off, fs, sign)
    exact = (Fraction(-sign * off) / Fraction(fs)) % 1
    got = Fraction(inc, 1 << 32) + Fraction(res, 1 << PHASE_BITS)
    err = abs(got - exact)
    assert min(err, 1 - err) <= Fraction(1, 1 << (PHASE_BITS + 1))
    assert Fraction(device_increment(inc, res), 1 << PHASE_BITS) == got % 1
    assert abs(res) <= 1 << 29
    if (exact * (1 << 32)).denominator == 1:
        assert res == 0


def _exact_angle(phase0: int, inc: int, k: np.ndarray) -> np.ndarray:
    ticks = [(phase0 + inc * int(i)) % (1 << PHASE_BITS) for i in k]
    return np.asarray(ticks, np.float64) * (2.0 * math.pi / (1 << PHASE_BITS))


def test_the_oscillator_turns_by_the_exact_62_bit_phase():
    rng = np.random.default_rng(4)
    m = 5_000
    phase0 = torch.tensor([0, MASK62 - 12_345, 3 << 60], dtype=torch.int64)
    inc = torch.tensor(
        [device_increment(123_456_789, 1 << 29, 26),
         device_increment(0xFFFF_FFF0, -(1 << 28), 26),
         device_increment(987_654_321, 12_345, 26)],
        dtype=torch.int64,
    )
    yr = torch.from_numpy(rng.standard_normal((3, m)).astype(np.float32))
    yi = torch.from_numpy(rng.standard_normal((3, m)).astype(np.float32))
    zr, zi, phase_next = mix_and_advance(yr, yi, phase0, inc, m)
    for c in range(3):
        angle = _exact_angle(int(phase0[c]), int(inc[c]), np.arange(m))
        want = (yr[c].double().numpy() + 1j * yi[c].double().numpy()) * np.exp(1j * angle)
        got = zr[c].double().numpy() + 1j * zi[c].double().numpy()
        # float32 angles of the top 32 bits: 2**-24 of a turn at the most
        assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()
        assert int(phase_next[c]) == (int(phase0[c]) + int(inc[c]) * m) % (1 << PHASE_BITS)


@pytest.mark.parametrize("k", [0, 1, 161_250, (1 << 30) - 1])
def test_the_phase_advances_exactly(k):
    phase0 = torch.tensor([0, MASK62, 1 << 61, 977], dtype=torch.int64)
    inc = torch.tensor([MASK62, MASK62 - (1 << 40), 1, (5 << 58) + 3], dtype=torch.int64)
    got = nco_advance(phase0, inc, k)
    for c in range(4):
        assert int(got[c]) == (int(phase0[c]) + int(inc[c]) * k) % (1 << PHASE_BITS)


def test_on_the_uint32_grid_the_oscillator_is_the_uint32_one():
    """A zero residual: the top 32 bits of the phase are the JAX package's
    uint32 phase, and the angle is rounded as it rounds it."""
    rng = np.random.default_rng(7)
    m = 3_000
    p32 = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    i32 = rng.integers(0, 1 << 32, 4, dtype=np.uint64)
    cos, sin = lowrate_osc(
        torch.from_numpy((p32 << np.uint64(30)).astype(np.int64)),
        torch.from_numpy((i32 << np.uint64(30)).astype(np.int64)), m,
    )
    ph = (p32[:, None] + i32[:, None] * np.arange(m, dtype=np.uint64)) % np.uint64(1 << 32)
    angle = ph.astype(np.float32) * np.float32(2.0 * np.pi / (1 << 32))
    assert torch.equal(cos, torch.cos(torch.from_numpy(angle)))
    assert torch.equal(sin, torch.sin(torch.from_numpy(angle)))


def test_mixing_chunked_equals_whole():
    rng = np.random.default_rng(5)
    yr = torch.from_numpy(rng.standard_normal((2, 6_000)).astype(np.float32))
    yi = torch.from_numpy(rng.standard_normal((2, 6_000)).astype(np.float32))
    phase0 = torch.tensor([17, MASK62 - 3], dtype=torch.int64)
    inc = torch.tensor([device_increment(4_000_000, -(5 << 27)), device_increment(9, 9 << 26)])
    wr, wi, w_next = mix_and_advance(yr, yi, phase0, inc, 6_000)
    ar, ai, mid = mix_and_advance(yr[:, :2_500], yi[:, :2_500], phase0, inc, 2_500)
    br, bi, b_next = mix_and_advance(yr[:, 2_500:], yi[:, 2_500:], mid, inc, 3_500)
    assert torch.equal(torch.cat([ar, br], -1), wr) and torch.equal(torch.cat([ai, bi], -1), wi)
    assert torch.equal(b_next, w_next)


def test_bandpass_taps_turn_at_the_exact_frequency():
    fs, off = 2_500_000.0, -90_000.0
    taps = design_channel_filter(fs, 2_800.0, 26)
    inc = nco_increment_fixed(off, fs)
    res = nco_increment_residual(off, fs)
    plain = bandpass_kernel(taps, [inc])
    np.testing.assert_array_equal(bandpass_kernel(taps, [inc], [0]), plain)
    exact = bandpass_kernel(taps, [inc], [res])
    j = np.arange(taps.size)[::-1]
    want = taps[::-1] * np.exp(-2j * np.pi * (-off / fs) * j)
    got = exact[0, 0].astype(np.float64) + 1j * exact[1, 0].astype(np.float64)
    np.testing.assert_allclose(got, want, atol=2e-9)
    assert not np.array_equal(exact, plain)


def _step(offsets, fs=250_000.0):
    decim, fs_ch = compute_decimation(fs, 96_000.0)
    taps = design_channel_filter(fs, 12_500.0, decim)
    plan = DDCPlan.create(len(taps), decim, target_chunk=16_384)
    incs = [nco_increment_fixed(o, fs) for o in offsets]
    res = [nco_increment_residual(o, fs) for o in offsets]
    decoder = create_decoder("usb", deemph_us=300.0, agc_enabled=True)
    decoder.setup(fs_ch)
    return tstep.build_chunk_step(
        ddc_plan=plan, rs_plan=None, ddc_kernel_np=bandpass_kernel(taps, incs, res),
        rs_kernel_np=None, incs_fixed=incs, codec="pcm_s16le", iq_order="iq", decoder=decoder,
        device=torch.device("cpu"), est_total_chunks=4, channelizer="conv", nco_res=res,
    )


def test_a_stream_started_anywhere_carries_the_same_phase():
    step = _step([25_000.0, -60_000.0])
    state, accs = step.init_state(), step.init_accs()
    raw = torch.from_numpy(
        np.random.default_rng(6).integers(-3_000, 3_000, (3, 2 * step.chunk_size)).astype(np.int16)
    )
    for k in range(3):
        state = step.fn(state, accs, raw[k], 0, k)
    later = step.init_state(3 * step.chunk_size)
    assert torch.equal(state["phase"], later["phase"])
    saved = state_to_jax(later)
    assert saved["phase"].dtype == np.uint64  # off the uint32 grid: all 62 bits
    assert torch.equal(state_from_jax(saved, "cpu")["phase"], later["phase"])


def test_on_the_grid_the_state_is_the_uint32_one():
    step = _step([62_500.0])  # a quarter of 250 kHz: the uint32 increment is exact
    state = step.init_state(12_345)
    saved = state_to_jax(state)
    assert saved["phase"].dtype == np.uint32
    assert int(saved["phase"][0]) == nco_increment_fixed(62_500.0, 250_000.0) * 12_345 % (1 << 32)
    assert torch.equal(state_from_jax(saved, "cpu")["phase"], state["phase"])


AM_CENTER = 145_000_000.0
#: 0.4 uint32 counts off the grid at 250 kHz: the uint32 increment alone
#: mixes 2.3e-5 Hz away, 0.29 mrad by the end of the 2 s capture
AM_OFFSET = 25_000.0
AM_SECONDS = 2.0


@pytest.fixture(scope="module")
def am_capture(tmp_path_factory):
    iq = make_am_iq(250_000.0, AM_SECONDS, AM_OFFSET)
    path = tmp_path_factory.mktemp("am") / f"baseband_{int(AM_CENTER)}Hz_am.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), 250_000, codec="pcm_f32le")
    return path, iq


def _am_dump_err(path, iq, tmp_path, channelizer, monkeypatch):
    """The channel samples an AM run dumps, against the float64 twin's mix
    at the exact offset, filter and decimation (``ref/chain.py``)."""
    monkeypatch.setenv("IQ2A_CHANNELIZER", channelizer)
    dump = tmp_path / "chan.cf32"
    cfg = ProcessingConfig(
        in_path=path, target_freq=AM_CENTER + AM_OFFSET, center_freq=AM_CENTER,
        demod_mode="am", bandwidth=12_500.0, output_path=tmp_path / "am.wav",
        dump_iq_path=dump, chunk_size=32_768, device="cpu",
    )
    result = ProcessingPipeline(cfg).run()
    got = np.fromfile(dump, dtype=np.complex64)
    taps = design_channel_filter(250_000.0, 12_500.0, result.decimation)
    mixed = RefOscillator(AM_OFFSET, 250_000.0).mix(iq.astype(np.complex128), result.mix_sign)
    want = RefOverlapSaveFIR(taps, 65_536).process(mixed)[:: result.decimation]
    k = min(got.size, want.size) - 8  # the twin's last outputs see zero-padded input
    return error_db(got[:k], want[:k])


@pytest.mark.parametrize("channelizer", ["conv", "fft", "native"])
def test_am_channel_follows_the_exact_mix(am_capture, tmp_path, monkeypatch, channelizer):
    """Every channelizer of the single-device pipeline mixes at the exact
    offset over the whole capture: the dumped channel within -100 dB of the
    float64 twin (it reads -127 to -134 dB), where the uint32 NCO alone
    reads -75.5 dB (next test)."""
    path, iq = am_capture
    assert _am_dump_err(path, iq, tmp_path, channelizer, monkeypatch) < -100.0


def test_without_the_residual_the_channel_drifts(am_capture, tmp_path, monkeypatch):
    path, iq = am_capture
    monkeypatch.setattr(
        "iq_to_audio_torch.pipeline.capture.nco_increment_residual", lambda *a, **k: 0
    )
    assert _am_dump_err(path, iq, tmp_path, "conv", monkeypatch) > -90.0
