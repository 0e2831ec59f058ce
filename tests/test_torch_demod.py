"""The port's AM and USB/LSB demodulators (with the SSB feedback AGC)
against the JAX package's chunk step, the float64 twin and the JAX
package's WAVs, on the CPU at small sizes (250 kHz captures).

Tolerances: chunk steps within 1 s16 LSB of the JAX step with the AGC off
and within the bound stated below with it on; pipeline audio within -60 dB
of the float64 twin (SSB with the AGC off, as in the JAX package's golden
tests); WAVs within 1 LSB of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import error_db, make_am_iq, make_tone_iq

import iq_to_audio_tpu as jpkg
from iq_to_audio_tpu.demod import create_decoder as jcreate_decoder
from iq_to_audio_tpu.pipeline import step as jstep

import iq_to_audio_torch as tpkg
from iq_to_audio_torch.convert import state_from_jax, state_to_jax
from iq_to_audio_torch.demod import AMDecoder, SSBDecoder, create_decoder
from iq_to_audio_torch.demod.ssb import AGC_DECAY, AGC_TARGET_DBFS, DC_RADIUS
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.ops.ddc import DDCPlan, bandpass_kernel, interleave_kernel
from iq_to_audio_torch.ops.nco import nco_increment_fixed
from iq_to_audio_torch.ops.resample import ResamplePlan, design_resampler_kernel
from iq_to_audio_torch.pipeline import step as tstep
from iq_to_audio_torch.pipeline.filters import compute_decimation, design_channel_filter
from iq_to_audio_torch.ref.chain import RefResampler, ref_demod_chain

torch.set_num_threads(1)

FS = 250_000.0
CENTER = 145_000_000.0
OFFSET = 25_000.0
#: With the AGC on, ``target/|x|`` amplifies the float32 rounding-order
#: difference between the two packages' DC blockers (-100 dB) and
#: channelizers near zero crossings of the audio, and the gain carries it
#: forward; fed the same AGC input, the two AGCs agree within -90 dB
#: (``test_torch_iir.py``).  Measured on these inputs (CPU, both packages):
#: chunk step at most 73 LSB apart and -78.0 dB over four chunks, its
#: carried gain -76.4 dB; the demodulator alone -61.5 dB by its third chunk
#: (a weak channel at a gain of 430); WAVs -61.7 dB.  Bounds: 128 LSB and
#: -70 dB for the chunk step and its state, -55 dB for the demodulator
#: alone and for the WAV.
AGC_LSB_BOUND = 128
AGC_STEP_DB = -70.0
AGC_DEMOD_DB = -55.0
AGC_WAV_DB = -55.0

SIGNALS = {
    "am": lambda seconds: make_am_iq(FS, seconds, OFFSET),
    "usb": lambda seconds: make_tone_iq(FS, seconds, OFFSET + 1_000.0),
    "lsb": lambda seconds: make_tone_iq(FS, seconds, OFFSET - 1_000.0),
}


def test_registry_matches_jax():
    for mode in ("nfm", "fm", "am", "usb", "ssb", "lsb", "USB"):
        got = create_decoder(mode, deemph_us=300.0, agc_enabled=True)
        want = jcreate_decoder(mode, deemph_us=300.0, agc_enabled=True)
        assert got.name == want.name
        assert getattr(got, "sideband", None) == getattr(want, "sideband", None)
    with pytest.raises(ValueError, match="Unsupported demod mode"):
        create_decoder("wfm", deemph_us=300.0, agc_enabled=True)
    with pytest.raises(ValueError, match="sideband"):
        SSBDecoder("dsb", agc_enabled=False)
    with pytest.raises(ValueError, match="radius"):
        AMDecoder(dc_radius=1.0)
    assert (AGC_TARGET_DBFS, AGC_DECAY, DC_RADIUS) == (-12.0, 0.001, 0.995)


def _geometry(offsets):
    decim, fs_ch = compute_decimation(FS, 96_000.0)
    taps = design_channel_filter(FS, 12_500.0, decim)
    rate = ResamplePlan.create(fs_ch, 48_000.0, 1)
    plan = DDCPlan.create(len(taps), decim, target_chunk=16_384, out_align=rate.down)
    rs_plan = ResamplePlan.create(fs_ch, 48_000.0, plan.out_size)
    incs = [nco_increment_fixed(o, FS) for o in offsets]
    return plan, rs_plan, fs_ch, bandpass_kernel(taps, incs), incs


def _raw_chunks(plan, iq, n_chunks):
    raw = np.empty(2 * n_chunks * plan.chunk_size, np.int16)
    iq = iq[: n_chunks * plan.chunk_size]
    raw[0::2] = np.round(np.clip(iq.real, -1, 1) * 32767)
    raw[1::2] = np.round(np.clip(iq.imag, -1, 1) * 32767)
    return raw.reshape(n_chunks, 2 * plan.chunk_size)


@pytest.mark.parametrize(
    "mode,agc", [("am", True), ("usb", False), ("lsb", False), ("usb", True)]
)
def test_chunk_step_matches_jax(mode, agc):
    """Four chunks of two channels from the same mid-stream state."""
    offsets = (OFFSET, -60_000.0)
    plan, rs_plan, fs_ch, kernel_np, incs = _geometry(offsets)
    jdec = jcreate_decoder(mode, deemph_us=300.0, agc_enabled=agc)
    jdec.setup(fs_ch)
    rs_kernel = design_resampler_kernel(rs_plan.up, rs_plan.down)
    incs_j = jnp.asarray(np.asarray(incs, np.uint32))
    kil = jnp.asarray(interleave_kernel(kernel_np, "iq"))

    def jrun(state, accs, raw, off, slot):
        return jstep.chunk_step_impl(
            state, accs, jnp.asarray(raw), jnp.int32(off), jnp.int32(slot), incs_j, kil,
            jnp.asarray(rs_kernel), None, ddc_plan=plan, rs_plan=rs_plan, decoder=jdec,
            codec="pcm_s16le", iq_order="iq", pass_through=False, dump_iq=False,
            with_stages=False, num_channels=2, acc_chunks=4, channelizer="conv", j_lanes=1,
        )

    tdec = create_decoder(mode, deemph_us=300.0, agc_enabled=agc)
    tdec.setup(fs_ch)
    step = tstep.build_chunk_step(
        ddc_plan=plan, rs_plan=rs_plan, ddc_kernel_np=kernel_np, rs_kernel_np=rs_kernel,
        incs_fixed=incs, codec="pcm_s16le", iq_order="iq", decoder=tdec,
        device=torch.device("cpu"), est_total_chunks=4, channelizer="conv",
    )
    phase = (np.asarray(incs, np.uint64) * np.uint64(4_321)) % np.uint64(1 << 32)
    jstate = {
        "phase": jnp.asarray(phase.astype(np.uint32)),
        "fir_tail": jnp.zeros((2 * plan.overlap,), jnp.float32),
        "demod": jdec.init_state((2,)),
        "peak": jnp.zeros((2,), jnp.float32),
        "rs_tail": jnp.zeros((2, rs_plan.tail_len), jnp.float32),
    }
    jaccs = {"audio": jnp.zeros((2, 4 * rs_plan.out_capacity), jnp.int16)}
    raws = _raw_chunks(plan, SIGNALS[mode](6 * plan.chunk_size / FS), 5)
    # warm the JAX stream for one chunk, then start both from its state
    jstate, _, _ = jrun(jstate, jaccs, raws[0], rs_plan.chunk_offset(0), 0)
    tstate = state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    assert set(tstate["demod"]) == set(step.init_state()["demod"])
    taccs = step.init_accs()
    rs_in = plan.out_size
    for slot, raw in enumerate(raws[1:]):
        off = rs_plan.chunk_offset(rs_in)
        jstate, jaccs, _ = jrun(jstate, jaccs, raw, off, slot)
        tstate = step.fn(tstate, taccs, torch.from_numpy(raw), off, slot)
        rs_in += plan.out_size
    got = taccs["audio"].numpy().astype(np.int32)
    want = np.asarray(jaccs["audio"]).astype(np.int32)
    assert np.abs(want[0]).max() > 1000
    lsb = np.abs(got - want).max()
    if mode == "usb" and agc:
        assert lsb <= AGC_LSB_BOUND, lsb
        assert error_db(got, want) < AGC_STEP_DB
    else:
        assert lsb <= 1, lsb
    back = state_to_jax(tstate)
    np.testing.assert_array_equal(back["phase"], np.asarray(jstate["phase"]))
    state_db = AGC_STEP_DB if agc and mode == "usb" else -80.0
    for key, value in back["demod"].items():
        assert error_db(value, np.asarray(jstate["demod"][key])) < state_db, key


def _write_capture(tmp_path, iq, codec="pcm_f32le"):
    path = tmp_path / f"baseband_{int(CENTER)}Hz_cap.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(FS), codec=codec)
    return path


def _golden_audio(iq, mode, agc, mix_sign):
    decim, fs_ch = compute_decimation(FS, 96_000.0)
    taps = design_channel_filter(FS, 12_500.0, decim)
    audio_ch, _ = ref_demod_chain(
        iq.astype(np.complex128), sample_rate=FS, freq_offset=OFFSET, taps=taps,
        decimation=decim, mode=mode, agc_enabled=agc, mix_sign=mix_sign,
    )
    plan = ResamplePlan.create(fs_ch, 48_000.0, 1)
    return np.clip(RefResampler(plan.up, plan.down).resample_all(audio_ch), -0.99, 0.99)


@pytest.mark.parametrize("mode,agc", [("am", True), ("usb", False), ("lsb", False)])
def test_golden_modes(tmp_path, mode, agc):
    """Pipeline audio within -60 dB of the float64 twin (SSB with the AGC
    off: the AGC's ``target/|x|`` amplifies float32-vs-float64 differences
    near zero crossings)."""
    iq = SIGNALS[mode](1.0)
    path = _write_capture(tmp_path, iq)
    out = tmp_path / f"audio_{mode}.wav"
    cfg = tpkg.ProcessingConfig(
        in_path=path, target_freq=CENTER + OFFSET, demod_mode=mode, agc_enabled=agc,
        output_path=out, device="cpu", chunk_size=65_536,
    )
    result = tpkg.ProcessingPipeline(cfg).run()
    got, rate = read_wav(out)
    got = got[:, 0]
    assert rate == 48_000
    ref = _golden_audio(iq, mode, agc, result.mix_sign)
    n = min(got.size, ref.size)
    assert abs(got.size - ref.size) <= 2
    assert error_db(got[:n], ref[:n]) < -60.0
    assert result.audio_peak > 0.01
    assert float(np.sqrt(np.mean(got[4800:43200] ** 2))) > 0.005
    whole_rms_db = 20.0 * np.log10(np.sqrt(np.mean(got.astype(np.float64) ** 2)))
    assert abs(result.stats[0].rms_dbfs - whole_rms_db) < 0.1


def test_ssb_agc_tracks_target(tmp_path):
    """AGC on: quiet USB audio is pulled toward the -12 dBFS target, with
    the RMS of the second half within 5% of the float64 twin's."""
    iq = make_tone_iq(FS, 1.0, OFFSET + 1_000.0, amplitude=0.08, noise_std=0.002)
    path = _write_capture(tmp_path, iq)
    out = tmp_path / "agc.wav"
    cfg = tpkg.ProcessingConfig(
        in_path=path, target_freq=CENTER + OFFSET, demod_mode="usb", output_path=out,
        device="cpu", chunk_size=65_536,
    )
    result = tpkg.ProcessingPipeline(cfg).run()
    got = read_wav(out)[0][:, 0]
    ref = _golden_audio(iq, "usb", True, result.mix_sign)
    n = min(got.size, ref.size)
    rms_got = float(np.sqrt(np.mean(got[n // 2 : n] ** 2)))
    rms_ref = float(np.sqrt(np.mean(ref[n // 2 : n] ** 2)))
    assert abs(rms_got / rms_ref - 1.0) < 0.05
    assert rms_got > 0.1


@pytest.mark.parametrize("mode,agc", [("am", True), ("usb", False), ("usb", True)])
def test_pipeline_matches_jax_wav(tmp_path, monkeypatch, mode, agc):
    """The same s16 capture through both packages: WAVs within 1 LSB, or
    within ``AGC_WAV_DB`` with the SSB AGC on.  The port runs the JAX
    package's uint32 NCO here, without its increment residual
    (``ops/nco.py``), which ``test_torch_ssb_reference.py`` holds to the
    float64 reference."""
    monkeypatch.setenv("IQ2A_CHANNELIZER", "conv")
    monkeypatch.setattr(
        "iq_to_audio_torch.pipeline.capture.nco_increment_residual", lambda *a, **k: 0
    )
    path = _write_capture(tmp_path, SIGNALS[mode](0.6), codec="pcm_s16le")
    outs = []
    for pkg, extra in ((jpkg, {}), (tpkg, {"device": "cpu"})):
        out = tmp_path / f"audio_{pkg.__name__}.wav"
        cfg = pkg.ProcessingConfig(
            in_path=path, target_freq=CENTER + OFFSET, demod_mode=mode, agc_enabled=agc,
            output_path=out, chunk_size=65_536, mix_sign_override=1, **extra,
        )
        pkg.ProcessingPipeline(cfg).run()
        outs.append(read_wav(out)[0][:, 0])
    assert outs[0].size == outs[1].size
    assert np.abs(outs[0]).max() > 0.05
    if mode == "usb" and agc:
        assert error_db(outs[1], outs[0]) < AGC_WAV_DB
        return
    assert error_db(outs[1], outs[0]) < -80.0
    assert np.abs(outs[1] - outs[0]).max() <= 1.5 / 32768


@pytest.mark.parametrize("mode,agc", [("am", True), ("lsb", False), ("usb", True)])
def test_demod_process_matches_jax(mode, agc):
    """The demodulators alone, fed the same two-channel baseband for three
    chunks with their state carried: audio and state within -90 dB, or
    ``AGC_DEMOD_DB`` with the SSB AGC on."""
    rng = np.random.default_rng(31)
    m = 6_250
    t = np.arange(3 * m) / 96_153.8
    base = 0.3 * np.exp(2j * np.pi * 1_000.0 * t) * (1.0 + 0.5 * np.sin(2 * np.pi * 7.0 * t))
    noise = rng.normal(scale=0.01, size=(2, 3 * m)) + 1j * rng.normal(scale=0.01, size=(2, 3 * m))
    y = (base[None] * np.asarray([[1.0], [0.05]]) + noise).astype(np.complex64)
    jdec = jcreate_decoder(mode, deemph_us=300.0, agc_enabled=agc)
    tdec = create_decoder(mode, deemph_us=300.0, agc_enabled=agc)
    jstate = jdec.init_state((2,))
    tstate = tdec.init_state((2,), torch.device("cpu"))
    bound = AGC_DEMOD_DB if agc and mode == "usb" else -90.0
    for c in range(3):
        yr = np.ascontiguousarray(y[:, c * m : (c + 1) * m].real)
        yi = np.ascontiguousarray(y[:, c * m : (c + 1) * m].imag)
        ja, jstate, _ = jdec.process(jstate, jnp.asarray(yr), jnp.asarray(yi))
        ta, tstate, _ = tdec.process(tstate, torch.from_numpy(yr), torch.from_numpy(yi))
        assert error_db(ta.numpy(), np.asarray(ja)) < bound
    for key in jstate:
        assert error_db(tstate[key].numpy(), np.asarray(jstate[key])) < bound, key
