"""The torch port's chunk step and pipeline against the JAX package and the
float64 twin, on the CPU at small sizes (250 kHz captures, a few chunks)."""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import error_db, make_nfm_iq

import iq_to_audio_tpu as jpkg
from iq_to_audio_tpu.demod.nfm import NFMDecoder as JNFMDecoder
from iq_to_audio_tpu.pipeline import step as jstep

import iq_to_audio_torch as tpkg
from iq_to_audio_torch.convert import state_from_jax, state_to_jax
from iq_to_audio_torch.demod import create_decoder
from iq_to_audio_torch.io.riff import parse_wav_header
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.ops.ddc import DDCPlan, bandpass_kernel, interleave_kernel
from iq_to_audio_torch.ops.nco import nco_increment_fixed
from iq_to_audio_torch.ops.resample import ResamplePlan, design_resampler_kernel
from iq_to_audio_torch.pipeline import pipeline as tpipeline
from iq_to_audio_torch.pipeline import step as tstep
from iq_to_audio_torch.pipeline.benchmark import run_benchmark
from iq_to_audio_torch.pipeline.filters import (
    compute_decimation,
    design_channel_filter,
    tune_chunk_size,
)
from iq_to_audio_torch.ref.chain import RefResampler, ref_demod_chain

torch.set_num_threads(1)

FS = 250_000.0
CENTER = 145_000_000.0
OFFSET = 25_000.0
REPO = Path(__file__).resolve().parents[1]


def _write_capture(tmp_path, iq, codec="pcm_s16le"):
    path = tmp_path / f"baseband_{int(CENTER)}Hz_cap.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(FS), codec=codec)
    return path


def _golden_audio(iq, mix_sign):
    decim, fs_ch = compute_decimation(FS, 96_000.0)
    taps = design_channel_filter(FS, 12_500.0, decim)
    audio_ch, _ = ref_demod_chain(
        iq.astype(np.complex128), sample_rate=FS, freq_offset=OFFSET, taps=taps,
        decimation=decim, mode="nfm", agc_enabled=True, mix_sign=mix_sign,
    )
    plan = ResamplePlan.create(fs_ch, 48_000.0, 1)
    return np.clip(RefResampler(plan.up, plan.down).resample_all(audio_ch), -0.99, 0.99)


def _geometry(offsets):
    decim, fs_ch = compute_decimation(FS, 96_000.0)
    taps = design_channel_filter(FS, 12_500.0, decim)
    rate = ResamplePlan.create(fs_ch, 48_000.0, 1)
    plan = DDCPlan.create(len(taps), decim, target_chunk=16_384, out_align=rate.down)
    rs_plan = ResamplePlan.create(fs_ch, 48_000.0, plan.out_size)
    incs = [nco_increment_fixed(o, FS) for o in offsets]
    return plan, rs_plan, fs_ch, bandpass_kernel(taps, incs), incs


def _jax_step(plan, rs_plan, fs_ch, kernel_np, incs, acc_chunks):
    decoder = JNFMDecoder(deemph_us=300.0)
    decoder.setup(fs_ch)
    rs_kernel = jnp.asarray(design_resampler_kernel(rs_plan.up, rs_plan.down))
    kernel_il = jnp.asarray(interleave_kernel(kernel_np, "iq"))
    incs_j = jnp.asarray(np.asarray(incs, np.uint32))

    def run(state, accs, raw, rs_offset, slot):
        return jstep.chunk_step_impl(
            state, accs, jnp.asarray(raw), jnp.int32(rs_offset), jnp.int32(slot), incs_j,
            kernel_il, rs_kernel, None, ddc_plan=plan, rs_plan=rs_plan, decoder=decoder,
            codec="pcm_s16le", iq_order="iq", pass_through=False, dump_iq=False,
            with_stages=False, num_channels=len(incs), acc_chunks=acc_chunks,
            channelizer="conv", j_lanes=1,
        )

    return run, decoder


def _torch_step(plan, rs_plan, fs_ch, kernel_np, incs):
    decoder = create_decoder("nfm", deemph_us=300.0, agc_enabled=True)
    decoder.setup(fs_ch)
    return tstep.build_chunk_step(
        ddc_plan=plan, rs_plan=rs_plan, ddc_kernel_np=kernel_np,
        rs_kernel_np=design_resampler_kernel(rs_plan.up, rs_plan.down), incs_fixed=incs,
        codec="pcm_s16le", iq_order="iq", decoder=decoder, device=torch.device("cpu"),
        est_total_chunks=4, channelizer="conv",
    )


def _jax_init_state(plan, rs_plan, incs, decoder, start_sample):
    c = len(incs)
    phase = (np.asarray(incs, np.uint64) * np.uint64(start_sample)) % np.uint64(1 << 32)
    return {
        "phase": jnp.asarray(phase.astype(np.uint32)),
        "fir_tail": jnp.zeros((2 * plan.overlap,), jnp.float32),
        "demod": decoder.init_state((c,)),
        "peak": jnp.zeros((c,), jnp.float32),
        "rs_tail": jnp.zeros((c, rs_plan.tail_len), jnp.float32),
    }


def _raw_chunks(plan, n_chunks, seed):
    iq = make_nfm_iq(FS, plan.chunk_size * n_chunks / FS, OFFSET, seed=seed)
    raw = np.empty(2 * iq.size, np.int16)
    raw[0::2] = np.round(np.clip(iq.real, -1, 1) * 32767)
    raw[1::2] = np.round(np.clip(iq.imag, -1, 1) * 32767)
    return raw.reshape(n_chunks, 2 * plan.chunk_size)


def test_state_round_trip_exact():
    plan, rs_plan, fs_ch, kernel_np, incs = _geometry((OFFSET, -60_000.0))
    run, decoder = _jax_step(plan, rs_plan, fs_ch, kernel_np, incs, acc_chunks=1)
    state = _jax_init_state(plan, rs_plan, incs, decoder, start_sample=987_654_321)
    accs = {"audio": jnp.zeros((2, rs_plan.out_capacity), jnp.int16)}
    state, _, _ = run(state, accs, _raw_chunks(plan, 1, seed=3)[0], rs_plan.chunk_offset(0), 0)
    np_state = jax.tree_util.tree_map(np.asarray, state)
    back = state_to_jax(state_from_jax(np_state, "cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(np_state)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(np_state)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert state_from_jax(np_state, "cpu")["phase"].dtype == torch.int64


@pytest.mark.parametrize("offsets", [(OFFSET,), (OFFSET, -60_000.0)])
def test_chunk_step_matches_jax(offsets):
    """Four chunks from the same mid-stream state: s16 audio within 1 LSB,
    float state within -100 dB, NCO phase exact."""
    plan, rs_plan, fs_ch, kernel_np, incs = _geometry(offsets)
    run, decoder = _jax_step(plan, rs_plan, fs_ch, kernel_np, incs, acc_chunks=4)
    step = _torch_step(plan, rs_plan, fs_ch, kernel_np, incs)
    assert step.acc_chunks == 4
    jstate = _jax_init_state(plan, rs_plan, incs, decoder, start_sample=12_345)
    jaccs = {"audio": jnp.zeros((len(incs), 4 * rs_plan.out_capacity), jnp.int16)}
    # warm the JAX stream for one chunk, then start both from its state
    warm = _raw_chunks(plan, 1, seed=9)[0]
    jstate, _, _ = run(jstate, jaccs, warm, rs_plan.chunk_offset(0), 0)
    tstate = state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    taccs = step.init_accs()
    rs_in = plan.out_size
    for slot, raw in enumerate(_raw_chunks(plan, 4, seed=4)):
        off = rs_plan.chunk_offset(rs_in)
        jstate, jaccs, _ = run(jstate, jaccs, raw, off, slot)
        tstate = step.fn(tstate, taccs, torch.from_numpy(raw), off, slot)
        rs_in += plan.out_size
    got, want = taccs["audio"].numpy().astype(np.int32), np.asarray(jaccs["audio"]).astype(np.int32)
    assert np.abs(got - want).max() <= 1
    assert np.abs(want).max() > 1000
    back = state_to_jax(tstate)
    np.testing.assert_array_equal(back["phase"], np.asarray(jstate["phase"]))
    for key in ("fir_tail", "rs_tail", "peak"):
        assert error_db(back[key], np.asarray(jstate[key])) < -100.0, key
    for key in ("prev_r", "prev_i", "deemph_y"):
        assert error_db(back["demod"][key], np.asarray(jstate["demod"][key])) < -100.0, key


def test_superstep_matches_single_chunks():
    plan, rs_plan, fs_ch, kernel_np, incs = _geometry((OFFSET,))
    step = _torch_step(plan, rs_plan, fs_ch, kernel_np, incs)
    raws = torch.from_numpy(_raw_chunks(plan, 4, seed=2))
    s1, a1 = step.init_state(), step.init_accs()
    for k in range(4):
        s1 = step.fn(s1, a1, raws[k], rs_plan.chunk_offset(0), k)
    s2, a2 = step.init_state(), step.init_accs()
    s2 = step.fn_super(s2, a2, raws, rs_plan.chunk_offset(0), 0)
    assert torch.equal(a1["audio"], a2["audio"])
    assert torch.equal(s1["phase"], s2["phase"])


def test_pipeline_matches_float64_twin(tmp_path):
    iq = make_nfm_iq(FS, 1.0, OFFSET)
    path = _write_capture(tmp_path, iq, codec="pcm_f32le")
    out = tmp_path / "audio_nfm.wav"
    cfg = tpkg.ProcessingConfig(
        in_path=path, target_freq=CENTER + OFFSET, output_path=out, device="cpu",
        chunk_size=65_536,
    )
    result = tpkg.ProcessingPipeline(cfg).run()
    assert result.dispatched_chunks >= 4
    got, rate = read_wav(out)
    got = got[:, 0]
    assert rate == 48_000
    ref = _golden_audio(iq, result.mix_sign)
    n = min(got.size, ref.size)
    assert abs(got.size - ref.size) <= 2
    assert error_db(got[:n], ref[:n]) < -60.0
    assert result.audio_peak > 0.01
    whole_rms_db = 20.0 * np.log10(np.sqrt(np.mean(got.astype(np.float64) ** 2)))
    assert abs(result.stats[0].rms_dbfs - whole_rms_db) < 0.1


def test_pipeline_matches_jax_wav(tmp_path, monkeypatch):
    monkeypatch.setenv("IQ2A_CHANNELIZER", "conv")
    iq = make_nfm_iq(FS, 0.6, OFFSET)
    path = _write_capture(tmp_path, iq)
    outs = []
    for pkg, extra in ((jpkg, {}), (tpkg, {"device": "cpu"})):
        out = tmp_path / f"audio_{pkg.__name__}.wav"
        cfg = pkg.ProcessingConfig(
            in_path=path, target_freq=CENTER + OFFSET, output_path=out, chunk_size=65_536,
            **extra,
        )
        pkg.ProcessingPipeline(cfg).run()
        outs.append(read_wav(out)[0][:, 0])
    assert outs[0].size == outs[1].size
    assert error_db(outs[1], outs[0]) < -80.0
    assert np.abs(outs[1] - outs[0]).max() <= 1.5 / 32768  # within 1 LSB


def test_chunk_size_invariance(tmp_path):
    iq = make_nfm_iq(FS, 0.8, OFFSET)
    path = _write_capture(tmp_path, iq)
    outputs = []
    for chunk in (65_536, 524_288):
        out = tmp_path / f"audio_{chunk}.wav"
        cfg = tpkg.ProcessingConfig(
            in_path=path, target_freq=CENTER + OFFSET, output_path=out, chunk_size=chunk,
            device="cpu",
        )
        tpkg.ProcessingPipeline(cfg).run()
        outputs.append(read_wav(out)[0][:, 0])
    n = min(map(len, outputs))
    assert abs(len(outputs[0]) - len(outputs[1])) <= 1
    assert error_db(outputs[0][:n], outputs[1][:n]) < -70.0


def test_run_benchmark_on_cpu(tmp_path):
    results: dict = {}
    rc = run_benchmark(
        seconds=0.3, sample_rate=FS, freq_offset=OFFSET, center_freq=None, target_freq=None,
        base_kwargs={"device": "cpu", "chunk_size": 32_768}, warmup=False,
        results_out=results, workdir=tmp_path,
    )
    assert rc == 0
    assert results["dispatched_chunks"] >= 2
    audio, rate = read_wav(results["output_path"])
    assert rate == 48_000 and abs(audio.shape[0] - 0.3 * 48_000) <= 2
    assert -12.0 < results["audio_peak_dbfs"] < 0.0


def test_pipeline_input_windows(tmp_path):
    """Preview limit, a sample-precise input window, and probe-only."""
    path = _write_capture(tmp_path, make_nfm_iq(FS, 0.8, OFFSET))

    def run(**kw):
        out = tmp_path / "audio_window.wav"
        cfg = tpkg.ProcessingConfig(
            in_path=path, target_freq=CENTER + OFFSET, output_path=out, device="cpu",
            chunk_size=65_536, **kw,
        )
        return tpkg.ProcessingPipeline(cfg).run(), out

    result, out = run(max_input_seconds=0.3)
    assert result.input_samples == int(0.3 * FS)
    assert abs(read_wav(out)[0].shape[0] - 0.3 * 48_000) <= 2
    result, out = run(input_start_sample=50_000, input_num_samples=100_000)
    assert result.input_samples == 100_000
    assert abs(read_wav(out)[0].shape[0] - 100_000 / FS * 48_000) <= 2
    result, _ = run(probe_only=True)
    assert result.mix_sign in (1, -1) and result.audio_peak == 0.0


def _loop_chunk_size(requested=32_768):
    """The chunk the pipeline plans for a 250 kHz NFM run (``_run``'s
    geometry)."""
    decim, fs_ch = compute_decimation(FS, 96_000.0)
    taps = design_channel_filter(FS, 12_500.0, decim)
    rate = ResamplePlan.create(fs_ch, 48_000.0, 1)
    return DDCPlan.create(
        len(taps), decim, target_chunk=tune_chunk_size(FS, requested), out_align=rate.down,
        max_chunk=1 << 22,
    ).chunk_size


# capture length and budget in chunks; super_chunks the run should choose
UPLOAD_CASES = {
    "whole chunks": dict(chunks=4.0, budget=None, codec="pcm_s16le", super_chunks=1),
    "partial last chunk": dict(chunks=3.4, budget=None, codec="pcm_s16le", super_chunks=1),
    "budget mid-chunk": dict(chunks=5.0, budget=2.3, codec="pcm_s16le", super_chunks=1),
    "budget on a chunk's end": dict(chunks=5.0, budget=3.0, codec="pcm_s16le", super_chunks=1),
    "partial final super-group": dict(chunks=6.5, budget=None, codec="pcm_s16le", super_chunks=2),
    "raw cu8": dict(chunks=2.6, budget=None, codec="pcm_u8", super_chunks=1),
}


@pytest.mark.parametrize("case", list(UPLOAD_CASES))
def test_step_receives_the_capture_in_order_padded_with_raw_zero(
    tmp_path, monkeypatch, caplog, case
):
    """Every block after the first is read straight into its upload row:
    what the step receives, row after row, is the capture's raw frames in
    order, then the codec's raw zero (the tail of the last used row and
    every silent row of a partial final group), over three or more groups
    through the two-slot ring."""
    spec = UPLOAD_CASES[case]
    chunk = _loop_chunk_size()
    n = int(round(spec["chunks"] * chunk))
    iq = make_nfm_iq(FS, n / FS + 0.01, OFFSET)[:n]
    if spec["codec"] == "pcm_u8":
        raw = np.empty(2 * n, np.uint8)
        raw[0::2] = np.clip(np.round(iq.real * 127 + 128), 0, 255)
        raw[1::2] = np.clip(np.round(iq.imag * 127 + 128), 0, 255)
        path = tmp_path / "cap.cu8"
        raw.tofile(path)
        zero, extra = 128, dict(center_freq=CENTER, input_sample_rate=FS)
    else:
        path = _write_capture(tmp_path, iq)
        info = parse_wav_header(path)
        raw = np.fromfile(path, dtype="<i2", offset=info.data_offset)
        zero, extra = 0, {}
    assert raw.size == 2 * n
    budget = None if spec["budget"] is None else int(round(spec["budget"] * chunk))

    seen, steps = [], []
    build = tpipeline.build_chunk_step

    def recording_build(**kw):
        step = build(**kw)
        steps.append(step)
        fn, fn_super = step.fn, step.fn_super

        def one(state, accs, raw_dev, rs_offset, slot):
            seen.append(raw_dev.numpy().copy()[None])
            return fn(state, accs, raw_dev, rs_offset, slot)

        def group(state, accs, raw_dev, rs_offset, slot_base):
            seen.append(raw_dev.numpy().copy())
            return fn_super(state, accs, raw_dev, rs_offset, slot_base)

        # fn_super runs its rows through fn: wrap the one the loop calls
        if step.super_chunks > 1:
            step.fn_super = group
        else:
            step.fn = one
        return step

    monkeypatch.setattr(tpipeline, "build_chunk_step", recording_build)
    cfg = tpkg.ProcessingConfig(
        in_path=path, target_freq=CENTER + OFFSET, output_path=tmp_path / "a.wav",
        device="cpu", chunk_size=32_768,
        max_input_seconds=None if budget is None else budget / FS, **extra,
    )
    with caplog.at_level("INFO", logger=tpipeline.LOG.name):
        result = tpkg.ProcessingPipeline(cfg).run()
    (step,) = steps
    assert step.chunk_size == chunk and step.super_chunks == spec["super_chunks"]
    used = n if budget is None else budget
    assert result.input_samples == used
    assert len(seen) >= 3  # the ring's two slots are each filled again
    got = np.concatenate([g.reshape(-1) for g in seen])
    assert got.size == 2 * chunk * result.dispatched_chunks
    want = np.full(got.size, zero, raw.dtype)
    want[: 2 * used] = raw[: 2 * used]
    np.testing.assert_array_equal(got, want)
    if case == "partial final super-group":
        assert (seen[-1][-1] == zero).all()  # a silent row
    chunks = -(-used // chunk)
    groups = -(-chunks // step.super_chunks)
    assert len(seen) == groups and result.dispatched_chunks == groups * step.super_chunks
    # each budget here stops short of the capture's end, which the run reports
    assert ("due to preview limit" in caplog.text) == (budget is not None)


def test_a_group_that_finds_the_end_is_not_padded():
    """A capture that ends on a chunk's end leaves the next group's lead row
    with nothing to read: that row is left as it is (the group is dropped),
    while a later row of a live group is padded with the raw zero."""

    class Step:
        chunk_size, codec = 8, "pcm_u8"

    class Ended:
        def read_into(self, dest, max_frames=None):
            return 0

    loop = tpipeline._ChunkLoop(
        Step(), Ended(), np.zeros(16, np.uint8), None, 1, tracker=None, check_cancel=None
    )
    loop._first = None  # the warm-up's block went into an earlier group
    lead = np.full(16, 7, np.uint8)
    assert loop._fill(lead, lead=True) == 0 and loop._ended
    assert (lead == 7).all()
    row = np.full(16, 7, np.uint8)
    assert loop._fill(row) == 0
    assert (row == 128).all()


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    path = _write_capture(tmp_path, make_nfm_iq(FS, 0.1, OFFSET))
    cfg = tpkg.ProcessingConfig(in_path=path, target_freq=CENTER + OFFSET)
    assert cfg.device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.ProcessingPipeline(cfg).run()


@pytest.mark.parametrize(
    "field,value",
    [
        ("demod_mode", "none"),
        ("dump_iq_path", Path("chan.cf32")),
        ("plot_stages_path", Path("stages.png")),
        ("profile_dir", Path("trace")),
    ],
)
def test_unported_features_raise(tmp_path, field, value):
    """Pass-through, the IQ dump, stage plots and the profiler hook were
    refused with NotImplementedError before they were ported; each now
    runs and leaves its output (``tests/test_torch_pipeline_modes.py``
    holds the outputs against the JAX package's)."""
    path = _write_capture(tmp_path, make_nfm_iq(FS, 0.3, OFFSET))
    out = tmp_path / "out.wav"
    cfg = tpkg.ProcessingConfig(
        in_path=path, target_freq=CENTER + OFFSET, device="cpu", output_path=out,
        chunk_size=32_768,
    )
    setattr(cfg, field, tmp_path / value if isinstance(value, Path) else value)
    result = tpkg.ProcessingPipeline(cfg).run()
    assert result.dispatched_chunks >= 2
    frames, rate = read_wav(out)
    if field == "demod_mode":
        assert frames.shape[1] == 2 and rate == round(result.fs_channel)
    else:
        assert frames.shape[1] == 1 and rate == 48_000
    if field == "dump_iq_path":
        assert (tmp_path / value).stat().st_size == 8 * math.ceil(0.3 * FS / result.decimation)
    if field == "plot_stages_path":
        assert (tmp_path / value).stat().st_size > 10_000
    if field == "profile_dir":
        assert (tmp_path / value / "chunk_loop.trace.json").stat().st_size > 1_000
    assert not hasattr(tpipeline, "_unsupported")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import iq_to_audio_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'iq_to_audio_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'iq_to_audio_tpu'))]\n"
        "assert not bad, bad\n"
        "new = ['iq_to_audio_torch.demod.am', 'iq_to_audio_torch.demod.ssb',\n"
        "       'iq_to_audio_torch.pipeline.progress', 'iq_to_audio_torch.post.squelch',\n"
        "       'iq_to_audio_torch.post.docker_backend', 'iq_to_audio_torch.interactive.workers',\n"
        "       'iq_to_audio_torch.interactive.headless_qt', 'iq_to_audio_torch.interactive.app']\n"
        "missing = [k for k in new if k not in sys.modules]\n"
        "assert not missing, missing\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_interactive_workers_import_without_matplotlib():
    """``interactive._qt`` resolves the matplotlib canvas on first use: the
    workers, models, state and the headless pool import with matplotlib
    blocked, and only the window needs it."""
    code = (
        "import os, sys\n"
        "os.environ['IQ2A_QT'] = 'headless'\n"
        "sys.modules['matplotlib'] = None\n"
        "import iq_to_audio_torch.interactive.workers as w\n"
        "import iq_to_audio_torch.interactive.state, iq_to_audio_torch.interactive.models\n"
        "from iq_to_audio_torch.interactive._qt import QThreadPool\n"
        "assert w.PreviewWorker and w.AudioPostWorker and QThreadPool.globalInstance()\n"
        "try:\n"
        "    import iq_to_audio_torch.interactive.app\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('the window imported without matplotlib')\n"
        "assert not [k for k in sys.modules if k.startswith('matplotlib.')]\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
