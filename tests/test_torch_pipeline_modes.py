"""The port's pipeline in the modes beside plain audio (pass-through, IQ
dump, stage plots, the fft channelizer, the profiler hook, preview), on the
CPU on one small capture, against the JAX package's outputs."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from conftest import error_db, make_nfm_iq, make_tone_iq

import iq_to_audio_tpu as jpkg
import iq_to_audio_torch as tpkg
from iq_to_audio_torch.io.riff import parse_wav_header
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.pipeline.preview import run_preview

torch.set_num_threads(1)

FS = 250_000.0
CENTER = 145_000_000.0
OFFSET = 25_000.0


def _write_capture(tmp_path, iq, codec="pcm_s16le"):
    path = tmp_path / f"baseband_{int(CENTER)}Hz_cap.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(FS), codec=codec)
    return path


@pytest.fixture
def jax_nco(monkeypatch):
    """The port's NCO without its increment residual (``ops/nco.py``): the
    JAX package's uint32 NCO, so that the two packages mix alike.  The
    residual is held to the float64 reference in
    ``test_torch_ssb_reference.py``."""
    monkeypatch.setattr(
        "iq_to_audio_torch.pipeline.capture.nco_increment_residual", lambda *a, **k: 0
    )


def _run(pkg, path, out, **kw):
    extra = {"device": "cpu"} if pkg is tpkg else {}
    cfg = pkg.ProcessingConfig(
        in_path=path, target_freq=CENTER + OFFSET, output_path=out, chunk_size=32_768,
        mix_sign_override=1, **extra, **kw,
    )
    return pkg.ProcessingPipeline(cfg).run()


@pytest.mark.parametrize("channelizer", ["conv", "fft", ""])
def test_pass_through_slice_matches_jax(tmp_path, monkeypatch, jax_nco, channelizer):
    """``demod_mode="none"``: container and codec preserved, the frame count
    exact, the slice equal to the JAX package's within one s16 step."""
    monkeypatch.setenv("IQ2A_CHANNELIZER", channelizer)
    iq = make_tone_iq(FS, 0.5, OFFSET)
    path = _write_capture(tmp_path, iq)
    outs = {}
    for pkg in (jpkg, tpkg):
        out = tmp_path / f"slice_{pkg.__name__}.wav"
        result = _run(pkg, path, out, demod_mode="none")
        info = parse_wav_header(out)
        assert info.channels == 2 and info.codec == "pcm_s16le"
        assert info.sample_rate == round(result.fs_channel)
        assert info.num_frames == -(-iq.size // result.decimation)
        outs[pkg] = read_wav(out)[0]
    assert float(np.abs(outs[tpkg]).max()) > 0.3
    assert np.abs(outs[tpkg] - outs[jpkg]).max() <= 1.5 / 32768
    assert error_db(outs[tpkg], outs[jpkg]) < -80.0


def test_pass_through_default_name_and_no_checkpoint(tmp_path, caplog):
    iq = make_tone_iq(FS, 0.3, OFFSET)
    path = _write_capture(tmp_path, iq)
    cfg = tpkg.ProcessingConfig(
        in_path=path, target_freq=CENTER + OFFSET, demod_mode="none", device="cpu",
        chunk_size=32_768, checkpoint_secs=0.1,
    )
    with caplog.at_level("WARNING"):
        result = tpkg.ProcessingPipeline(cfg).run()
    assert result.output_paths == [tmp_path / f"slice_{int(CENTER + OFFSET)}.wav"]
    assert result.output_paths[0].exists() and result.stats == []
    assert "not supported in pass-through" in caplog.text
    assert not list(tmp_path.glob("*.ckpt"))


def test_raw_pass_through_keeps_codec(tmp_path):
    iq = make_tone_iq(FS, 0.3, OFFSET)
    raw = np.empty(2 * iq.size, np.float32)
    raw[0::2], raw[1::2] = iq.real, iq.imag
    path = tmp_path / "cap.cf32"
    raw.tofile(path)
    cfg = tpkg.ProcessingConfig(
        in_path=path, target_freq=CENTER + OFFSET, center_freq=CENTER, demod_mode="none",
        device="cpu", chunk_size=32_768, input_sample_rate=FS,
    )
    result = tpkg.ProcessingPipeline(cfg).run()
    out = tmp_path / f"slice_{int(CENTER + OFFSET)}.cf32"
    assert result.output_paths == [out]
    assert out.stat().st_size == 8 * (-(-iq.size // result.decimation))


def test_dump_iq_and_audio_match_jax(tmp_path, monkeypatch, jax_nco):
    monkeypatch.setenv("IQ2A_CHANNELIZER", "conv")
    iq = make_nfm_iq(FS, 0.6, OFFSET)
    path = _write_capture(tmp_path, iq)
    audio, dumps = {}, {}
    for pkg in (jpkg, tpkg):
        out = tmp_path / f"a_{pkg.__name__}.wav"
        dump = tmp_path / f"d_{pkg.__name__}.cf32"
        result = _run(pkg, path, out, dump_iq_path=dump)
        audio[pkg] = read_wav(out)[0][:, 0]
        dumps[pkg] = np.fromfile(dump, dtype=np.complex64)
        assert dumps[pkg].size == -(-iq.size // result.decimation)
    assert audio[tpkg].size == audio[jpkg].size
    assert error_db(audio[tpkg], audio[jpkg]) < -80.0
    assert np.abs(audio[tpkg] - audio[jpkg]).max() <= 1.5 / 32768  # within 1 LSB
    assert error_db(dumps[tpkg], dumps[jpkg]) < -100.0
    # the dump leaves the audio as a run without it writes it
    plain = tmp_path / "plain.wav"
    _run(tpkg, path, plain)
    assert plain.read_bytes() == (tmp_path / "a_iq_to_audio_torch.wav").read_bytes()


def test_dump_iq_two_targets_and_progress_phase(tmp_path):
    iq = make_nfm_iq(FS, 0.4, OFFSET) + 0.5 * make_nfm_iq(FS, 0.4, -60_000.0, seed=3)
    path = _write_capture(tmp_path, iq * 0.6)
    seen: dict[str, float] = {}

    class Sink(tpkg.pipeline.progress.NullProgressSink):
        def start(self, phases, *, overall_total):
            self.keys = [p.key for p in phases]

        def advance(self, phase, delta, *, overall_completed, overall_total):
            seen[phase.key] = seen.get(phase.key, 0.0) + delta

    sink = Sink()
    cfg = tpkg.ProcessingConfig(
        in_path=path, target_freq=CENTER + OFFSET, extra_target_freqs=[CENTER - 60_000.0],
        output_path=tmp_path / "a.wav", dump_iq_path=tmp_path / "d.cf32", device="cpu",
        chunk_size=32_768, mix_sign_override=1,
    )
    result = tpkg.ProcessingPipeline(cfg).run(progress_sink=sink)
    assert sink.keys == ["ingest", "channel", "demod", "dump_iq", "encode"]
    dec = -(-iq.size // result.decimation)
    assert seen["dump_iq"] == seen["channel"] and abs(seen["dump_iq"] - dec) <= 1
    for f in (CENTER + OFFSET, CENTER - 60_000.0):
        assert (tmp_path / f"d_{int(f)}.cf32").stat().st_size == 8 * dec
        assert (tmp_path / f"a_{int(f)}.wav").exists()


def test_dump_iq_identical_across_window_sizes(tmp_path):
    """Windows of 8, 2 and 1 chunks (deferred drains, and the drains of a
    checkpointed run): byte-identical dumps and audio."""
    iq = make_nfm_iq(FS, 2.1, OFFSET)
    path = _write_capture(tmp_path, iq)
    dumps, audio = [], []
    for label, kw in (("w8", {}), ("w2", {"checkpoint_secs": 0.53}), ("w1", {"checkpoint_secs": 0.27})):
        out, dump = tmp_path / f"a_{label}.wav", tmp_path / f"d_{label}.cf32"
        result = _run(tpkg, path, out, dump_iq_path=dump, **kw)
        assert result.dispatched_chunks >= 8
        dumps.append(dump.read_bytes())
        audio.append(out.read_bytes())
    assert dumps[0] == dumps[1] == dumps[2]
    assert audio[0] == audio[1] == audio[2]
    assert len(dumps[0]) == 8 * (-(-iq.size // 3))  # decimation 3 at 250 kS/s


@pytest.mark.parametrize("targets", [1, 2])
def test_stage_plots_written(tmp_path, targets):
    pytest.importorskip("matplotlib")
    iq = make_nfm_iq(FS, 0.5, OFFSET)
    path = _write_capture(tmp_path, iq)
    out, plot = tmp_path / "a.wav", tmp_path / "stages.png"
    extra = [CENTER - 60_000.0] if targets == 2 else []
    result = _run(tpkg, path, out, plot_stages_path=plot, extra_target_freqs=extra)
    assert result.channelizer == "conv"  # snapshots come from the conv path only
    plots = [plot] if targets == 1 else [
        tmp_path / f"stages_{int(f)}.png" for f in (CENTER + OFFSET, CENTER - 60_000.0)
    ]
    for p in plots:
        assert p.exists() and p.stat().st_size > 10_000
    # the snapshot chunk changes nothing in the audio
    plain = tmp_path / "plain.wav"
    _run(tpkg, path, plain, extra_target_freqs=extra)
    first = tmp_path / f"a_{int(CENTER + OFFSET)}.wav" if targets == 2 else out
    plain_first = tmp_path / f"plain_{int(CENTER + OFFSET)}.wav" if targets == 2 else plain
    a, b = read_wav(first)[0][:, 0], read_wav(plain_first)[0][:, 0]
    assert a.size == b.size and np.abs(a - b).max() <= 1.5 / 32768


def test_fft_channelizer_matches_conv(tmp_path, monkeypatch):
    iq = make_nfm_iq(FS, 0.6, OFFSET)
    path = _write_capture(tmp_path, iq)
    outs = {}
    for label in ("conv", "fft"):
        monkeypatch.setenv("IQ2A_CHANNELIZER", label)
        out = tmp_path / f"ch_{label}.wav"
        result = _run(tpkg, path, out)
        assert result.channelizer == label
        outs[label] = read_wav(out)[0][:, 0].astype(np.float64)
    assert outs["conv"].shape == outs["fft"].shape
    assert error_db(outs["fft"], outs["conv"]) < -60.0
    monkeypatch.setenv("IQ2A_CHANNELIZER", "fft")
    jout = tmp_path / "ch_fft_jax.wav"
    _run(jpkg, path, jout)
    want = read_wav(jout)[0][:, 0]
    # the discriminator amplifies FFT rounding in the near-silent first samples
    assert error_db(outs["fft"], want) < -75.0
    assert np.abs(outs["fft"][2_000:] - want[2_000:]).max() <= 1.5 / 32768


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_cpu_default_is_native_then_fft(tmp_path, monkeypatch):
    monkeypatch.delenv("IQ2A_CHANNELIZER", raising=False)
    iq = make_nfm_iq(FS, 0.3, OFFSET)
    path = _write_capture(tmp_path, iq)
    native = _run(tpkg, path, tmp_path / "n.wav")
    assert native.channelizer == "native"
    monkeypatch.setenv("IQ2A_CHANNELIZER", "conv")
    conv = _run(tpkg, path, tmp_path / "c.wav")
    assert conv.channelizer == "conv"
    a, b = read_wav(tmp_path / "n.wav")[0][:, 0], read_wav(tmp_path / "c.wav")[0][:, 0]
    assert error_db(a, b) < -80.0
    monkeypatch.delenv("IQ2A_CHANNELIZER")
    from iq_to_audio_torch.ops import native_ddc

    monkeypatch.setattr(native_ddc, "available", lambda: False)
    assert _run(tpkg, path, tmp_path / "f.wav").channelizer == "fft"


def test_strict_filter_block_sets_the_fft_size(tmp_path, monkeypatch):
    monkeypatch.setenv("IQ2A_CHANNELIZER", "fft")
    from iq_to_audio_torch.pipeline import step as tstep

    seen = []
    real = tstep.build_chunk_step

    def spy(**kw):
        step = real(**kw)
        seen.append(step.os_plan.fft_size)
        return step

    monkeypatch.setattr(tpkg.pipeline.pipeline, "build_chunk_step", spy)
    iq = make_nfm_iq(FS, 0.3, OFFSET)
    path = _write_capture(tmp_path, iq)
    _run(tpkg, path, tmp_path / "auto.wav")
    _run(tpkg, path, tmp_path / "strict.wav", auto_filter_block=False, filter_block=16_384)
    assert seen[1] == 16_384 and seen[0] != 16_384
    a, b = read_wav(tmp_path / "auto.wav")[0][:, 0], read_wav(tmp_path / "strict.wav")[0][:, 0]
    assert error_db(a, b) < -60.0


def test_profile_dir_leaves_a_trace(tmp_path):
    iq = make_nfm_iq(FS, 0.3, OFFSET)
    path = _write_capture(tmp_path, iq)
    out = tmp_path / "a.wav"
    _run(tpkg, path, out, profile_dir=tmp_path / "trace")
    trace = tmp_path / "trace" / "chunk_loop.trace.json"
    assert trace.stat().st_size > 1_000
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) or "aten::" in str(e.get("name", "")) for e in events)
    plain = tmp_path / "plain.wav"
    _run(tpkg, path, plain)
    assert plain.read_bytes() == out.read_bytes()


def test_preview_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("IQ2A_CHANNELIZER", "conv")
    iq = make_nfm_iq(FS, 1.0, OFFSET)
    path = _write_capture(tmp_path, iq)
    from iq_to_audio_tpu.pipeline.preview import run_preview as j_run_preview

    got = {}
    for name, pkg, fn in (("jax", jpkg, j_run_preview), ("torch", tpkg, run_preview)):
        extra = {"device": "cpu"} if pkg is tpkg else {}
        cfg = pkg.ProcessingConfig(
            in_path=path, target_freq=CENTER + OFFSET, output_path=tmp_path / f"{name}.wav",
            chunk_size=32_768, mix_sign_override=1, **extra,
        )
        result, preview_path = fn(cfg, 0.25)
        assert preview_path == tmp_path / f"{name}_preview.wav"
        assert result.input_samples == int(0.25 * FS)
        got[name] = read_wav(preview_path)[0][:, 0]
        assert not (tmp_path / f"{name}.wav").exists()
    assert abs(got["torch"].size - 0.25 * 48_000) <= 2
    assert got["torch"].size == got["jax"].size
    assert np.abs(got["torch"] - got["jax"]).max() <= 1.5 / 32768
    with pytest.raises(ValueError):
        run_preview(cfg, 0.0)
