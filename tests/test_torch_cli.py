"""The port's command line (``iq_to_audio_torch.cli.main``) on the CPU: the
modes that run, byte-identical with the API, the usage errors that exit 2,
and the front ends (GUI, ``--audio-post``, ``digital``) exiting as the JAX
command line does (their full tests: ``test_torch_post.py`` and
``test_torch_interactive.py``)."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import error_db, make_nfm_iq

import iq_to_audio_torch as tpkg
from iq_to_audio_tpu import cli as jcli
from iq_to_audio_torch import cli as tcli
from iq_to_audio_torch.io.riff import parse_wav_header
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav

torch.set_num_threads(1)

FS = 250_000.0
CENTER = 145_000_000.0
OFFSET = 25_000.0
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture()
def capture(tmp_path):
    iq = make_nfm_iq(FS, 0.6, OFFSET) + 0.5 * make_nfm_iq(FS, 0.6, -60_000.0, seed=5)
    path = tmp_path / f"baseband_{int(CENTER)}Hz_cap.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]) * 0.6, int(FS))
    return path


def _base(capture):
    return ["--cli", "--device", "cpu", "--in", str(capture), "--chunk", "32768"]


def test_parser_has_every_flag_of_the_jax_cli():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    jflags, tflags = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert jflags <= tflags
    assert tflags - jflags == {"--device"}
    args = tcli.build_parser().parse_args(["--in", "a.wav", "--ft", "1e6"])
    assert args.device == "cuda"


def test_run_matches_api_bytes(capture, tmp_path, capsys):
    out = tmp_path / "cli.wav"
    rc = tcli.main([*_base(capture), "--ft", str(CENTER + OFFSET), "--out", str(out)])
    assert rc == 0
    assert "Audio peak level" in capsys.readouterr().out
    api = tmp_path / "api.wav"
    cfg = tpkg.ProcessingConfig(
        in_path=capture, target_freq=CENTER + OFFSET, output_path=api, device="cpu",
        chunk_size=32_768,
    )
    tpkg.ProcessingPipeline(cfg).run()
    assert out.read_bytes() == api.read_bytes()


def test_module_entry_point_matches_api_bytes(capture, tmp_path):
    out = tmp_path / "mod.wav"
    proc = subprocess.run(
        [sys.executable, "-m", "iq_to_audio_torch", *_base(capture),
         "--ft", str(CENTER + OFFSET), "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    api = tmp_path / "api.wav"
    cfg = tpkg.ProcessingConfig(
        in_path=capture, target_freq=CENTER + OFFSET, output_path=api, device="cpu",
        chunk_size=32_768,
    )
    tpkg.ProcessingPipeline(cfg).run()
    assert out.read_bytes() == api.read_bytes()


def test_two_targets(capture, tmp_path):
    out = tmp_path / "multi.wav"
    f0, f1 = CENTER + OFFSET, CENTER - 60_000.0
    rc = tcli.main([*_base(capture), "--ft", str(f0), "--ft", str(f1), "--out", str(out),
                    "--mix-sign", "1"])
    assert rc == 0
    for f in (f0, f1):
        audio, rate = read_wav(tmp_path / f"multi_{int(f)}.wav")
        assert rate == 48_000 and abs(audio.shape[0] - 0.6 * 48_000) <= 2
        assert np.abs(audio).max() > 0.05


def test_demod_none(capture, tmp_path, capsys):
    out = tmp_path / "slice.wav"
    rc = tcli.main([*_base(capture), "--ft", str(CENTER + OFFSET), "--demod", "none",
                    "--out", str(out)])
    assert rc == 0
    assert "IQ slice peak magnitude" in capsys.readouterr().out
    info = parse_wav_header(out)
    assert info.channels == 2 and info.codec == "pcm_s16le"
    assert info.num_frames == -(-int(0.6 * FS) // 3)


def test_dump_iq_and_plot_stages(capture, tmp_path):
    pytest.importorskip("matplotlib")
    out, dump, plot = tmp_path / "a.wav", tmp_path / "d.cf32", tmp_path / "s.png"
    rc = tcli.main([*_base(capture), "--ft", str(CENTER + OFFSET), "--out", str(out),
                    "--dump-iq", str(dump), "--plot-stages", str(plot)])
    assert rc == 0
    assert dump.stat().st_size == 8 * (-(-int(0.6 * FS) // 3))
    assert plot.stat().st_size > 10_000


def test_probe_only(capture, capsys):
    rc = tcli.main([*_base(capture), "--ft", str(CENTER + OFFSET), "--probe-only"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Sample rate: 250000.00 Hz" in text and "mixer sign" in text
    assert not list(capture.parent.glob("audio_*"))


def test_spectrum_png(capture, tmp_path):
    pytest.importorskip("matplotlib")
    png = tmp_path / "spec.png"
    rc = tcli.main([*_base(capture), "--spectrum-png", str(png), "--spectrum-seconds", "0.5"])
    assert rc == 0 and png.stat().st_size > 10_000
    assert not list(capture.parent.glob("audio_*"))  # spectrum-only invocation


def test_preview(capture, tmp_path):
    out = tmp_path / "p.wav"
    rc = tcli.main([*_base(capture), "--ft", str(CENTER + OFFSET), "--out", str(out),
                    "--preview", "0.25"])
    assert rc == 0 and not out.exists()
    audio, _ = read_wav(tmp_path / "p_preview.wav")
    assert abs(audio.shape[0] - 0.25 * 48_000) <= 2


def test_checkpoint_flags_and_profile_dir(capture, tmp_path):
    out = tmp_path / "c.wav"
    rc = tcli.main([*_base(capture), "--ft", str(CENTER + OFFSET), "--out", str(out),
                    "--checkpoint-secs", "0.2", "--resume", "--profile-dir", str(tmp_path / "tr")])
    assert rc == 0 and out.exists()
    assert not Path(str(out) + ".ckpt").exists()  # the run completed
    assert (tmp_path / "tr" / "chunk_loop.trace.json").exists()


def test_benchmark(capsys):
    rc = tcli.main(["--benchmark", "--cli", "--device", "cpu", "--benchmark-seconds", "1",
                    "--benchmark-sample-rate", "250000"])
    assert rc == 0
    assert "x realtime" in capsys.readouterr().out
    rc = tcli.main(["--benchmark", "--device", "cpu", "--benchmark-seconds", "1",
                    "--benchmark-sample-rate", "250000", "--benchmark-channels", "2"])
    assert rc == 0


FRONT_ENDS = [
    ["--interactive", "--in", "x.wav"],
    ["--in", "x.wav", "--ft", "1e6"],
    ["--cli", "--audio-post", "some_dir"],
    ["--cli", "--audio-post", "d", "--audio-post-mode", "static", "--audio-post-overwrite"],
    ["digital", "--audio-dir", "some_dir"],
]


@pytest.mark.parametrize("argv", FRONT_ENDS)
def test_front_ends_exit_as_the_jax_cli(argv, caplog, tmp_path, monkeypatch):
    """The GUI (without ``IQ2A_QT=headless``), ``--audio-post`` on a missing
    path and ``digital`` on a missing directory: the JAX command line's exit
    status and error lines, and nothing written."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("IQ2A_QT", raising=False)
    seen = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        caplog.clear()
        rc = main([*extra, *argv])
        seen.append((rc, [r.getMessage() for r in caplog.records if r.levelname == "ERROR"]))
    assert seen[1] == seen[0]
    assert seen[1][0] == 1 and seen[1][1]
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize(
    "argv",
    [
        ["--cli", "--ft", "1e6"],  # no --in
        ["--cli", "--in", "x.wav"],  # no --ft
        ["--cli", "--in", "x.wav", "--ft", "1e6", "--ft", "1000000.2"],  # duplicate
        ["--cli", "--interactive"],
        ["--cli", "--in", "x.wav", "--ft", "1e6", "--input-format", "mp3"],
        ["--cli", "--in", "x.wav", "--ft", "-5"],
    ],
)
def test_usage_errors_exit_2(argv):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--device", "cpu", *argv])
    assert exc.value.code == 2


def test_seq_parallel_auto_runs_on_one_device(capture, tmp_path):
    out = tmp_path / "sp.wav"
    rc = tcli.main([*_base(capture), "--ft", str(CENTER + OFFSET), "--out", str(out),
                    "--seq-parallel", "auto", "--burst-segments", "1"])
    assert rc == 0 and out.exists()


@pytest.mark.parametrize("burst", [[], ["--burst-segments", "1"]], ids=["plain", "burst_1"])
def test_two_captures_in_turn(capture, tmp_path, monkeypatch, burst):
    """Two ``--in`` on one device (one rank cannot host two ``dp`` rows):
    one capture after the other through the serial pipeline, each WAV
    tagged with its capture's stem as the JAX package tags it
    (``<out>_<stem>.wav``) and byte-identical to a run of that capture
    alone."""
    monkeypatch.delenv("IQ2A_CPU_RANKS", raising=False)
    second = tmp_path / "other" / capture.name.replace("_cap", "_two")
    second.parent.mkdir()
    iq = make_nfm_iq(FS, 0.6, -OFFSET, seed=9)
    write_stereo_wav(second, np.column_stack([iq.real, iq.imag]) * 0.6, int(FS))
    ft = ["--ft", str(CENTER + OFFSET), "--mix-sign", "1"]
    out = tmp_path / "out.wav"
    rc = tcli.main(["--cli", "--device", "cpu", "--in", str(capture), "--in", str(second),
                    "--chunk", "32768", *ft, "--out", str(out), *burst])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.glob("out_*.wav")) == sorted(
        [f"out_{capture.stem}.wav", f"out_{second.stem}.wav"])
    for cap in (capture, second):
        alone = tmp_path / f"alone_{cap.stem}.wav"
        assert tcli.main([*_base(cap), *ft, "--out", str(alone)]) == 0
        assert (tmp_path / f"out_{cap.stem}.wav").read_bytes() == alone.read_bytes()


def test_seq_parallel_on_two_cpu_ranks(capture, tmp_path, monkeypatch):
    """``--seq-parallel on`` with two CPU ranks: exit 0, and the serial
    run's default naming (audio_<FT>_48k.wav beside the input)."""
    monkeypatch.setenv("IQ2A_CPU_RANKS", "2")
    rc = tcli.main([*_base(capture), "--ft", str(CENTER + OFFSET), "--seq-parallel", "on"])
    assert rc == 0
    assert (capture.parent / f"audio_{int(CENTER + OFFSET)}_48k.wav").exists()


def test_no_card_and_no_device_flag_fails(capture, tmp_path, caplog):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs on it")
    out = tmp_path / "never.wav"
    with caplog.at_level("ERROR"):
        rc = tcli.main(["--cli", "--in", str(capture), "--ft", str(CENTER + OFFSET),
                        "--out", str(out)])
    assert rc == 1 and not out.exists()
    assert "No CUDA device is available" in caplog.text
    rc = tcli.main(["--benchmark", "--cli", "--benchmark-seconds", "1",
                    "--benchmark-sample-rate", "250000"])
    assert rc == 1


@pytest.mark.parametrize("with_target", [False, True])
def test_spectrum_png_without_a_card_and_no_device_flag_fails(capture, tmp_path, caplog, with_target):
    """``--spectrum-png`` is an entry point like the run: at the default
    ``--device`` it asks for the card and never renders on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs on it")
    pytest.importorskip("matplotlib")
    png, out = tmp_path / "never.png", tmp_path / "never.wav"
    argv = ["--cli", "--in", str(capture), "--spectrum-png", str(png), "--spectrum-seconds", "0.5"]
    if with_target:
        argv += ["--ft", str(CENTER + OFFSET), "--out", str(out)]
    with caplog.at_level("ERROR"):
        rc = tcli.main(argv)
    assert rc == 1 and not png.exists() and not out.exists()
    assert "Spectrum rendering failed" in caplog.text
    assert "No CUDA device is available" in caplog.text


@pytest.fixture()
def long_capture(tmp_path):
    """3 s: long enough for a four-segment burst plan."""
    iq = make_nfm_iq(FS, 3.0, OFFSET)
    path = tmp_path / f"baseband_{int(CENTER)}Hz_long.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]) * 0.6, int(FS))
    return path


def test_burst_matches_plain_run(long_capture, tmp_path, caplog):
    """``--burst-segments 4 --burst-cpu-workers 1``: the capture is split
    between the device stream and one CPU worker, and the spliced WAV is
    within -60 dB of the same run without burst mode."""
    base = ["--cli", "--device", "cpu", "--in", str(long_capture), "--ft", str(CENTER + OFFSET),
            "--chunk", "65536", "--mix-sign", "1"]
    plain, burst = tmp_path / "plain.wav", tmp_path / "burst.wav"
    assert tcli.main([*base, "--out", str(plain)]) == 0
    with caplog.at_level("INFO", logger="iq_to_audio_torch.pipeline.hetero"):
        rc = tcli.main([*base, "--out", str(burst), "--burst-segments", "4",
                        "--burst-cpu-workers", "1"])
    assert rc == 0
    assert any("segment worker up (backend=cpu)" in r.message for r in caplog.records)
    assert any("segments (device" in r.message for r in caplog.records)  # not serial
    a, _ = read_wav(plain)
    b, _ = read_wav(burst)
    assert a.shape == b.shape
    assert error_db(b[:, 0], a[:, 0]) < -60.0


def test_burst_over_two_captures(long_capture, tmp_path):
    """Two ``--in`` with burst mode: one capture after the other, one WAV
    each, named with the capture's tag."""
    second = tmp_path / "other" / long_capture.name  # same stem: tags get an index
    second.parent.mkdir()
    second.write_bytes(long_capture.read_bytes())
    out = tmp_path / "out.wav"
    rc = tcli.main(["--cli", "--device", "cpu", "--in", str(long_capture), "--in", str(second),
                    "--ft", str(CENTER + OFFSET), "--chunk", "65536", "--out", str(out),
                    "--burst-segments", "4", "--burst-cpu-workers", "1"])
    assert rc == 0
    stem = long_capture.stem
    outs = sorted(p.name for p in tmp_path.glob("out_*.wav"))
    assert outs == [f"out_{stem}1.wav", f"out_{stem}2.wav"]
    a, _ = read_wav(tmp_path / outs[0])
    b, _ = read_wav(tmp_path / outs[1])
    assert a.shape == b.shape and abs(a.shape[0] - 3 * 48_000) <= 2
    assert error_db(b[:, 0], a[:, 0]) < -60.0


def test_burst_without_a_card_and_no_device_flag_fails(long_capture, tmp_path, caplog):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs on it")
    out = tmp_path / "never.wav"
    with caplog.at_level("ERROR"):
        rc = tcli.main(["--cli", "--in", str(long_capture), "--ft", str(CENTER + OFFSET),
                        "--out", str(out), "--burst-segments", "4"])
    assert rc == 1 and not out.exists()
    assert "No CUDA device is available" in caplog.text
