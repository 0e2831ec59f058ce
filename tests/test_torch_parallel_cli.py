"""The port's command line on the sharded paths (``--seq-parallel`` and
several ``--in`` over a mesh), with ``IQ2A_CPU_RANKS`` gloo CPU ranks."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import error_db, make_nfm_iq

from iq_to_audio_torch import cli as tcli
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav

torch.set_num_threads(1)


def _write_capture(tmp_path, seconds=1.6, name="cli", offset=25_000.0):
    fs = 2_500_000.0
    iq = make_nfm_iq(fs, seconds, offset)
    path = tmp_path / f"baseband_400000000Hz_{name}.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(fs), codec="pcm_s16le")
    return path


def _base(cap):
    return ["--cli", "--device", "cpu", "--in", str(cap), "--ft", "400025000",
            "--fc", "400000000", "--mix-sign", "1"]


class TestSeqParallelCLI:
    def test_cli_seq_parallel_matches_serial_flagship(self, tmp_path, monkeypatch, caplog):
        """Flagship geometry (2.5 MS/s, decimation 26, 1601 taps, 312/625)
        through the command line on two ranks: ``--seq-parallel on`` equals
        ``--seq-parallel off`` at -55 dB with the same length."""
        monkeypatch.setenv("IQ2A_CPU_RANKS", "2")
        cap = _write_capture(tmp_path)
        sp_out, serial_out = tmp_path / "sp.wav", tmp_path / "serial.wav"
        with caplog.at_level("INFO", logger="iq_to_audio_torch"):
            assert tcli.main(_base(cap) + ["--seq-parallel", "on", "--out", str(sp_out)]) == 0
        assert "sequence-parallel over 2 device(s)" in caplog.text
        assert tcli.main(_base(cap) + ["--seq-parallel", "off", "--out", str(serial_out)]) == 0
        a, sr_a = read_wav(serial_out)
        b, sr_b = read_wav(sp_out)
        assert sr_a == sr_b == 48_000
        assert abs(a.shape[0] - b.shape[0]) <= 1
        n = min(a.shape[0], b.shape[0])
        err = error_db(b[:n, 0].astype(np.float64), a[:n, 0].astype(np.float64))
        assert err < -55.0, f"seq-parallel vs serial: {err:.1f} dB"

    def test_cli_seq_parallel_default_output_naming(self, tmp_path, monkeypatch):
        """Without --out the sharded path writes the serial pipeline's
        default audio_<FT>_48k.wav beside the input."""
        monkeypatch.setenv("IQ2A_CPU_RANKS", "2")
        cap = _write_capture(tmp_path, seconds=0.8)
        assert tcli.main(_base(cap) + ["--seq-parallel", "on"]) == 0
        assert (tmp_path / "audio_400025000_48k.wav").exists()

    def test_cli_seq_parallel_on_rejects_ineligible_modes(self, tmp_path, monkeypatch):
        """--seq-parallel on with a mode the sharded step does not run
        fails fast instead of silently running serial."""
        monkeypatch.setenv("IQ2A_CPU_RANKS", "2")
        cap = _write_capture(tmp_path, seconds=0.4)
        assert tcli.main(_base(cap) + ["--seq-parallel", "on", "--demod", "none"]) == 1
        assert not list(tmp_path.glob("audio_*"))

    def test_cli_seq_parallel_off_stays_serial(self, tmp_path, monkeypatch):
        """--seq-parallel off never touches the sharded runner, with a full
        mesh of ranks available."""
        monkeypatch.setenv("IQ2A_CPU_RANKS", "8")

        def _boom(*a, **k):
            raise AssertionError("sharded runner must not be invoked")

        monkeypatch.setattr("iq_to_audio_torch.parallel.dp_runner.run_captures_dp", _boom)
        cap = _write_capture(tmp_path, seconds=0.4)
        out = tmp_path / "off.wav"
        assert tcli.main(_base(cap) + ["--seq-parallel", "off", "--out", str(out)]) == 0
        assert out.exists()

    def test_cli_seq_parallel_auto_needs_two_devices(self, tmp_path, monkeypatch):
        """auto shards only when the device count is at least two."""
        calls = []
        monkeypatch.setattr("iq_to_audio_torch.parallel.dp_runner.run_captures_dp",
                            lambda *a, **k: calls.append(k) or pytest.fail("sharded"))
        cap = _write_capture(tmp_path, seconds=0.4)
        monkeypatch.setenv("IQ2A_CPU_RANKS", "1")
        assert tcli.main(_base(cap) + ["--seq-parallel", "auto",
                                       "--out", str(tmp_path / "one.wav")]) == 0
        assert not calls


def test_two_captures_batch_over_the_mesh(tmp_path, monkeypatch, caplog):
    """Two ``--in`` on two ranks: one capture per ``dp`` row, tagged outputs
    (``<out>_<stem>.wav``) within -55 dB of the runs one after the other."""
    caps = [_write_capture(tmp_path, 0.8, "a", 25_000.0),
            _write_capture(tmp_path, 0.8, "b", 25_000.0 + 500.0)]
    argv = ["--cli", "--device", "cpu", "--in", str(caps[0]), "--in", str(caps[1]),
            "--ft", "400025000", "--fc", "400000000", "--mix-sign", "1"]
    monkeypatch.setenv("IQ2A_CPU_RANKS", "2")
    with caplog.at_level("INFO", logger="iq_to_audio_torch"):
        assert tcli.main(argv + ["--out", str(tmp_path / "dp.wav")]) == 0
    assert "sequentially" not in caplog.text
    monkeypatch.setenv("IQ2A_CPU_RANKS", "1")  # 1 % 2: one after the other
    assert tcli.main(argv + ["--out", str(tmp_path / "turn.wav")]) == 0
    stems = [c.stem for c in caps]
    assert sorted(p.name for p in tmp_path.glob("dp_*.wav")) == [f"dp_{s}.wav" for s in stems]
    for stem in stems:
        a, _ = read_wav(tmp_path / f"turn_{stem}.wav")
        b, _ = read_wav(tmp_path / f"dp_{stem}.wav")
        assert abs(a.shape[0] - b.shape[0]) <= 1
        n = min(a.shape[0], b.shape[0])
        assert error_db(b[:n, 0].astype(np.float64), a[:n, 0].astype(np.float64)) < -55.0
