"""Checkpoint/resume, progress and cancel in the port, on the CPU: an
interrupted run resumed from its checkpoint writes byte-identical audio to
an uninterrupted run; a cancelled run without checkpointing deletes its
partial output."""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from conftest import make_nfm_iq

import iq_to_audio_torch as tpkg
from iq_to_audio_torch import ProcessingCancelled, ProcessingConfig, ProcessingPipeline
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.pipeline.capture import channel_paths
from iq_to_audio_torch.pipeline.progress import ProgressSink

torch.set_num_threads(1)

FS = 250_000.0
CENTER = 145_000_000.0
TARGET = CENTER + 25_000.0


class _CancelAfter(ProgressSink):
    """Cancel once the ingest phase passes a sample threshold; records the
    phases and every advance."""

    def __init__(self, threshold):
        self.threshold = threshold
        self._cb = None
        self.seen = {}
        self.totals = {}

    def start(self, phases, *, overall_total):
        self.totals = {p.key: p.total for p in phases}

    def advance(self, phase, delta, *, overall_completed, overall_total):
        self.seen[phase.key] = self.seen.get(phase.key, 0.0) + delta
        if phase.key == "ingest" and self.seen["ingest"] >= self.threshold and self._cb:
            self._cb()

    def status(self, message):
        pass

    def close(self):
        pass

    def cancel(self):
        pass

    def set_cancel_callback(self, callback):
        self._cb = callback


@pytest.fixture
def capture(tmp_path):
    iq = make_nfm_iq(FS, 2.0, 25_000.0)
    path = tmp_path / f"baseband_{int(CENTER)}Hz_long.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(FS))
    return path


def _cfg(capture, out, **kw):
    base = dict(
        in_path=capture, target_freq=TARGET, output_path=out, chunk_size=32_768,
        mix_sign_override=1, device="cpu",
    )
    base.update(kw)
    return ProcessingConfig(**base)


@pytest.mark.parametrize(
    "extra",
    [
        {},
        {"demod_mode": "usb", "extra_target_freqs": [CENTER - 40_000.0]},
    ],
    ids=["nfm", "usb-agc-2ch"],
)
def test_resume_produces_identical_audio(tmp_path, capture, extra):
    ref_out = tmp_path / "ref.wav"
    ref_result = ProcessingPipeline(_cfg(capture, ref_out, **extra)).run()
    refs = [read_wav(p)[0] for p in ref_result.output_paths]

    out = tmp_path / "resumable.wav"
    with pytest.raises(ProcessingCancelled):
        ProcessingPipeline(_cfg(capture, out, checkpoint_secs=0.4, **extra)).run(
            _CancelAfter(FS * 1.2)
        )
    first = _cfg(capture, out, **extra)
    paths = channel_paths(first, [f for f in first.all_target_freqs()], out)
    ckpt = paths[0].with_name(paths[0].name + ".ckpt")
    assert ckpt.exists(), "checkpoint must survive cancellation"
    assert all(p.exists() for p in paths), "partial output kept when checkpointing"
    with ckpt.open("rb") as f:
        payload = pickle.load(f)

    def leaves(obj):
        if isinstance(obj, dict):
            for v in obj.values():
                yield from leaves(v)
        else:
            yield obj

    assert all(isinstance(v, np.ndarray) for v in leaves(payload["state"]))
    # the targets are off the uint32 grid: the NCO's phase goes out in all 62 bits
    assert payload["state"]["phase"].dtype == np.uint64
    assert 0 < payload["counters"]["processed_samples"] < 2 * FS

    result = ProcessingPipeline(_cfg(capture, out, checkpoint_secs=0.4, resume=True, **extra)).run()
    assert not ckpt.exists(), "checkpoint removed after the run completes"
    assert result.output_paths == paths
    for p, ref in zip(paths, refs):
        got, rate = read_wav(p)
        assert rate == 48_000 and got.shape == ref.shape
        np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    # the capture-level RMS covers the whole capture, not post-resume only
    for c, p in enumerate(paths):
        got = read_wav(p)[0][:, 0].astype(np.float64)
        whole_rms_db = 20.0 * np.log10(np.sqrt(np.mean(got**2)))
        assert abs(result.stats[c].rms_dbfs - whole_rms_db) < 0.1
    assert result.input_samples == int(2 * FS)


def test_resume_respects_input_window(tmp_path, capture):
    start, num = 93_750, 375_000
    window = dict(input_start_sample=start, input_num_samples=num)
    ref_out = tmp_path / "win_ref.wav"
    ProcessingPipeline(_cfg(capture, ref_out, **window)).run()
    ref, _ = read_wav(ref_out)
    out = tmp_path / "win_res.wav"
    with pytest.raises(ProcessingCancelled):
        ProcessingPipeline(_cfg(capture, out, checkpoint_secs=0.4, **window)).run(
            _CancelAfter(FS * 0.6)
        )
    assert (tmp_path / "win_res.wav.ckpt").exists()
    result = ProcessingPipeline(
        _cfg(capture, out, checkpoint_secs=0.4, resume=True, **window)
    ).run()
    got, _ = read_wav(out)
    assert got.shape == ref.shape, "resumed window overran the segment end"
    assert result.input_samples == num
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])


def test_resume_rejects_mismatched_config(tmp_path, capture):
    out = tmp_path / "a.wav"
    with pytest.raises(ProcessingCancelled):
        ProcessingPipeline(_cfg(capture, out, checkpoint_secs=0.2)).run(_CancelAfter(FS * 0.8))
    for bad in ({"bandwidth": 25_000.0}, {"deemph_us": 75.0}, {"demod_mode": "am"}):
        with pytest.raises(ValueError, match="does not match"):
            ProcessingPipeline(_cfg(capture, out, checkpoint_secs=0.2, resume=True, **bad)).run()
    # a checkpoint of another layout version is refused by name
    ckpt = tmp_path / "a.wav.ckpt"
    with ckpt.open("rb") as f:
        payload = pickle.load(f)
    payload["version"] = -1
    with ckpt.open("wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match="incompatible version"):
        ProcessingPipeline(_cfg(capture, out, checkpoint_secs=0.2, resume=True)).run()


def test_resume_rejects_different_input(tmp_path, capture):
    out = tmp_path / "b.wav"
    with pytest.raises(ProcessingCancelled):
        ProcessingPipeline(_cfg(capture, out, checkpoint_secs=0.2)).run(_CancelAfter(FS * 0.8))
    other = tmp_path / f"baseband_{int(CENTER)}Hz_other.wav"
    iq2 = make_nfm_iq(FS, 2.5, 25_000.0)
    write_stereo_wav(other, np.column_stack([iq2.real, iq2.imag]), int(FS))
    with pytest.raises(ValueError, match="does not match"):
        ProcessingPipeline(_cfg(other, out, checkpoint_secs=0.2, resume=True)).run()


@pytest.mark.parametrize("channels", [1, 2])
def test_cancel_deletes_partial_output(tmp_path, capture, channels):
    out = tmp_path / "cancelled.wav"
    extra = {"extra_target_freqs": [CENTER - 40_000.0]} if channels == 2 else {}
    sink = _CancelAfter(FS * 0.5)
    with pytest.raises(ProcessingCancelled):
        ProcessingPipeline(_cfg(capture, out, **extra)).run(sink)
    assert not list(tmp_path.glob("cancelled*")), "partial outputs deleted on cancel"
    assert not list(tmp_path.glob("*.ckpt"))
    assert 0.5 * FS <= sink.seen["ingest"] < 2 * FS


def test_cancel_method_and_progress_totals(tmp_path, capture):
    """``cancel()`` before the run stops it at the first check; a full run
    reports every phase to its total from the host counters."""
    pipe = ProcessingPipeline(_cfg(capture, tmp_path / "never.wav"))
    pipe.cancel()
    with pytest.raises(tpkg.ProcessingCancelled):
        pipe.run()
    assert not (tmp_path / "never.wav").exists()
    sink = _CancelAfter(float("inf"))
    ProcessingPipeline(_cfg(capture, tmp_path / "full.wav")).run(sink)
    assert sink.seen["ingest"] == sink.totals["ingest"] == 2 * FS
    assert sink.seen["channel"] == sink.seen["demod"]
    assert abs(sink.seen["channel"] - sink.totals["channel"]) <= 1
    # encode counts the audio of each chunk; the end-of-file resampler
    # flush (under one resampler block) comes after the loop
    audio = read_wav(tmp_path / "full.wav")[0]
    assert 0 <= audio.shape[0] - sink.seen["encode"] < 64
