"""The port's multi-capture runner (``iq_to_audio_torch/parallel/dp_runner.py``)
and launcher on gloo CPU ranks: outputs against sequential runs, the JAX
package's chunk sizing, progress, cancel, a failing rank, and the ranks'
imports."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from conftest import error_db, make_nfm_iq

import torch_parallel_ranks as ranks
from iq_to_audio_tpu.io.writer import write_stereo_wav as j_write_stereo_wav
from iq_to_audio_torch import ProcessingConfig, ProcessingPipeline
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.parallel.dp_runner import CaptureJob, plan_captures, run_captures_dp
from iq_to_audio_torch.parallel.launch import RankFailed, run_world
from iq_to_audio_torch.pipeline.pipeline import ProcessingCancelled
from iq_to_audio_torch.pipeline.progress import ProgressSink

torch.set_num_threads(1)

CENTER = 145_000_000.0


def _write_capture(tmp_path, name, offset, audio_freq, fs=250_000.0, seconds=0.6):
    iq = make_nfm_iq(fs, seconds, offset, audio_freq=audio_freq, seed=sum(map(ord, name)) % 997)
    path = tmp_path / f"baseband_{int(CENTER)}Hz_{name}.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(fs), codec="pcm_s16le")
    return path


class TestMultiCaptureDP:
    def test_mismatched_output_paths_fail_fast(self, tmp_path):
        """3 targets with 2 explicit outputs raise up front, before any
        rank starts and any file is created."""
        p = _write_capture(tmp_path, "m", 25_000.0, 1_000.0)
        jobs = [CaptureJob(
            in_path=p,
            target_freqs=[CENTER + 25_000.0, CENTER - 30_000.0, CENTER + 40_000.0],
            output_paths=[tmp_path / "o1.wav", tmp_path / "o2.wav"],
        )]
        with pytest.raises(ValueError, match="output path"):
            run_captures_dp(jobs, world=1, device="cpu", mix_sign_override=1)
        assert not list(tmp_path.glob("o*.wav"))

    def test_two_captures_two_channels_match_sequential(self, tmp_path):
        """2 captures x 2 channels on dp 2 x seq 2 against the serial
        pipeline, capture by capture and channel by channel."""
        paths = [
            _write_capture(tmp_path, "a", 25_000.0, 1_000.0),
            _write_capture(tmp_path, "b", -30_000.0, 700.0),
        ]
        targets = [[CENTER + 25_000.0, CENTER - 30_000.0], [CENTER - 30_000.0, CENTER + 25_000.0]]
        jobs = [
            CaptureJob(in_path=p, target_freqs=t,
                       output_paths=[tmp_path / f"dp_{g}_{k}.wav" for k in range(2)])
            for g, (p, t) in enumerate(zip(paths, targets))
        ]
        res = run_captures_dp(jobs, world=4, device="cpu", mix_sign_override=1)
        assert res.num_captures == 2 and res.channels_per_capture == 2
        for g, (p, tfs) in enumerate(zip(paths, targets)):
            for k, tf in enumerate(tfs):
                out = tmp_path / f"seq_{g}_{k}.wav"
                ProcessingPipeline(ProcessingConfig(
                    in_path=p, target_freq=tf, output_path=out, mix_sign_override=1,
                    chunk_size=32_768, device="cpu",
                )).run()
                ref, sr = read_wav(out)
                got, sr2 = read_wav(tmp_path / f"dp_{g}_{k}.wav")
                assert sr == sr2 == 48_000
                assert abs(ref.shape[0] - got.shape[0]) <= 1
                n = min(ref.shape[0], got.shape[0])
                err = error_db(got[:n, 0].astype(np.float64), ref[:n, 0].astype(np.float64))
                assert err < -55.0, (g, k, err)


@pytest.mark.parametrize(
    "captures,seq,mode",
    [(2, 4, "nfm"), (2, 4, "usb"), (4, 2, "nfm")],  # the meshes of dryrun_multichip
)
def test_runner_chunk_sizing_matches_jax(tmp_path, monkeypatch, captures, seq, mode):
    """The planned chunk, decimation and resampler of the port's runner
    equal those the JAX package's ``run_captures_dp`` hands its sharded
    step, at the flagship rate on the meshes of ``dryrun_multichip``."""
    from iq_to_audio_tpu.parallel import dp_runner as jdp
    from iq_to_audio_tpu.parallel.mesh import make_mesh as j_make_mesh

    fs = 2_500_000.0
    paths = []
    for g in range(captures):
        iq = make_nfm_iq(fs, 0.02, 25_000.0, seed=g)
        path = tmp_path / f"baseband_{int(CENTER)}Hz_c{g}.wav"
        j_write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(fs), codec="pcm_s16le")
        paths.append(path)
    targets = [CENTER + 25_000.0, CENTER - 40_000.0]
    seen = {}

    class Planned(Exception):
        pass

    def record(mesh, **kw):
        seen.update(kw)
        raise Planned

    monkeypatch.setattr(jdp, "build_sharded_step", record)
    jjobs = [jdp.CaptureJob(in_path=p, target_freqs=targets) for p in paths]
    with pytest.raises(Planned):
        jdp.run_captures_dp(jjobs, demod_mode=mode, mix_sign_override=1,
                            mesh=j_make_mesh(captures * seq, dp=captures))
    jobs = [CaptureJob(in_path=p, target_freqs=targets) for p in paths]
    run = plan_captures(jobs, dp=captures, seq=seq, demod_mode=mode, mix_sign_override=1,
                        device="cpu")
    want_plan, want_rs = seen["ddc_plan"], seen["rs_plan"]
    assert (run.ddc_plan.num_taps, run.ddc_plan.decimation, run.ddc_plan.chunk_size) == (
        want_plan.num_taps, want_plan.decimation, want_plan.chunk_size)
    assert (run.rs_plan.up, run.rs_plan.down, run.rs_plan.in_size) == (
        want_rs.up, want_rs.down, want_rs.in_size)
    assert len(run.incs) == seen["num_channels"] == captures * len(targets)
    assert run.deemph_alpha == pytest.approx(seen["deemph_alpha"], rel=1e-12)


def _pc_job(tmp_path):
    # 384 kHz: decimation 4 and an exact 96k->48k resample keep the chunk
    # unit small, so target_chunk=1<<15 really yields several chunks
    path = _write_capture(tmp_path, "pc", 25_000.0, 1_000.0, fs=384_000.0, seconds=0.8)
    out = tmp_path / "pc_out.wav"
    return CaptureJob(in_path=path, target_freqs=[CENTER + 25_000.0], output_paths=[out]), out


class TestSeqParallelProgressCancel:
    def test_progress_phase_reported(self, tmp_path):
        events = {"phases": None, "advanced": 0.0, "closed": 0, "status": []}

        class RecordingSink(ProgressSink):
            def start(self, phases, *, overall_total):
                events["phases"] = [(p.key, p.total, p.unit) for p in phases]

            def advance(self, phase, delta, *, overall_completed, overall_total):
                events["advanced"] += delta

            def status(self, message):
                events["status"].append(message)

            def close(self):
                events["closed"] += 1

            def cancel(self):
                pass

        job, out = _pc_job(tmp_path)
        run_captures_dp([job], world=2, device="cpu", mix_sign_override=1,
                        target_chunk=1 << 15, progress_sink=RecordingSink())
        assert out.exists()
        (key, total, unit), = events["phases"]
        assert key == "chunks" and unit == "chunks"
        assert total > 1  # the small target_chunk forces several chunks
        assert events["advanced"] == total  # every chunk reported
        assert events["closed"] == 1  # close-exactly-once contract
        assert any("chunk" in s for s in events["status"])

    def test_cancel_removes_partial_outputs(self, tmp_path):
        """In-process (one rank) the cancel of the first chunk's report stops
        the run at the next chunk boundary."""
        job, out = _pc_job(tmp_path)
        sink = _CancellingSink(on="advance")
        with pytest.raises(ProcessingCancelled):
            run_captures_dp([job], world=1, device="cpu", mix_sign_override=1,
                            target_chunk=1 << 15, progress_sink=sink)
        assert not out.exists()  # partial output deleted
        assert sink.closed == 1 and sink.advanced == 1

    def test_cancel_stops_every_rank(self, tmp_path):
        """Two spawned ranks, cancel requested as the run starts: rank 0
        broadcasts it at the first chunk boundary, both stop, and the
        output is deleted."""
        job, out = _pc_job(tmp_path)
        sink = _CancellingSink(on="start")
        with pytest.raises(ProcessingCancelled):
            run_captures_dp([job], world=2, device="cpu", mix_sign_override=1,
                            target_chunk=1 << 15, progress_sink=sink)
        assert not out.exists()
        assert sink.closed == 1 and sink.advanced == 0


class _CancellingSink(ProgressSink):
    """Requests cancel from ``start`` or from the first ``advance``."""

    def __init__(self, on: str):
        self.on = on
        self._cb = None
        self.closed = 0
        self.advanced = 0

    def start(self, phases, *, overall_total):
        if self.on == "start" and self._cb:
            self._cb()

    def advance(self, phase, delta, *, overall_completed, overall_total):
        self.advanced += 1
        if self.on == "advance" and self._cb:
            self._cb()

    def status(self, message):
        pass

    def close(self):
        self.closed += 1

    def cancel(self):
        pass

    def set_cancel_callback(self, callback):
        self._cb = callback


def test_failing_rank_fails_the_run_within_its_timeout():
    t0 = time.perf_counter()
    with pytest.raises(RankFailed, match="rank 1 failed on purpose"):
        run_world(ranks.fail_on_rank_one, 2, "cpu", timeout=60.0)
    assert time.perf_counter() - t0 < 60.0


def test_ranks_import_no_jax():
    """A spawned rank that loads the port's multi-device slice and the
    command line holds no module of JAX or of the JAX package."""
    assert run_world(ranks.imported_modules, 2, "cpu", timeout=120.0) == [[], []]


def test_world_of_one_runs_in_process(tmp_path):
    """One rank: no process is spawned, the group is a real one-rank gloo
    group, and it is gone afterwards."""
    import torch.distributed as dist

    job, out = _pc_job(tmp_path)
    res = run_captures_dp([job], world=1, device="cpu", mix_sign_override=1,
                          target_chunk=1 << 15)
    assert out.exists() and res.frames_processed == int(0.8 * 384_000)
    assert not dist.is_initialized()
