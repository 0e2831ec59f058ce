"""The port's burst executor (:mod:`iq_to_audio_torch.pipeline.hetero`) and
its worker subprocess (:mod:`iq_to_audio_torch.pipeline.seg_worker`) on the
CPU: spliced output against the serial pipeline and against the JAX
package's executor, the worker protocol, the worker's device, lifecycle and
failures.  The scheduling cases are in ``test_torch_hetero_sched.py``.

The device stream runs with ``device="cpu"``; the workers run on the CPU
whatever the wired config says.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import error_db, make_nfm_iq

from iq_to_audio_torch import ProcessingConfig, ProcessingPipeline
from iq_to_audio_torch.io.riff import parse_wav_header
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.pipeline.hetero import HeteroExecutor, hetero_eligible, run_hetero
from iq_to_audio_torch.pipeline.pipeline import ProcessingCancelled
from iq_to_audio_torch.pipeline.progress import ProgressSink
from iq_to_audio_torch.pipeline.seg_worker import config_from_wire, config_to_wire

torch.set_num_threads(2)

FS = 250_000.0
CENTER = 145_000_000.0
OFFSET = 25_000.0
REPO = Path(__file__).resolve().parents[1]
#: keeps each worker process to two torch threads beside the other test files
CHILD_ENV = {"OMP_NUM_THREADS": "2"}


def _capture(tmp_path: Path, seconds: float = 4.0, codec: str = "pcm_s16le") -> Path:
    iq = make_nfm_iq(FS, seconds, OFFSET)
    cap = tmp_path / f"baseband_{int(CENTER)}Hz_cap.wav"
    write_stereo_wav(cap, np.column_stack([iq.real, iq.imag]), int(FS), codec=codec)
    return cap


def _config(cap: Path, out: Path, **kw) -> ProcessingConfig:
    kw.setdefault("device", "cpu")
    kw.setdefault("demod_mode", "nfm")
    return ProcessingConfig(
        in_path=cap, target_freq=CENTER + OFFSET, output_path=out, mix_sign_override=1,
        chunk_size=65_536, **kw,
    )


def _executor(**kw) -> HeteroExecutor:
    kw.setdefault("warm_seconds", 0.25)
    return HeteroExecutor(child_env=CHILD_ENV, **kw)


def _worker_env() -> dict:
    env = dict(os.environ, **CHILD_ENV)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env.pop("IQ2A_WORKER_PLATFORM", None)
    return env


def test_hetero_matches_serial(tmp_path):
    cap = _capture(tmp_path)
    serial_out = tmp_path / "serial.wav"
    ProcessingPipeline(_config(cap, serial_out)).run(None)
    het_out = tmp_path / "het.wav"
    with _executor(cpu_workers=1, n_segments=4) as ex:
        result = ex.run(_config(cap, het_out))
        stats = ex.last_stats
    assert stats["device_segments"] + stats["cpu_segments"] >= 3  # not a serial fallback
    assert stats["device"] == "cpu"
    a, sr_a = read_wav(serial_out)
    b, sr_b = read_wav(het_out)
    assert sr_a == sr_b == 48_000 and a.shape == b.shape
    err = error_db(b[:, 0], a[:, 0])
    assert err < -60.0, f"hetero-vs-serial error {err:.1f} dB"
    assert result.output_paths == [het_out]
    assert result.input_samples == int(FS * 4.0)
    assert result.mix_sign == 1


def test_hetero_matches_jax_executor(tmp_path):
    """The JAX package's executor and the port's on one capture and plan
    (n_segments=4, 0.25 s lead, one CPU worker each): both spliced WAVs
    within -60 dB of each other."""
    from iq_to_audio_tpu import ProcessingConfig as JConfig
    from iq_to_audio_tpu.pipeline.hetero import HeteroExecutor as JExecutor

    cap = _capture(tmp_path)
    j_out, t_out = tmp_path / "jax.wav", tmp_path / "torch.wav"
    jcfg = JConfig(in_path=cap, target_freq=CENTER + OFFSET, demod_mode="nfm",
                   output_path=j_out, mix_sign_override=1, chunk_size=65_536)
    with JExecutor(cpu_workers=1, n_segments=4, warm_seconds=0.25) as jex:
        jres = jex.run(jcfg)
    with _executor(cpu_workers=1, n_segments=4) as ex:
        tres = ex.run(_config(cap, t_out))
    a, _ = read_wav(j_out)
    b, _ = read_wav(t_out)
    assert a.shape == b.shape and a.shape[0] == int(4.0 * 48_000) + 1
    err = error_db(b[:, 0], a[:, 0])
    assert err < -60.0, f"port-vs-JAX burst error {err:.1f} dB"
    assert tres.input_samples == jres.input_samples
    assert tres.decimation == jres.decimation and tres.mix_sign == jres.mix_sign


def test_device_stream_alone_takes_one_claim(tmp_path):
    """``cpu_workers=0``: the device stream claims the whole plan in one run
    (one pipeline window, no lead-in) and writes the serial run's audio."""
    cap = _capture(tmp_path, seconds=3.0)
    serial_out = tmp_path / "serial.wav"
    ProcessingPipeline(_config(cap, serial_out)).run(None)
    out = tmp_path / "alone.wav"
    with _executor(cpu_workers=0, n_segments=4) as ex:
        ex.run(_config(cap, out))
        stats = ex.last_stats
        (plan,) = ex._plan_cache.values()
        assert not ex._procs
    assert stats["device_runs"] == 1 and stats["cpu_segments"] == 0
    assert stats["device_segments"] == len(plan.segments) >= 2
    assert not stats["device_abstained"]
    a, _ = read_wav(serial_out)
    b, _ = read_wav(out)
    assert a.shape == b.shape
    assert error_db(b[:, 0], a[:, 0]) < -100.0


def test_hetero_executor_reuse_and_auto_sign(tmp_path):
    """A second run on the same executor reuses the warm worker, and the
    mixer sign is resolved once by the host probe when not overridden."""
    cap = _capture(tmp_path, seconds=3.0)
    with _executor(cpu_workers=1, n_segments=3) as ex:
        out1 = tmp_path / "a.wav"
        cfg = _config(cap, out1)
        cfg.mix_sign_override = None
        r1 = ex.run(cfg)
        procs = list(ex._procs)
        out2 = tmp_path / "b.wav"
        ex.run(_config(cap, out2))
        assert ex._procs == procs
    assert r1.mix_sign in (1, -1)
    a, _ = read_wav(out1)
    b, _ = read_wav(out2)
    assert a.shape == b.shape
    assert error_db(b[:, 0], a[:, 0]) < -100.0


BASE = dict(in_path=Path("x.wav"), target_freq=1e6)


@pytest.mark.parametrize(
    "kw,eligible",
    [
        ({}, True),
        ({"demod_mode": "none"}, True),  # codec-preserving IQ slices
        ({"extra_target_freqs": [2e6]}, True),  # batched channels
        ({"probe_only": True}, False),
        ({"dump_iq_path": Path("d.cf32")}, False),
        ({"plot_stages_path": Path("p.png")}, False),
        ({"profile_dir": Path("trace")}, False),
        ({"checkpoint_secs": 5.0}, False),
        ({"resume": True}, False),
        ({"input_start_sample": 100}, False),
        ({"input_num_samples": 100}, False),
    ],
)
def test_hetero_eligible(kw, eligible):
    assert hetero_eligible(ProcessingConfig(**BASE, **kw)) is eligible


def test_hetero_short_capture_runs_serial(tmp_path):
    """A capture too short to segment runs the serial fallback (no worker
    is spawned with cpu_workers=0)."""
    cap = _capture(tmp_path, seconds=0.5)
    out = tmp_path / "short.wav"
    with _executor(cpu_workers=0, n_segments=8, warm_seconds=None) as ex:
        result = ex.run(_config(cap, out))
    assert result is not None
    audio, sr = read_wav(out)
    assert sr == 48_000 and abs(len(audio) - int(0.5 * 48_000)) <= 2


def test_run_hetero_wrapper(tmp_path):
    cap = _capture(tmp_path, seconds=2.0)
    out = tmp_path / "wrap.wav"
    result = run_hetero(_config(cap, out), cpu_workers=0, n_segments=2)
    assert out.exists() and result.audio_peak > 0


def test_run_on_the_default_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs on it")
    cap = _capture(tmp_path, seconds=2.0)
    out = tmp_path / "never.wav"
    with _executor(cpu_workers=1, n_segments=2) as ex:
        with pytest.raises(RuntimeError, match="No CUDA device"):
            ex.run(_config(cap, out, device=None))
        assert not ex._procs  # refused before a worker was spawned
    assert not out.exists()


@pytest.mark.parametrize("device", [None, "cuda", "cpu"])
def test_config_wire_round_trip(tmp_path, device):
    cfg = _config(tmp_path / "in.wav", tmp_path / "out.wav", device=device)
    cfg.dump_iq_path = tmp_path / "dump.cf32"
    cfg.profile_dir = tmp_path / "trace"
    cfg.extra_target_freqs = [1e6, 2e6]
    cfg.extra_output_paths = [tmp_path / "a.wav", None]
    cfg.fixed_device_geometry = True
    wire = json.loads(json.dumps(config_to_wire(cfg)))  # through real JSON
    assert wire["device"] == device
    assert set(wire) == {f.name for f in dataclasses.fields(cfg)}
    assert config_from_wire(wire) == cfg


def _spawn_worker(env=None, cmd=None):
    return subprocess.Popen(
        cmd or [sys.executable, "-m", "iq_to_audio_torch.pipeline.seg_worker"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env or _worker_env(), cwd=REPO,
    )


def _ask(proc, req) -> dict:
    proc.stdin.write(json.dumps(req) + "\n")
    proc.stdin.flush()
    return json.loads(proc.stdout.readline())


def test_seg_worker_subprocess_protocol(tmp_path):
    """The worker directly: handshake, one segment request, a failed
    request surfaced as an error reply, clean exit."""
    cap = _capture(tmp_path, seconds=1.0)
    out = tmp_path / "seg.wav"
    proc = _spawn_worker()
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready == {"ready": True, "backend": "cpu"}
        reply = _ask(proc, {"idx": 7, "config": config_to_wire(_config(cap, out))})
        assert reply["idx"] == 7 and reply["ok"], reply
        assert reply["samples"] == int(FS * 1.0) and out.exists()
        bad = _config(tmp_path / "missing.wav", tmp_path / "bad.wav")
        reply = _ask(proc, {"idx": 8, "config": config_to_wire(bad)})
        assert reply["idx"] == 8 and not reply["ok"] and "error" in reply
        proc.stdin.write(json.dumps({"cmd": "exit"}) + "\n")
        proc.stdin.flush()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=10)


def test_seg_worker_ignores_the_wired_device(tmp_path):
    """The wired config is the parent's: ``device=None`` (the card) or
    ``"cuda"`` on a run on the card.  The worker runs each on its own
    device, the CPU, and never opens the card."""
    cap = _capture(tmp_path, seconds=0.5)
    proc = _spawn_worker()
    try:
        assert json.loads(proc.stdout.readline())["backend"] == "cpu"
        for i, wired in enumerate([None, "cuda"]):
            out = tmp_path / f"w{i}.wav"
            reply = _ask(proc, {"idx": i, "config": config_to_wire(_config(cap, out, device=wired))})
            assert reply["ok"], reply
            assert reply["device"] == "cpu" and out.exists()
    finally:
        proc.stdin.close()
        assert proc.wait(timeout=30) == 0


def test_seg_worker_imports_no_jax(tmp_path):
    """The worker process, after serving a segment, holds no module of JAX
    or of the JAX package."""
    cap = _capture(tmp_path, seconds=0.5)
    probe = (
        "import json, sys\n"
        "from iq_to_audio_torch.pipeline import seg_worker\n"
        "rc = seg_worker.main()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'iq_to_audio_tpu'))\n"
        "print(json.dumps({'jax_modules': bad}), flush=True)\n"
        "sys.exit(rc)\n"
    )
    proc = _spawn_worker(cmd=[sys.executable, "-c", probe])
    try:
        assert json.loads(proc.stdout.readline())["ready"]
        reply = _ask(proc, {"idx": 0, "config": config_to_wire(_config(cap, tmp_path / "o.wav"))})
        assert reply["ok"], reply
        proc.stdin.write(json.dumps({"cmd": "exit"}) + "\n")
        proc.stdin.flush()
        assert json.loads(proc.stdout.readline()) == {"jax_modules": []}
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=10)


def test_worker_on_a_missing_card_fails_to_start(tmp_path):
    """``IQ2A_WORKER_PLATFORM=cuda`` without a card: no handshake, and the
    executor says the worker failed to start."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ex = HeteroExecutor(cpu_workers=1, child_env={**CHILD_ENV, "IQ2A_WORKER_PLATFORM": "cuda"})
    try:
        with pytest.raises(RuntimeError, match="failed to start"):
            ex._ensure_workers()
    finally:
        ex.close()


def test_hetero_worker_failure_surfaces(tmp_path, monkeypatch):
    """A crashed CPU worker turns into a parent-side error, not a hang."""
    cap = _capture(tmp_path, seconds=3.0)
    out = tmp_path / "fail.wav"
    ex = _executor(cpu_workers=1, n_segments=3)
    try:
        ex._ensure_workers()
        ex._procs[0].kill()
        ex._procs[0].wait(timeout=10)
        monkeypatch.setattr(ex, "_ensure_workers", lambda: None)
        with pytest.raises(RuntimeError):
            ex.run(_config(cap, out))
    finally:
        ex.close()
    assert not out.exists()


def test_hetero_recovers_after_failed_run(tmp_path, monkeypatch):
    """A failed run's stale threads must not poison the next run on the
    same executor."""
    cap = _capture(tmp_path, seconds=3.0)
    ex = _executor(cpu_workers=1, n_segments=3)
    try:
        ex._ensure_workers()
        ex._procs[0].kill()
        ex._procs[0].wait(timeout=10)
        monkeypatch.setattr(ex, "_ensure_workers", lambda: None)
        with pytest.raises(RuntimeError):
            ex.run(_config(cap, tmp_path / "f1.wav"))
        monkeypatch.undo()
        out = tmp_path / "f2.wav"
        result = ex.run(_config(cap, out))
    finally:
        ex.close()
    assert result is not None
    audio, sr = read_wav(out)
    assert sr == 48_000 and abs(len(audio) - 3 * 48_000) <= 2
    assert not ex._cancel.is_set()


def test_hetero_extra_output_dir_created(tmp_path):
    cap = _capture(tmp_path, seconds=3.0)
    out = tmp_path / "ch1.wav"
    extra_out = tmp_path / "newdir" / "ch2.wav"
    cfg = _config(cap, out, extra_target_freqs=[CENTER + OFFSET + 12_500.0],
                  extra_output_paths=[extra_out])
    with _executor(cpu_workers=1, n_segments=3) as ex:
        assert ex.run(cfg) is not None
    assert list(tmp_path.glob("ch1_*.wav")), list(tmp_path.iterdir())
    assert extra_out.exists()


def test_hetero_empty_capture_clean_error(tmp_path):
    cap = tmp_path / f"baseband_{int(CENTER)}Hz_empty.wav"
    write_stereo_wav(cap, np.zeros((0, 2), np.float32), int(FS))
    cfg = _config(cap, tmp_path / "e.wav", max_input_seconds=30.0)
    with _executor(cpu_workers=1, n_segments=3) as ex:
        with pytest.raises(ValueError, match="no samples"):
            ex.run(cfg)


def test_hetero_cancel_discards_output(tmp_path):
    """Cancelling after the first finished segment stops the run with
    ProcessingCancelled and writes no final output."""
    cap = _capture(tmp_path, seconds=8.0)
    out = tmp_path / "cancelled.wav"
    ex = _executor(cpu_workers=0, n_segments=4)

    class CancelOnFirstAdvance(ProgressSink):
        def __init__(self):
            self.fired = False

        def start(self, phases, *, overall_total):
            pass

        def advance(self, phase, delta, *, overall_completed, overall_total):
            if not self.fired:
                self.fired = True
                ex.cancel()

        def status(self, message):
            pass

        def close(self):
            pass

        def cancel(self):
            pass

        def set_cancel_callback(self, callback):
            pass

    try:
        with pytest.raises(ProcessingCancelled):
            ex.run(_config(cap, out), progress_sink=CancelOnFirstAdvance())
    finally:
        ex.close()
    assert not out.exists()


def test_hetero_multi_target_matches_serial(tmp_path):
    """Two targets through the executor: every channel's spliced output
    matches the serial batched run, with its _<freq> naming."""
    cap = _capture(tmp_path, seconds=4.0)
    extras = [CENTER + 10_000.0]
    serial_result = ProcessingPipeline(
        _config(cap, tmp_path / "serial_mc.wav", extra_target_freqs=list(extras))
    ).run(None)
    het_out = tmp_path / "het_mc.wav"
    with _executor(cpu_workers=1, n_segments=3) as ex:
        result = ex.run(_config(cap, het_out, extra_target_freqs=list(extras)))
    assert len(result.output_paths) == 2 and len(result.audio_peaks) == 2
    assert [p.name for p in result.output_paths] == [
        f"het_mc_{int(CENTER + OFFSET)}.wav", f"het_mc_{int(extras[0])}.wav",
    ]
    for sp, hp in zip(serial_result.output_paths, result.output_paths):
        a, _ = read_wav(sp)
        b, _ = read_wav(hp)
        assert a.shape == b.shape
        err = error_db(b[:, 0], a[:, 0])
        assert err < -60.0, f"channel {hp.name}: {err:.1f} dB"


@pytest.mark.parametrize("codec", ["pcm_f32le", "pcm_s16le"])
def test_hetero_pass_through_matches_serial(tmp_path, codec):
    """``demod_mode="none"`` through the executor: the spliced IQ slice
    keeps the capture's codec and matches the serial slice (s16 byte for
    byte; f32 far below -60 dB, the channelizer's blocks start elsewhere
    inside a segment window)."""
    cap = _capture(tmp_path, codec=codec)
    serial_out = tmp_path / f"serial_{codec}.wav"
    serial_result = ProcessingPipeline(_config(cap, serial_out, demod_mode="none")).run(None)
    het_out = tmp_path / f"het_{codec}.wav"
    with _executor(cpu_workers=1, n_segments=3) as ex:
        result = ex.run(_config(cap, het_out, demod_mode="none"))
    a, b = parse_wav_header(serial_out), parse_wav_header(het_out)
    assert a.data_size == b.data_size and a.sample_rate == b.sample_rate
    assert a.codec == b.codec == codec
    pa = serial_out.read_bytes()[a.data_offset : a.data_offset + a.data_size]
    pb = het_out.read_bytes()[b.data_offset : b.data_offset + b.data_size]
    if codec == "pcm_s16le":
        assert pa == pb
    else:
        xa = np.frombuffer(pa, dtype="<f4").astype(np.float64)
        xb = np.frombuffer(pb, dtype="<f4").astype(np.float64)
        assert error_db(xb, xa) < -100.0
    assert result.audio_peak == pytest.approx(serial_result.audio_peak, abs=2e-4)


def test_hetero_front_split_output_matches_serial(tmp_path):
    """The front-split plan (uneven segment lengths, fractional device
    claims) still splices to the serial pipeline's output at -60 dB."""
    cap = _capture(tmp_path)
    serial_out = tmp_path / "serial_fs.wav"
    ProcessingPipeline(_config(cap, serial_out)).run(None)
    het_out = tmp_path / "het_fs.wav"
    with _executor(cpu_workers=1, n_segments=4) as ex:
        ex.front_split = 4
        ex.run(_config(cap, het_out))
    a, _ = read_wav(serial_out)
    b, _ = read_wav(het_out)
    assert a.shape == b.shape
    err = error_db(b[:, 0], a[:, 0])
    assert err < -60.0, f"front-split hetero-vs-serial error {err:.1f} dB"


def test_warm_no_fetch(tmp_path):
    """A warm pass dispatches every chunk but copies nothing back: the
    pipeline's outputs hold no samples, and the executor's warm run returns
    None and splices nothing."""
    cap = _capture(tmp_path, seconds=2.0)
    full = ProcessingPipeline(_config(cap, tmp_path / "full.wav")).run(None)
    pipe = ProcessingPipeline(_config(cap, tmp_path / "warm.wav"))
    pipe.warm_no_fetch = True
    warm = pipe.run(None)
    assert warm.dispatched_chunks == full.dispatched_chunks > 0
    assert parse_wav_header(tmp_path / "warm.wav").data_size == 0
    out = tmp_path / "het_warm.wav"
    with _executor(cpu_workers=0, n_segments=2, warm_seconds=0.1) as ex:
        assert ex.run(_config(cap, out), device_warm_no_fetch=True) is None
        assert ex.last_stats["device_runs"] == 1
        assert ex._rates["device"] is None  # a warm pass seeds no rate
    assert not out.exists()
