"""The burst executor's scheduling on the CPU (port of the JAX package's
``tests/test_hetero.py`` scheduling cases): abstention, stale-rate
re-probes, the wire probe's go / no-go / defer / failure, fractional front
claims, the SSB+AGC cross-device gate, and the resident-compute probe.

Rates and probes are monkeypatched where a case needs them.  Where a case
needs the device stream on the card, the executor is told its device is
CUDA (``hetero.resolve_device``) while the stream's pipeline runs on the
CPU; the failure cases then show that a failure on the card is raised, not
hidden behind the CPU workers.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_nfm_iq

from iq_to_audio_torch import ProcessingConfig
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.pipeline import hetero as hetero_mod
from iq_to_audio_torch.pipeline.hetero import HeteroExecutor

torch.set_num_threads(2)

FS = 250_000.0
CENTER = 145_000_000.0
OFFSET = 25_000.0
CHILD_ENV = {"OMP_NUM_THREADS": "2"}


def _capture(tmp_path: Path, seconds: float = 4.0) -> Path:
    iq = make_nfm_iq(FS, seconds, OFFSET)
    cap = tmp_path / f"baseband_{int(CENTER)}Hz_cap.wav"
    write_stereo_wav(cap, np.column_stack([iq.real, iq.imag]), int(FS))
    return cap


def _config(cap: Path, out: Path, **kw) -> ProcessingConfig:
    kw.setdefault("demod_mode", "nfm")
    return ProcessingConfig(
        in_path=cap, target_freq=CENTER + OFFSET, output_path=out, mix_sign_override=1,
        chunk_size=65_536, device="cpu", **kw,
    )


def _executor(**kw) -> HeteroExecutor:
    kw.setdefault("warm_seconds", 0.25)
    return HeteroExecutor(cpu_workers=1, n_segments=4, child_env=CHILD_ENV, **kw)


def _assert_full_audio(out: Path, seconds: float = 4.0) -> None:
    audio, sr = read_wav(out)
    assert sr == 48_000 and abs(len(audio) - seconds * 48_000) <= 2


@pytest.fixture()
def on_card(monkeypatch):
    """The executor believes its device stream runs on the card (the
    stream's pipeline still runs on the CPU): the kernel load is a no-op
    and the compute prior is pinned."""
    monkeypatch.setattr(hetero_mod, "resolve_device", lambda _d: torch.device("cuda"))
    monkeypatch.setattr(hetero_mod, "_load_device_kernels", lambda _d: None)
    monkeypatch.setenv("IQ2A_DEVICE_MSPS", "100")


def _spy_device_claims(monkeypatch, record):
    """Record every device-stream claim (segment pipelines are built with
    output paths under the run's ``seg`` directory)."""
    real = hetero_mod.ProcessingPipeline

    class SpyPipeline(real):
        def __init__(self, cfg, *a, **k):
            if "/seg" in str(getattr(cfg, "output_path", "")):
                record(cfg)
            super().__init__(cfg, *a, **k)

    monkeypatch.setattr(hetero_mod, "ProcessingPipeline", SpyPipeline)


def test_device_abstains_when_pathological(tmp_path):
    """A device measured far slower than the CPU side draining the whole
    queue abstains; the CPU workers process every segment."""
    cap = _capture(tmp_path)
    out = tmp_path / "abstain.wav"
    with _executor() as ex:
        now = time.monotonic()
        ex._rates["device"] = (0.001, now)
        ex._rates["cpu"] = (20.0, now)
        ex.run(_config(cap, out))
        assert ex.last_stats["device_abstained"]
        assert ex.last_stats["device_segments"] == 0
        assert ex.last_stats["cpu_segments"] >= 3
    _assert_full_audio(out)


def test_stale_device_rate_reprobes(tmp_path):
    """The same pathological rate, older than the TTL, is discarded: the
    device takes at least one segment instead of abstaining at once."""
    cap = _capture(tmp_path)
    with _executor() as ex:
        ex.rate_ttl_seconds = 5.0
        now = time.monotonic()
        ex._rates["device"] = (0.001, now - 60.0)
        ex._rates["cpu"] = (20.0, now)
        assert ex.run(_config(cap, tmp_path / "reprobe.wav")) is not None
        assert ex.last_stats["device_segments"] >= 1


def test_wire_probe_abstains_without_claim(tmp_path, monkeypatch):
    """A catastrophic prediction (slower than realtime) abstains outright:
    no segment is committed to the device, even before any CPU rate."""
    cap = _capture(tmp_path)
    out = tmp_path / "probe_abstain.wav"
    probes = []
    with _executor() as ex:
        monkeypatch.setattr(ex, "_wire_probe_rate", lambda *a, **k: probes.append(a) or 0.05)
        ex.run(_config(cap, out))
        assert probes, "the wire probe runs when no device rate is known"
        assert ex.last_stats["device_abstained"]
        assert ex.last_stats["device_segments"] == 0
        assert ex.last_stats["cpu_segments"] >= 3
    _assert_full_audio(out)


def test_wire_probe_healthy_claims_one(tmp_path, monkeypatch):
    """A healthy prediction gates a one-segment claim whose measured rate
    replaces the estimate."""
    cap = _capture(tmp_path)
    with _executor() as ex:
        ex._rates["cpu"] = (2.0, time.monotonic())
        monkeypatch.setattr(ex, "_wire_probe_rate", lambda *a, **k: 50.0)
        assert ex.run(_config(cap, tmp_path / "probe_go.wav")) is not None
        assert ex.last_stats["device_segments"] >= 1
        assert not ex._device_rate_estimated
        assert ex._rates["device"] is not None and ex._rates["device"][0] != 50.0


def test_marginal_estimate_defers_to_cpu_measurement(tmp_path, monkeypatch):
    """A marginal prediction (1x-20x) with no CPU measurement claims nothing
    until the CPU side has a measured rate."""
    cap = _capture(tmp_path)
    out = tmp_path / "probe_defer.wav"
    blind: list[str] = []
    with _executor() as ex:
        _spy_device_claims(
            monkeypatch,
            lambda cfg: blind.append(str(cfg.output_path)) if ex._rates["cpu"] is None else None,
        )
        monkeypatch.setattr(ex, "_wire_probe_rate", lambda *a, **k: 1.5)
        assert ex.run(_config(cap, out)) is not None
    assert blind == []
    _assert_full_audio(out)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_wire_probe_failure(tmp_path, monkeypatch, request, device):
    """A wire probe that raises: on a CPU device the stream falls back to a
    one-segment probe claim; on the card it is a failed copy or kernel and
    fails the run (no CPU worker hides it)."""
    if device == "cuda":
        request.getfixturevalue("on_card")
    cap = _capture(tmp_path)
    out = tmp_path / "probe_fail.wav"

    def _boom(*a, **k):
        raise RuntimeError("probe failed")

    with _executor() as ex:
        monkeypatch.setattr(ex, "_wire_probe_rate", _boom)
        if device == "cuda":
            with pytest.raises(RuntimeError, match="probe failed"):
                ex.run(_config(cap, out))
            assert not out.exists()
            return
        assert ex.run(_config(cap, out)) is not None
        assert ex.last_stats["device_segments"] >= 1
    _assert_full_audio(out)


def test_kernel_build_failure_on_the_card_fails_the_run(tmp_path, monkeypatch):
    """A hand kernel that does not build fails the run on the card, even
    when the build fails only after the CPU worker drained the queue."""
    monkeypatch.setattr(hetero_mod, "resolve_device", lambda _d: torch.device("cuda"))
    monkeypatch.setenv("IQ2A_DEVICE_MSPS", "100")

    def _no_nvcc(name):
        time.sleep(4.0)  # the CPU worker finishes the 4 s capture meanwhile
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(hetero_mod._cuda_build, "load", _no_nvcc)
    cap = _capture(tmp_path)
    out = tmp_path / "nobuild.wav"
    with _executor() as ex:
        with pytest.raises(RuntimeError, match="nvcc failed for poly_fir.cu"):
            ex.run(_config(cap, out))
    assert not out.exists()


@pytest.mark.parametrize("policy,split", [("warn", True), ("pin", False)])
def test_ssb_agc_split_policy(tmp_path, monkeypatch, caplog, on_card, policy, split):
    """An SSB+AGC capture with the device stream on the card and a CPU
    worker: ``warn`` splits it with a WARNING, ``pin`` keeps it on the CPU
    workers (the device claims nothing)."""
    monkeypatch.setenv("IQ2A_SSB_AGC_SPLIT", policy)
    cap = _capture(tmp_path)
    out = tmp_path / f"ssb_{policy}.wav"
    with caplog.at_level(logging.INFO, logger="iq_to_audio_torch.pipeline.hetero"):
        with _executor() as ex:
            monkeypatch.setattr(ex, "_wire_probe_rate", lambda *a, **k: 50.0)
            assert ex.run(_config(cap, out, demod_mode="usb", agc_enabled=True)) is not None
            stats = ex.last_stats
    warned = any("SSB+AGC" in r.message and r.levelname == "WARNING" for r in caplog.records)
    assert warned is split
    if split:
        assert stats["device_segments"] >= 1
    else:
        assert stats["device_segments"] == 0 and stats["device_abstained"]
        assert stats["cpu_segments"] >= 3
        assert any("pinned" in r.message for r in caplog.records)
    _assert_full_audio(out)


def test_ssb_agc_on_one_device_does_not_warn(tmp_path, caplog):
    """Device stream and workers both on the CPU: one channelizer, no
    cross-device split to warn about."""
    cap = _capture(tmp_path, seconds=3.0)
    with caplog.at_level(logging.WARNING, logger="iq_to_audio_torch.pipeline.hetero"):
        with _executor() as ex:
            ex.run(_config(cap, tmp_path / "ssb_cpu.wav", demod_mode="usb", agc_enabled=True))
    assert not any("SSB+AGC" in r.message for r in caplog.records)


def test_nfm_split_does_not_warn(tmp_path, monkeypatch, caplog, on_card):
    """NFM splits agree across devices within 1 LSB of s16: no warning, and
    ``IQ2A_SSB_AGC_SPLIT=pin`` does not pin them."""
    monkeypatch.setenv("IQ2A_SSB_AGC_SPLIT", "pin")
    cap = _capture(tmp_path)
    with caplog.at_level(logging.WARNING, logger="iq_to_audio_torch.pipeline.hetero"):
        with _executor() as ex:
            monkeypatch.setattr(ex, "_wire_probe_rate", lambda *a, **k: 50.0)
            assert ex.run(_config(cap, tmp_path / "nfm_nowarn.wav")) is not None
            assert ex.last_stats["device_segments"] >= 1
    assert not any("SSB+AGC" in r.message for r in caplog.records)


def test_compute_prior_respects_env_pin(monkeypatch):
    """An explicit IQ2A_DEVICE_MSPS pins the prior: no measurement."""
    monkeypatch.setenv("IQ2A_DEVICE_MSPS", "7")
    ex = HeteroExecutor(cpu_workers=0)
    ex._device = torch.device("cuda")  # would measure on the card
    assert ex.device_compute_msps == 7.0
    ex._maybe_measure_compute(33, 4)
    assert ex._measured_msps is None and ex.device_compute_msps == 7.0


def test_default_prior(monkeypatch):
    monkeypatch.delenv("IQ2A_DEVICE_MSPS", raising=False)
    assert HeteroExecutor(cpu_workers=0).device_compute_msps == 100.0


def test_wire_probe_uses_measured_compute_rate(monkeypatch):
    """The prediction uses whatever rate the resident-compute measurement
    produced: a slow device (0.5 Msps) floors the predicted rate."""
    ex = HeteroExecutor(cpu_workers=0)
    ex._device = torch.device("cpu")

    def fake_measure(num_taps, decimation, should_abort=None):
        ex.device_compute_msps = 0.5

    monkeypatch.setattr(ex, "_maybe_measure_compute", fake_measure)
    rate = ex._wire_probe_rate(1.0, 4 * 10_000_000, 10_000_000, 96_000,
                               num_taps=1601, decimation=26)
    # the compute term alone is 10e6 / 0.5e6 = 20 s per 1 s of signal
    assert rate is not None and rate < 0.2
    assert set(ex.last_wire_probe) == {"bw_up", "bw_down", "t_fetch"}
    assert len(ex.wire_probe_log) == 1 and "t" in ex.wire_probe_log[0]


def test_resident_compute_measurement_runs(monkeypatch):
    """The real measurement (forced on the CPU with a small chunk) gives a
    positive rate, caches it and replaces the prior."""
    monkeypatch.delenv("IQ2A_DEVICE_MSPS", raising=False)
    monkeypatch.setenv("IQ2A_MEASURE_MSPS", "1")
    monkeypatch.setenv("IQ2A_MSPS_PROBE_CHUNK", "65536")
    ex = HeteroExecutor(cpu_workers=0)
    ex._device = torch.device("cpu")
    ex._maybe_measure_compute(33, 4)
    first = ex._measured_msps
    assert first is not None and ex.device_compute_msps == first
    assert first > 0
    ex._maybe_measure_compute(101, 8)  # one-off: the cached rate stays
    assert ex._measured_msps == first
    assert ex.measure_resident_compute(33, 4, device="cpu") == first


def test_reset_rates_forgets_measured_throughputs():
    """``reset_rates`` (the JAX package's ``HeteroExecutor.reset_rates``)
    drops both sides' rates, the slow-start claim floor and the estimate
    flag; the measured compute rate stays."""
    ex = HeteroExecutor(cpu_workers=0)
    now = time.monotonic()
    ex._rates["device"] = (12.0, now)
    ex._rates["cpu"] = (3.0, now)
    ex._device_take_secs = 0.5
    ex._device_rate_estimated = True
    ex._measured_msps = 123.0
    ex.reset_rates()
    assert ex._rates == {"device": None, "cpu": None}
    assert ex._device_take_secs == 0.0 and not ex._device_rate_estimated
    assert ex._measured_msps == 123.0


def test_resident_probes_keep_the_host_clock_off_the_card(monkeypatch):
    """On a CPU device neither resident probe captures a CUDA graph or
    opens the profiler: both time eager calls on the host clock."""
    from iq_to_audio_torch.pipeline.benchmark import measure_step_resident_msps
    from iq_to_audio_torch.utils import device_clock

    def _never(*a, **k):
        raise AssertionError("a CUDA-graph or profiler path ran on the CPU")

    monkeypatch.setattr(device_clock, "capture_graph", _never)
    monkeypatch.setattr(device_clock, "device_busy", _never)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _never)
    monkeypatch.setenv("IQ2A_MSPS_PROBE_CHUNK", "65536")
    ex = HeteroExecutor(cpu_workers=0)
    msps = ex._measure_compute_msps(33, 4, None, torch.device("cpu"), bench=True)
    probe = ex.last_compute_probe
    assert msps == probe["msps"] > 0 and probe["method"] == "host_clock"
    assert probe["calls"] == 2 and probe["device"] == "cpu"
    out = measure_step_resident_msps(250_000.0, target_chunk=65_536, device="cpu",
                                     graph_groups=2)
    assert out["method"] == "host_clock" and out["msps"] > 0 and out["calls"] == 2
    assert "busy_msps" not in out


@pytest.mark.parametrize("failure", ["capture", "warm_up"])
def test_resident_rate_names_its_fallback(monkeypatch, failure):
    """Work that runs but cannot be captured is timed by the profiler's
    device-busy time and says so (``"method": "profiler_busy"``); a failure
    of the work itself (a kernel that does not load) is raised, not
    reported as a capture failure.  The card is faked: only the dispatch
    of ``resident_rate`` is under test."""
    from iq_to_audio_torch.utils import device_clock

    def capture(*a, **k):
        if failure == "capture":
            raise device_clock.CaptureFailed("operation not permitted when stream is capturing")
        raise RuntimeError("poly_fir: the kernel library failed to load")

    monkeypatch.setattr(device_clock, "capture_graph", capture)
    monkeypatch.setattr(device_clock, "device_busy", lambda run, device, name="": (0.002, 0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    calls = []
    args = (calls.append, 1_000_000, torch.device("cuda"))
    if failure == "capture":
        out = device_clock.resident_rate(*args, calls=4, seconds_target=0.01)
        assert out["method"] == "profiler_busy" and out["msps"] == pytest.approx(2000.0)
    else:
        with pytest.raises(RuntimeError, match="failed to load"):
            device_clock.resident_rate(*args, calls=4, seconds_target=0.01)


@pytest.mark.parametrize("seen", [(None, 0), (0.002, 0)], ids=["no_device_time", "no_kernel"])
def test_unseen_replay_raises(monkeypatch, seen):
    """The busy bound comes from the profiled graph replay alone: a replay
    in which the profiler sees no device time, or not the named kernel, is
    an error, not a cue to profile the calls eagerly.  The card is faked."""
    from iq_to_audio_torch.utils import device_clock

    profiled = []

    def busy(run, device, name=""):
        profiled.append(run)
        return seen

    monkeypatch.setattr(device_clock, "capture_graph", lambda *a, **k: (object(), object()))
    monkeypatch.setattr(device_clock, "replay_seconds", lambda graph, stream, n: 0.001 * n)
    monkeypatch.setattr(device_clock, "device_busy", busy)
    with pytest.raises(RuntimeError, match="graph replay"):
        device_clock.resident_rate(lambda _i: None, 1_000_000, torch.device("cuda"), calls=4,
                                   seconds_target=0.01, kernel_name="poly_fir_kernel", busy=True)
    assert len(profiled) == 1


def test_measure_resident_compute_is_none_on_the_cpu(monkeypatch):
    monkeypatch.delenv("IQ2A_MEASURE_MSPS", raising=False)
    ex = HeteroExecutor(cpu_workers=0)
    assert ex.measure_resident_compute(1601, 26, device="cpu") is None
    assert ex._measured_msps is None


def test_measure_resident_compute_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs on it")
    with pytest.raises(RuntimeError, match="No CUDA device"):
        HeteroExecutor(cpu_workers=0).measure_resident_compute(1601, 26)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_resident_probe_failure(monkeypatch, device):
    """A failure inside the resident probe keeps the prior on a CPU device
    and is raised on the card (the card's own case, a kernel that fails to
    load, is in ``test_torch_cuda.py``)."""

    def _boom(*a, **k):
        raise RuntimeError("probe failed")

    monkeypatch.setattr(hetero_mod, "build_poly_kernel", _boom)
    ex = HeteroExecutor(cpu_workers=0)
    if device == "cpu":
        assert ex._measure_compute_msps(33, 4, None, torch.device("cpu")) is None
    else:
        with pytest.raises(RuntimeError, match="probe failed"):
            ex._measure_compute_msps(33, 4, None, torch.device("cuda"))


def test_slow_device_contributes_fractionally(tmp_path, monkeypatch):
    """A device whose share is below one full segment takes a fractional
    front claim (front_split) instead of abstaining."""
    cap = _capture(tmp_path)
    out = tmp_path / "fractional.wav"
    claims: list[int] = []
    with _executor(warm_seconds=0.1) as ex:
        assert ex.front_split >= 2
        _spy_device_claims(monkeypatch, lambda cfg: claims.append(int(cfg.input_num_samples)))
        now = time.monotonic()
        # device 1x realtime, CPU side 10x: a full 1 s segment costs the
        # device 1.0 s > 0.8 * (4 s / 10x); a 0.25 s front piece clears it
        ex._rates["device"] = (1.0, now)
        ex._rates["cpu"] = (10.0, now)
        ex.run(_config(cap, out))
        assert ex.last_stats["device_segments"] >= 1
    assert claims and claims[0] < int(FS * 1.0), claims
    _assert_full_audio(out)
