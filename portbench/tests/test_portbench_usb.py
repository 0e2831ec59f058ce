"""The SSB cell ``usb5.archive``: the reference's USB demodulator against a
per-sample loop of the upstream's DC blocker and AGC, its TF32 control, the
``ssb_voices`` capture, the readers ``ssb_ms.usb5``, ``chan_roofline.usb5``
and the archive readers the cell loads (``step_busy_ms.usb5``,
``device_idle.usb5``, ``enqueue_ms.usb5``), and a traced run of the cell on
the CPU."""

from __future__ import annotations

import copy
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import runner
from portbench.harness.spec import Bench
from portbench.harness.tracing import Trace
from portbench.reference import chain
from portbench.reference.modes import usb

ROOT = Path(__file__).resolve().parents[2]
CELL = "usb5.archive"
SEED = 2**31 + 17
MS = 1_000_000
H100 = "NVIDIA H100 80GB HBM3"
CHUNK = 4_192_500  # the card's chunk: m = 161,250 outputs


def upstream_loop(x: np.ndarray, agc: bool) -> np.ndarray:
    """``decoders/ssb.py``, one sample at a time, in float64."""
    target = 10.0 ** (-12.0 / 20.0)
    out = np.empty_like(x)
    x_prev = y_prev = 0.0
    g = 1.0
    for n, v in enumerate(x):
        y = v - x_prev + 0.995 * y_prev
        x_prev, y_prev = v, y
        if agc:
            mag = abs(y)
            if mag > 1e-6:
                g += 0.001 * (target / mag - g)
            y *= g
        out[n] = y
    return out


def baseband(n: int, seed: int) -> torch.Tensor:
    """Complex noise whose level swings over 40 dB, with a run of exact
    zeros (samples that hold the AGC's gain) and a DC offset."""
    rng = np.random.default_rng(seed)
    level = 10.0 ** (-2.0 * (1.0 + np.sin(2 * np.pi * np.arange(n) / 7_000.0)))
    z = (rng.normal(size=n) + 1j * rng.normal(size=n)) * level + 0.01
    z[5_000:5_300] = 0.0
    return torch.from_numpy(z)


@pytest.mark.parametrize("agc", [True, False], ids=["agc", "no_agc"])
def test_usb_is_the_per_sample_loop(agc):
    z = baseband(20_000, 5)
    got = usb.demod(z, 96_153.8, {"agc_enabled": agc}, "f64").numpy()
    want = upstream_loop(z.real.numpy(), agc)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_agc_blocks_carry_the_gain():
    """More blocks than one, and a length that is no multiple of the block."""
    y = torch.from_numpy(np.random.default_rng(2).normal(size=3 * usb.BLOCK + 17))
    gains, gain = [], 1.0
    for v in y.numpy():
        if abs(v) > 1e-6:
            gain += 0.001 * (10.0 ** (-0.6) / abs(v) - gain)
        gains.append(gain)
    np.testing.assert_allclose(usb.agc_gain(y).numpy(), gains, rtol=1e-10)


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


@pytest.fixture(scope="module")
def cfg(bench):
    return bench.cell(CELL).config


def test_the_control_differs_from_the_reference(bench, cfg):
    iq = bench.signal("ssb_voices").make(cfg, 0.06, SEED, "cpu").to(torch.complex128)
    off = bench.signal("ssb_voices").offsets(cfg)[2]
    codes = {
        prec: chain.encode_s16(chain.channel_audio(iq, 2.5e6, off, 1, cfg["pipeline"], prec))
        for prec in ("f64", "tf32")
    }
    gap = (codes["f64"] - codes["tf32"]).abs()
    assert codes["f64"].abs().max() > 10_000
    assert float(gap.mean()) > 10.0


def test_same_seed_same_capture(bench, cfg):
    sig = bench.signal("ssb_voices")
    a = sig.make(cfg, 0.02, SEED, "cpu")
    assert a.dtype == torch.complex64 and a.numel() == 50_000
    assert torch.equal(a, sig.make(cfg, 0.02, SEED, "cpu"))
    assert not torch.equal(a, sig.make(cfg, 0.02, SEED + 1, "cpu"))
    assert not torch.equal(a, sig.make(cfg, 0.02, 2**40 + 3, "cpu"))


def test_the_voice_is_analytic(bench):
    """The modulation puts more than 20 dB more power in its band above the
    carrier than in the mirror band below it (none, but rounding)."""
    fa = 25_000.0
    gen = torch.Generator().manual_seed(3)
    v = bench.signal("ssb_voices")._voice(gen, 50_000, fa, (300.0, 3000.0), "cpu").numpy()
    assert np.mean(np.abs(v) ** 2) == pytest.approx(1.0)
    spec = np.abs(np.fft.fft(v)) ** 2
    freqs = np.fft.fftfreq(v.size, 1.0 / fa)
    above = spec[(freqs >= 300) & (freqs <= 3_000)].sum()
    below = spec[(freqs <= -300) & (freqs >= -3_000)].sum()
    assert 10.0 * math.log10(above / max(below, 1e-300)) > 20.0


def test_voices_start_keyed_on_above_their_carriers(bench, cfg):
    """Over the first 50 ms (inside every voice's first span, which is on)
    each suppressed carrier has its voice above it, at 15-30 dB over the
    noise that alone fills the band below it."""
    sig = bench.signal("ssb_voices")
    x = sig.make(cfg, 0.05, SEED, "cpu").numpy().astype(np.complex128)
    spec = np.abs(np.fft.fft(x)) ** 2
    freqs = np.fft.fftfreq(x.size, 1.0 / cfg["sample_rate"])
    for off in sig.offsets(cfg):
        above = spec[(freqs > off + 300) & (freqs < off + 3_000)].sum()
        below = spec[(freqs < off - 300) & (freqs > off - 3_000)].sum()
        assert 10.0 * math.log10(above / below) > 10.0, off


def test_levels_over_the_noise_floor(bench, cfg):
    x = bench.signal("ssb_voices").make(cfg, 0.1, SEED, "cpu").numpy()
    rms = float(np.sqrt(np.mean(np.abs(x) ** 2)))
    assert 0.04 < rms < 0.2 and np.abs(x).max() < 1.0


# --- the readers --------------------------------------------------------------


def records(ssb: bool):
    """One job of two chunk steps of two chunks each; with ``ssb`` each step
    holds one ``iq2a.ssb`` per chunk, 0.5 ms each."""
    from iq_to_audio_torch.utils.spans import Record

    rows = []

    def add(name, start, end, parent=None, **counters):
        rows.append(Record(name, int(start * MS), int(end * MS), parent, 7, 1, counters))

    add("iq2a.job", 0, 100)
    add("iq2a.loop", 10, 90, 0)
    for t0 in (20, 50):
        step = len(rows)
        add("iq2a.step", t0, t0 + 3, 1, chunks=2)
        if ssb:
            add("iq2a.ssb", t0 + 0.5, t0 + 1.0, step)
            add("iq2a.ssb", t0 + 1.5, t0 + 2.0, step)
    return rows


def run_of(trace=None, jobs=(), config=None):
    return SimpleNamespace(trace=trace, jobs=list(jobs), window_s=2.0, config=config,
                           peaks=Bench(ROOT).peaks(), device_kind=H100)


def test_ssb_ms_on_hand_built_records(bench, monkeypatch):
    from iq_to_audio_torch.utils import spans

    rows = records(True)
    monkeypatch.setattr(spans, "records", lambda: list(rows))
    assert bench.metric("ssb_ms.usb5").read(run_of()) == pytest.approx(4 * 0.5 / 4)
    # the step's own time no longer holds the chain's: 3 - 1 ms a step
    assert bench.metric("enqueue_ms.archive").read(run_of()) == pytest.approx(2 * 2.0 / 4)


@pytest.mark.parametrize("nothing", ["no ssb span", "no records", "no spans module"])
def test_ssb_ms_reads_none_without_the_span(bench, monkeypatch, nothing):
    from iq_to_audio_torch.utils import spans

    if nothing == "no ssb span":
        rows = records(False)
        monkeypatch.setattr(spans, "records", lambda: list(rows))
        assert bench.metric("enqueue_ms.archive").read(run_of()) == pytest.approx(1.5)
    elif nothing == "no records":
        monkeypatch.setattr(spans, "records", lambda: [])
    else:
        monkeypatch.setitem(sys.modules, "iq_to_audio_torch.utils.spans", None)
    assert bench.metric("ssb_ms.usb5").read(run_of()) is None


def test_chan_roofline_usb5_is_the_archive_reader_at_k_275(bench, cfg):
    usb5, archive = bench.metric("chan_roofline.usb5"), bench.metric("chan_roofline.archive")
    assert archive.channel_geometry(cfg) == (26, 7143)
    nbytes, flops = archive.work(cfg, CHUNK, 5)
    assert flops == pytest.approx(8.0 * 7143 * 161_250 * 5)
    bound = max(nbytes / 3.35e12, flops / 495e12)
    assert bound * 1e3 == pytest.approx(0.0931, rel=1e-2)
    trace = Trace(window_s=1.0, busy_s=0.1, ops={"poly_fir_kernel<10>": [24, 24 * 0.5e-3]})
    jobs = [SimpleNamespace(input_samples=24 * CHUNK, offsets=[0.0] * 5)]
    run = run_of(trace, jobs, cfg)
    assert usb5.read(run) == archive.read(run) == pytest.approx(100 * bound / 0.5e-3, rel=1e-6)
    assert usb5.read(run_of(None, jobs, cfg)) is None
    renamed = Trace(window_s=1.0, busy_s=0.1, ops={"other_kernel": [24, 0.012]})
    assert usb5.read(run_of(renamed, jobs, cfg)) is None


@pytest.mark.parametrize("name", ["step_busy_ms", "device_idle", "enqueue_ms"])
def test_the_cells_step_and_device_readers_are_the_archive_ones(bench, monkeypatch, name):
    from iq_to_audio_torch.utils import spans

    rows = records(True)
    monkeypatch.setattr(spans, "records", lambda: list(rows))
    usb5, archive = bench.metric(f"{name}.usb5"), bench.metric(f"{name}.archive")
    trace = Trace(window_s=2.0, busy_s=0.5, ops={"poly_fir_kernel<10>": [4, 0.1]})
    jobs = [SimpleNamespace(dispatched_chunks=4, input_samples=4 * CHUNK, offsets=[0.0] * 5)]
    run = run_of(trace, jobs)
    want = {"step_busy_ms": 1e3 * 0.5 / 4, "device_idle": 75.0, "enqueue_ms": 2 * 2.0 / 4}[name]
    assert usb5.read(run) == archive.read(run) == pytest.approx(want)
    if name != "enqueue_ms":
        assert usb5.read(run_of(None, jobs)) is None


def test_a_traced_cpu_run_reports_ssb_ms(bench, conv_channelizer):
    """On the CPU the chain's span and the step's are read; the roofline has
    no device kernel to read, and no peaks for the CPU, so the line leaves
    it out."""
    from iq_to_audio_torch.utils import spans

    cell = bench.cell(CELL)
    assert {m["name"] for m in cell.per_layer} == {
        "ssb_ms.usb5", "chan_roofline.usb5", "step_busy_ms.usb5", "device_idle.usb5",
        "enqueue_ms.usb5",
    }
    assert {m["name"] for m in cell.end_to_end} == {"realtime_x", "setup_s"}
    spans.reset()
    try:
        result = runner.run_cell(bench, CELL, 2**31 + 43, 0.05, True, device="cpu", capture_seconds=0.6)
    finally:
        recs = spans.records()
        spans.reset()
    assert result["correct"], result["checks"]
    steps = [i for i, r in enumerate(recs) if r.name == "iq2a.step"]
    ssb = [r for r in recs if r.name == "iq2a.ssb"]
    assert ssb and all(r.parent in steps for r in ssb)
    assert len(ssb) == sum(r.counters.get("chunks", 0) for r in recs)
    assert result["metrics"]["ssb_ms.usb5"]["value"] > 0
    assert result["metrics"]["enqueue_ms.usb5"]["value"] > 0
    assert "chan_roofline.usb5" not in result["metrics"]
