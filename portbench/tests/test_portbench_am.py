"""The airband cell ``am5.archive20``: the reference's AM demodulator against
a per-sample loop of the upstream's envelope and DC blocker, its TF32
control, the ``am_voices`` capture, the readers ``am_ms.am5`` and
``chan_roofline.am5``, and a traced run of the cell on the CPU."""

from __future__ import annotations

import math
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import runner
from portbench.harness.spec import Bench
from portbench.harness.tracing import Trace
from portbench.reference import chain
from portbench.reference.modes import am

ROOT = Path(__file__).resolve().parents[2]
CELL = "am5.archive20"
SEED = 2**31 + 29
MS = 1_000_000
H100 = "NVIDIA H100 80GB HBM3"
CHUNK = 4_160_000  # the card's chunk at 20 MS/s: 20,000 outputs at D = 208
FORBIDDEN = {"jax", "jaxlib", "flax", "iq_to_audio_tpu", "iq_to_audio_torch"}


def upstream_loop(z: np.ndarray) -> np.ndarray:
    """``decoders/am.py``, one sample at a time, in float64."""
    out = np.empty(z.size)
    x_prev = y_prev = 0.0
    for n, v in enumerate(z):
        x = math.sqrt(v.real * v.real + v.imag * v.imag)
        y = x - x_prev + 0.995 * y_prev
        x_prev, y_prev = x, y
        out[n] = y
    return out


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


@pytest.fixture(scope="module")
def cfg(bench):
    return bench.cell(CELL).config


def test_am_is_the_per_sample_loop():
    """Keyed carrier with noise whose level swings, a run of exact zeros."""
    rng = np.random.default_rng(4)
    n = 20_000
    level = 0.3 * (np.arange(n) % 5_000 < 3_000) + 10.0 ** (-2.0 * (1.0 + np.sin(np.arange(n) / 900.0)))
    z = level * (1.0 + 0.3 * rng.normal(size=n)) + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    z[7_000:7_300] = 0.0
    got = am.demod(torch.from_numpy(z), 96_153.8, {"agc_enabled": True}, "f64").numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, upstream_loop(z), rtol=1e-9, atol=1e-12)


def test_the_mode_is_found_by_name():
    assert chain.load_mode("am") is am


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    script = textwrap.dedent(
        """
        import sys; sys.path.insert(0, '.')
        import torch
        from portbench.reference import chain
        z = torch.exp(1j * torch.arange(40_000, dtype=torch.float64) * 0.01) * 0.1
        p = {"fs_ch_target": 96000.0, "bandwidth": 12500.0, "demod_mode": "am"}
        chain.channel_audio(z, 2.5e6, 25_000.0, 1, p, "f64")
        chain.channel_audio(z, 2.5e6, 25_000.0, 1, p, "tf32")
        print(sorted({m.split('.')[0] for m in sys.modules}))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "1"},
    ).stdout.strip().splitlines()[-1]
    names = set(eval(out))  # a list of names printed by the script above
    assert "portbench" in names and not names & FORBIDDEN


def test_the_control_differs_from_the_reference(bench, cfg):
    sig = bench.signal("am_voices")
    iq = sig.make(cfg, 0.05, SEED, "cpu").to(torch.complex128)
    off = sig.offsets(cfg)[2]
    codes = {
        prec: chain.encode_s16(chain.channel_audio(iq, 20e6, off, 1, cfg["pipeline"], prec))
        for prec in ("f64", "tf32")
    }
    gap = (codes["f64"] - codes["tf32"]).abs()
    assert codes["f64"].abs().max() > 100
    assert float(gap.mean()) > 0.01 and int((gap > 0).sum()) > 100


def test_same_seed_same_capture(bench, cfg):
    sig = bench.signal("am_voices")
    a = sig.make(cfg, 0.002, SEED, "cpu")
    assert a.dtype == torch.complex64 and a.numel() == 40_000
    assert torch.equal(a, sig.make(cfg, 0.002, SEED, "cpu"))
    assert not torch.equal(a, sig.make(cfg, 0.002, SEED + 1, "cpu"))
    assert not torch.equal(a, sig.make(cfg, 0.002, 2**40 + 3, "cpu"))


def test_blocks_of_the_mix_change_nothing(bench, cfg, monkeypatch):
    """The carriers mixed in blocks (a ragged last one) equal one block."""
    sig = bench.signal("am_voices")
    whole = sig.make(cfg, 0.002, SEED, "cpu")
    monkeypatch.setattr(sig, "BLOCK", 7_001)
    assert torch.equal(whole, sig.make(cfg, 0.002, SEED, "cpu"))


@pytest.fixture(scope="module")
def spectrum(bench, cfg):
    """Power per 20 Hz bin over the first 50 ms (inside every carrier's
    first span, which is on), as a share of the capture's power."""
    x = bench.signal("am_voices").make(cfg, 0.05, SEED, "cpu").numpy().astype(np.complex128)
    return np.abs(np.fft.fft(x)) ** 2 / x.size**2, np.fft.fftfreq(x.size, 1.0 / cfg["sample_rate"])


def test_carriers_at_their_offsets_keyed_on(bench, cfg, spectrum):
    """Each carrier's bin holds over 1,000 times the noise of a bin, and its
    sidebands fill 300-3,000 Hz on both sides of it."""
    power, freqs = spectrum
    noise_bin = float(np.median(power))
    for off in bench.signal("am_voices").offsets(cfg):
        k = int(np.argmin(np.abs(freqs - off)))
        assert power[k] > 1_000 * noise_bin, off
        for side in (1, -1):
            band = (side * (freqs - off) > 300) & (side * (freqs - off) < 3_000)
            assert power[band].mean() > 3 * noise_bin, (off, side)


def test_levels_over_the_noise_floor(bench, cfg, spectrum):
    """Each carrier's power 15-30 dB over the noise in a 12.5 kHz channel,
    the noise floor at the assumed -26 dBFS, nothing clipped."""
    power, freqs = spectrum
    a = cfg["assumed"]
    noise = float(np.median(power)) / math.log(2.0)  # the median of an exponential
    assert 10.0 * math.log10(noise * freqs.size) == pytest.approx(20.0 * math.log10(a["noise_rms"]), abs=0.2)
    chan_noise = noise * cfg["pipeline"]["bandwidth"] / (freqs[1] - freqs[0])
    for off in bench.signal("am_voices").offsets(cfg):
        k = int(np.argmin(np.abs(freqs - off)))
        snr_db = 10.0 * math.log10(power[k] / chan_noise)
        assert a["snr_db"][0] - 0.5 < snr_db < a["snr_db"][1] + 0.5, (off, snr_db)
    x = bench.signal("am_voices").make(cfg, 0.01, SEED, "cpu")
    assert float(x.abs().max()) < 1.0


# --- the readers --------------------------------------------------------------


def records(am_span: bool):
    """One job of two chunk steps of two chunks each; with ``am_span`` each
    step holds one ``iq2a.am`` per chunk, 0.25 ms each."""
    from iq_to_audio_torch.utils.spans import Record

    rows = []

    def add(name, start, end, parent=None, **counters):
        rows.append(Record(name, int(start * MS), int(end * MS), parent, 7, 1, counters))

    add("iq2a.job", 0, 100)
    add("iq2a.loop", 10, 90, 0)
    for t0 in (20, 50):
        step = len(rows)
        add("iq2a.step", t0, t0 + 3, 1, chunks=2)
        if am_span:
            add("iq2a.am", t0 + 0.5, t0 + 0.75, step)
            add("iq2a.am", t0 + 1.5, t0 + 1.75, step)
    return rows


def run_of(trace=None, jobs=(), config=None):
    return SimpleNamespace(trace=trace, jobs=list(jobs), window_s=2.0, config=config,
                           peaks=Bench(ROOT).peaks(), device_kind=H100)


def test_am_ms_on_hand_built_records(bench, monkeypatch):
    from iq_to_audio_torch.utils import spans

    rows = records(True)
    monkeypatch.setattr(spans, "records", lambda: list(rows))
    assert bench.metric("am_ms.am5").read(run_of()) == pytest.approx(4 * 0.25 / 4)
    # the step's own time no longer holds the chain's: 3 - 0.5 ms a step
    assert bench.metric("enqueue_ms.archive").read(run_of()) == pytest.approx(2 * 2.5 / 4)


@pytest.mark.parametrize("nothing", ["no am span", "no records", "no spans module"])
def test_am_ms_reads_none_without_the_span(bench, monkeypatch, nothing):
    from iq_to_audio_torch.utils import spans

    if nothing == "no am span":
        rows = records(False)
        monkeypatch.setattr(spans, "records", lambda: list(rows))
    elif nothing == "no records":
        monkeypatch.setattr(spans, "records", lambda: [])
    else:
        monkeypatch.setitem(sys.modules, "iq_to_audio_torch.utils.spans", None)
    assert bench.metric("am_ms.am5").read(run_of()) is None


def test_chan_roofline_am5_is_the_archive_reader_at_d_208(bench, cfg):
    am5, archive = bench.metric("chan_roofline.am5"), bench.metric("chan_roofline.archive")
    assert archive.channel_geometry(cfg) == (208, 12_801)
    assert -(-12_801 // 208) == 62
    nbytes, flops = archive.work(cfg, CHUNK, 5)
    assert flops == pytest.approx(8.0 * 12_801 * 20_000 * 5)
    assert nbytes == pytest.approx(CHUNK * 4 + 20_000 * 8 * 5)
    bound = max(nbytes / 3.35e12, flops / 495e12)
    assert bound * 1e3 == pytest.approx(0.0207, rel=1e-2)
    trace = Trace(window_s=1.0, busy_s=0.1, ops={"poly_fir_kernel<10>": [97, 97 * 0.2e-3]})
    jobs = [SimpleNamespace(input_samples=97 * CHUNK, offsets=[0.0] * 5)]
    run = run_of(trace, jobs, cfg)
    assert am5.read(run) == archive.read(run) == pytest.approx(100 * bound / 0.2e-3, rel=1e-6)
    assert am5.read(run_of(None, jobs, cfg)) is None
    renamed = Trace(window_s=1.0, busy_s=0.1, ops={"other_kernel": [97, 0.012]})
    assert am5.read(run_of(renamed, jobs, cfg)) is None


def test_the_cell_reports_its_metrics(bench):
    cell = bench.cell(CELL)
    assert {m["name"] for m in cell.per_layer} == {"am_ms.am5", "chan_roofline.am5"}
    assert {m["name"] for m in cell.end_to_end} == {"realtime_x", "setup_s"}
    assert cell.chips == 1 and cell.traffic["capture_seconds"] == 20.0


def test_a_traced_cpu_run_reports_am_ms(bench, conv_channelizer):
    """On the CPU the chain's span is read; the roofline has no device
    kernel to read, and no peaks for the CPU, so the line leaves it out."""
    from iq_to_audio_torch.utils import spans

    spans.reset()
    try:
        result = runner.run_cell(bench, CELL, 2**31 + 47, 0.05, True, device="cpu", capture_seconds=0.25)
    finally:
        recs = spans.records()
        spans.reset()
    assert result["correct"], result["checks"]
    steps = [i for i, r in enumerate(recs) if r.name == "iq2a.step"]
    am_spans = [r for r in recs if r.name == "iq2a.am"]
    assert am_spans and all(r.parent in steps for r in am_spans)
    assert len(am_spans) == sum(r.counters.get("chunks", 0) for r in recs)
    assert result["metrics"]["am_ms.am5"]["value"] > 0
    assert "chan_roofline.am5" not in result["metrics"]
