"""The port's USB chain with the feedback AGC against the benchmark's plain
float64 reference (``portbench/reference``), on the CPU at the widths of the
configuration ``usb5_2m5_s16``: 2.5 MS/s, 2.8 kHz channels (7,143 taps,
decimation 26), the hand kernel's plain version.

A seeded 0.3 s ``ssb_voices`` capture goes through
``ProcessingPipeline.run()`` as the benchmark's jobs run it, and each WAV is
judged as a benchmark run judges it: ``len_gap``, ``mean_gap_lsb`` and
``trim_gap_lsb`` against the cell's own limits (``limits/usb5.archive.json``,
set from the program's and the TF32 control's readings on the card).  A
deliberately wrong AGC fails them.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

from portbench.harness import check, runner
from portbench.harness.spec import Bench

from iq_to_audio_torch.ops import iir
from iq_to_audio_torch.ops.nco import nco_increment_residual

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELL = "usb5.archive"
SEED = 2**31 + 101
SECONDS = 0.3
#: with the AGC off nothing amplifies the float32 channelizer's rounding:
#: the port reads at most 0.0012 s16 steps here (mean), and without the NCO's
#: increment residual the real part drifts off the exact mix, 0.11 steps by
#: the end of the first target's 0.3 s (ops/nco.py)
AGC_OFF_GAP = 0.01
DRIFT_GAP = 0.05


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


@pytest.fixture(scope="module")
def capture(bench, tmp_path_factory):
    cfg = bench.cell(CELL).config
    work = tmp_path_factory.mktemp("usb")
    return runner.write_capture(
        cfg, bench.signal(cfg["signal"]), bench.container(cfg["container"]), work, SEED,
        SECONDS, "cpu",
    )


def convert(bench, capture, out_dir, targets, agc):
    """One job of ``targets`` through the port, and each WAV's numbers
    against the float64 reference."""
    cell = bench.cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["pipeline"]["agc_enabled"] = agc
    offsets = bench.signal(cfg["signal"]).offsets(cfg)[:targets]
    job = runner.run_job(
        bench.entry("pipeline"), runner.Job(0, offsets), capture, cfg, cell.traffic,
        out_dir / "job.wav", "cpu",
    )
    ref = check.Reference(capture, bench.container(cfg["container"]), cfg, "cpu")
    each: list = []
    worst = check.compare([job], ref, None, each)
    assert worst["wavs"] == targets
    return worst, each


@pytest.fixture(autouse=True)
def conv_channelizer(monkeypatch):
    monkeypatch.setenv("IQ2A_CHANNELIZER", "conv")


@pytest.mark.parametrize("targets", [1, 5])
@pytest.mark.parametrize("agc", [True, False], ids=["agc", "no_agc"])
def test_port_within_the_cells_limits(bench, capture, tmp_path, targets, agc):
    worst, each = convert(bench, capture, tmp_path, targets, agc)
    correct, checks = check.verdict(worst, bench.cell(CELL).limits)
    assert correct, checks
    if not agc:
        assert max(g["mean_gap_lsb"] for g in each) < AGC_OFF_GAP, each


def test_without_the_nco_residual_the_audio_drifts(bench, capture, tmp_path, monkeypatch):
    """The uint32 NCO alone (the JAX package's) mixes the first target
    0.34 counts per sample off its frequency; the real part shows it."""
    assert nco_increment_residual(-90_000.0, 2.5e6) != 0
    monkeypatch.setattr(
        "iq_to_audio_torch.pipeline.capture.nco_increment_residual", lambda *a, **k: 0
    )
    worst, _ = convert(bench, capture, tmp_path, 1, False)
    assert worst["mean_gap_lsb"] > DRIFT_GAP, worst


def test_a_wrong_agc_fails(bench, capture, tmp_path, monkeypatch):
    """Twice the upstream's decay.  (The gain updated after the sample is
    scaled reads 3-4 s16 steps here against the port's 0.3-1.6: inside the
    room the limits leave the float32 channelizer at 40 s, so the check does
    not see it; ``test_torch_iir.py`` holds the order against the loop.)"""
    monkeypatch.setattr(
        "iq_to_audio_torch.demod.ssb.feedback_agc",
        lambda x, target, decay, gain0: iir.feedback_agc(x, target, 2 * decay, gain0),
    )
    worst, _ = convert(bench, capture, tmp_path, 5, True)
    correct, checks = check.verdict(worst, bench.cell(CELL).limits)
    assert not correct, checks


def test_the_configuration_runs_the_published_widths(bench):
    from portbench.reference import design

    cfg = bench.cell(CELL).config
    p = cfg["pipeline"]
    d, _ = design.decimation(cfg["sample_rate"], p["fs_ch_target"])
    taps = design.channel_taps(cfg["sample_rate"], p["bandwidth"], d)
    assert (d, taps.size, -(-taps.size // d)) == (26, 7143, 275)
    assert (p["demod_mode"], p["agc_enabled"], cfg["targets_per_job"]) == ("usb", True, 5)
    assert json.loads((ROOT / "portbench" / "limits" / f"{CELL}.json").read_text())["len_gap"] == 0
