"""The port's AM chain against the benchmark's plain float64 reference
(``portbench/reference``), on the CPU at the widths of the configuration
``am5_20m_s16``: 20 MS/s, 12.5 kHz channels (12,801 taps, decimation 208,
K = 62), five targets, the hand kernel's plain version; and one target at
2.5 MS/s (1,601 taps, decimation 26).

A seeded ``am_voices`` capture goes through ``ProcessingPipeline.run()`` as
the benchmark's jobs run it, and each WAV is judged as a benchmark run
judges it: ``len_gap``, ``mean_gap_lsb`` and ``trim_gap_lsb`` against the
cell's own limits (``limits/am5.archive20.json``, set from the program's
and the TF32 control's readings on the card).  The control, the reference
computed with TF32 operands, fails the same limits on the same capture.

The card's chunk at 20 MS/s is 4,160,000 samples; here the chunk planner's
target is cut (``tune_chunk_size``) so that each job crosses at least three
chunk boundaries in a capture short enough for the CPU.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch

from portbench.harness import check, runner
from portbench.harness.spec import Bench
from portbench.reference import design

from iq_to_audio_torch.pipeline import pipeline as tpipeline

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELL = "am5.archive20"
SEED = 2**31 + 211
#: (sample rate, capture seconds, carriers, chunk target): the chunk target
#: is a multiple of D * 625 (the resampler's ``down``), as the planner aligns
GEOMETRIES = {
    "20M_five": (20e6, 0.25, None, 208 * 625 * 7),
    "2M5_one": (2.5e6, 0.5, [350_000.0], 26 * 625 * 16),
}
#: at least this many chunk boundaries in every job
BOUNDARIES = 3


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


@pytest.fixture(autouse=True)
def conv_channelizer(monkeypatch):
    monkeypatch.setenv("IQ2A_CHANNELIZER", "conv")


def config_of(bench, name):
    rate, _, carriers, _ = GEOMETRIES[name]
    cfg = copy.deepcopy(bench.cell(CELL).config)
    cfg["sample_rate"] = int(rate)
    if carriers is not None:
        cfg["assumed"]["carrier_offsets_hz"] = carriers
    return cfg


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def judged(request, bench, tmp_path_factory):
    """One job of every carrier through the port, and the control's codes
    in the program's place, each WAV's numbers against the float64
    reference."""
    name = request.param
    _, seconds, _, target = GEOMETRIES[name]
    cfg = config_of(bench, name)
    cell = bench.cell(CELL)
    work = tmp_path_factory.mktemp(f"am_{name}")
    container = bench.container(cfg["container"])
    signal = bench.signal(cfg["signal"])
    capture = runner.write_capture(cfg, signal, container, work, SEED, seconds, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IQ2A_CHANNELIZER", "conv")
        mp.setattr(tpipeline, "tune_chunk_size", lambda rate, requested: target)
        job = runner.run_job(
            bench.entry("pipeline"), runner.Job(0, signal.offsets(cfg)), capture, cfg,
            cell.traffic, work / "job.wav", "cpu",
        )
    ref = check.Reference(capture, container, cfg, "cpu")
    program: list = []
    check.compare([job], ref, None, program)
    ctl = check.Reference(capture, container, cfg, "cpu", prec=check.CONTROL)
    sign = ref.sign(job.offsets[0])
    control = [
        check.gaps(ctl.codes(off, sign, job.input_samples), ref.codes(off, sign, job.input_samples))
        for off in job.offsets
    ]
    return name, job, cfg, program, control


def worst(each):
    return {k: max(g[k] for g in each) for k in check.NUMBERS} | {"wavs": len(each), "spikes": 0}


def test_the_jobs_cross_chunk_boundaries(judged):
    name, job, cfg, _, _ = judged
    _, _, _, target = GEOMETRIES[name]
    assert job.dispatched_chunks >= BOUNDARIES + 1
    assert job.input_samples == round(GEOMETRIES[name][1] * cfg["sample_rate"])
    assert len(job.outputs) == len(job.offsets)


def test_port_within_the_cells_limits(bench, judged):
    """Every WAV within the limits a benchmark run holds the card to; on the
    CPU the port reads a few ten-thousandths of an s16 step (the float32
    chain's roundings where the reference's code lies near a half step)."""
    _, _, _, program, _ = judged
    correct, checks = check.verdict(worst(program), bench.cell(CELL).limits)
    assert correct, checks


def test_the_tf32_control_fails_the_limits(bench, judged):
    """The reference with TF32 operands in the program's place: a tenth of
    a step of the envelope's rounding (2**-11 of the carrier) is far over
    the limits, on every WAV."""
    _, _, _, _, control = judged
    limits = bench.cell(CELL).limits
    for g in control:
        correct, checks = check.verdict(worst([g]), limits)
        assert not correct, checks


def test_the_configuration_runs_the_published_widths(bench):
    cfg = bench.cell(CELL).config
    p = cfg["pipeline"]
    d, fs_ch = design.decimation(cfg["sample_rate"], p["fs_ch_target"])
    taps = design.channel_taps(cfg["sample_rate"], p["bandwidth"], d)
    assert (d, taps.size, -(-taps.size // d)) == (208, 12_801, 62)
    assert design.resample_ratio(fs_ch, cfg["output_rate"]) == (312, 625)
    assert (p["demod_mode"], cfg["targets_per_job"], cfg["sample_rate"]) == ("am", 5, 20_000_000)
    limits = json.loads((ROOT / "portbench" / "limits" / f"{CELL}.json").read_text())
    assert limits["len_gap"] == 0


def test_the_cards_chunk_at_20_msps(bench):
    """The card's plan: the 4 Mi cap, aligned to D * 625, 20,000 channel
    outputs a chunk; the kernel stages all 62 taps in one block of 68 and
    launches 79 CTAs: one wave, one CTA on each of 79 of the 132 SMs."""
    from iq_to_audio_torch.ops import poly_fir
    from iq_to_audio_torch.ops.ddc import DDCPlan
    from iq_to_audio_torch.pipeline.filters import tune_chunk_size

    cfg = bench.cell(CELL).config
    target = max(tune_chunk_size(cfg["sample_rate"], cfg["pipeline"]["chunk_size"]), 1 << 22)
    plan = DDCPlan.create(12_801, 208, target_chunk=target, out_align=625, max_chunk=1 << 22)
    assert (plan.chunk_size, plan.out_size) == (4_160_000, 20_000)
    k_block = poly_fir.choose_k_block(62, 416, 10, plan.out_size)
    assert k_block == 68
    assert -(-plan.out_size // (poly_fir.SHIFT * poly_fir.TILE_ROWS)) == 79
