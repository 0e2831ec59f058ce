"""The plain reference: its filters against direct sums, its design rules,
and the check's control: the reference in TF32 in the program's place fails
the cells' limit where the program passes it, at a size a test holds."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import check, runner
from portbench.harness.spec import Bench
from portbench.reference import chain, design

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("decim, per_frame, taps", [(26, 16, 1601), (1, 256, 700), (7, 3, 30), (4, 1, 5)])
def test_block_fir_is_the_direct_sum(decim, per_frame, taps):
    rng = np.random.default_rng(decim)
    x = rng.normal(size=(2, 4000))
    h = rng.normal(size=taps)
    y = chain.block_fir(torch.from_numpy(x), h, decim, "f64", per_frame=per_frame).numpy()
    want = np.array([np.convolve(r, h)[: r.size][::decim] for r in x])
    assert y.shape == want.shape
    np.testing.assert_allclose(y, want, atol=1e-11)


def test_resample_is_the_direct_sum():
    up, down = 3, 7
    x = np.random.default_rng(1).normal(size=300)
    y = chain.resample(torch.from_numpy(x), up, down, "f64", block=50).numpy()
    proto = design.resample_prototype(up, down)
    k = design.RESAMPLE_TAPS_PER_PHASE
    want = []
    for n in range((x.size * up + down - 1) // down):
        ip, phi = divmod(n * down, up)
        want.append(sum(proto[j * up + phi] * x[ip - j] for j in range(k) if 0 <= ip - j < x.size))
    np.testing.assert_allclose(y, want, atol=1e-12)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-12, 1.0 + 2**-10, -3.14159, 1e-30], dtype=torch.float32)
    r = chain.tf32_round(x)
    assert torch.all(r.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((r - x).abs() <= x.abs() * 2**-11)
    assert r[0] == 1.0 and r[2] == x[2]


def test_design_rules():
    d, fs_ch = design.decimation(2.5e6, 96_000.0)
    assert (d, round(fs_ch, 3)) == (26, 96153.846)
    taps = design.channel_taps(2.5e6, 12_500.0, d)
    assert taps.size == 1601 and taps.sum() == pytest.approx(1.0)
    assert design.resample_ratio(fs_ch, 48_000.0) == (312, 625)


@pytest.mark.parametrize("offset, sign", [(25_000.0, 1), (-25_000.0, -1)])
def test_mix_sign(offset, sign):
    fs = 250_000.0
    n = np.arange(40_000)
    tone = np.exp(2j * np.pi * offset * n / fs) + 0.01 * np.random.default_rng(0).normal(size=n.size)
    d, _ = design.decimation(fs, 96_000.0)
    taps = design.channel_taps(fs, 12_500.0, d)
    assert design.mix_sign(tone, fs, 25_000.0, taps, d) == sign


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_program_passes_and_control_fails(monkeypatch, cell, conv_channelizer):
    """The cell's limits between the two readings: the program on the CPU
    (the hand kernel's plain version) is correct under them, and the TF32
    control, written as the program's WAVs and judged by the run's own
    comparison, is not, on every WAV."""
    from portbench import control

    # two jobs of a short capture: the first and the one past the span
    monkeypatch.setattr(runner, "check_indices", lambda traffic, seed: {0})
    bench = Bench(ROOT)
    limits = bench.cell(cell).limits
    row = control.readings(bench, cell, 2**31 + 101, "cpu", capture_seconds=2.2)
    program, ctl = row["program"], row["control"]
    assert row["program_correct"], program
    assert program["wavs"] == ctl["wavs"] >= 2
    assert not row["control_correct"], ctl
    assert any(ctl[f"{k}_least"] > limits[k] for k in check.NUMBERS[1:]), ctl
