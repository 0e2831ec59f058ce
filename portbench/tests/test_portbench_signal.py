"""The seeded capture: the same seed gives the same samples, another seed
others; the file name, the job picks and the check's sample follow the
seed too."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import runner
from portbench.signals import nfm_carriers

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "portbench" / "configs" / "nfm1_2m5_s16.json").read_text())
SEED = 2**31 + 11


def test_same_seed_same_capture():
    a = nfm_carriers.make(CFG, 0.05, SEED, "cpu")
    b = nfm_carriers.make(CFG, 0.05, SEED, "cpu")
    assert a.dtype == torch.complex64 and a.numel() == 125_000
    assert torch.equal(a, b)


@pytest.mark.parametrize("other", [SEED + 1, 7, 2**40 + 3])
def test_other_seed_other_capture(other):
    a = nfm_carriers.make(CFG, 0.05, SEED, "cpu")
    b = nfm_carriers.make(CFG, 0.05, other, "cpu")
    assert not torch.equal(a, b)


def test_capture_levels_and_carriers():
    x = nfm_carriers.make(CFG, 0.2, SEED, "cpu").numpy().astype(np.complex128)
    assert 0.02 < np.sqrt(np.mean(np.abs(x) ** 2)) < 0.2 and np.abs(x).max() < 1.0
    spec = np.abs(np.fft.fftshift(np.fft.fft(x))) ** 2
    freqs = np.fft.fftshift(np.fft.fftfreq(x.size, 1.0 / CFG["sample_rate"]))
    floor = np.median(spec)
    for off in nfm_carriers.offsets(CFG):
        band = np.abs(freqs - off) < 5_000  # every carrier starts keyed on
        assert spec[band].mean() > 10 * floor


def test_wav_round_trip(tmp_path):
    from portbench.containers import wav_s16

    x = nfm_carriers.make(CFG, 0.01, SEED, "cpu")
    path = tmp_path / "cap.wav"
    assert wav_s16.write(path, x, CFG["sample_rate"]) == 4 * x.numel()
    back = wav_s16.read(path)
    assert back.numel() == x.numel()
    assert torch.allclose(back, x.to(torch.complex128) * (32767 / 32768), atol=1 / 32768)
    assert wav_s16.read(path, 100).numel() == 100


def test_file_name_gives_the_centre_frequency(tmp_path):
    from iq_to_audio_torch.utils.freq import detect_center_frequency

    name = runner.capture_name(CFG["assumed"]["center_freq_hz"], SEED)
    assert name == runner.capture_name(CFG["assumed"]["center_freq_hz"], SEED)
    path = tmp_path / name
    path.write_bytes(b"")
    found = detect_center_frequency(path)
    assert found.value == CFG["assumed"]["center_freq_hz"] and "sdrpp" in found.source


def test_job_picks_and_check_sample():
    offsets = nfm_carriers.offsets(CFG)
    picks = [runner.job_offsets(CFG, offsets, SEED, i) for i in range(40)]
    assert picks == [runner.job_offsets(CFG, offsets, SEED, i) for i in range(40)]
    assert all(len(p) == 1 and p[0] in offsets for p in picks)
    assert len({p[0] for p in picks}) == len(offsets)
    five = dict(CFG, targets_per_job=5)
    assert runner.job_offsets(five, offsets, SEED, 3) == offsets
    traffic = {"check_sample": 3, "check_span": 30}
    keep = runner.check_indices(traffic, SEED)
    assert keep == runner.check_indices(traffic, SEED) and len(keep) == 3
    assert all(0 <= i < 30 for i in keep)
