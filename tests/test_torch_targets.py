"""One to five target channels batched through one channelizer pass in the
port: output names and paths, and each channel's audio against the float64
twin (-60 dB), on the CPU at 250 kHz."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from conftest import error_db

import iq_to_audio_torch as tpkg
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.ops import poly_fir as tpoly
from iq_to_audio_torch.ops.resample import ResamplePlan
from iq_to_audio_torch.pipeline.benchmark import run_benchmark
from iq_to_audio_torch.pipeline.filters import compute_decimation, design_channel_filter
from iq_to_audio_torch.ref.chain import RefResampler, ref_demod_chain

torch.set_num_threads(1)

FS = 250_000.0
CENTER = 145_000_000.0
OFFSETS = (25_000.0, -40_000.0, 60_000.0, -75_000.0, 95_000.0)


def _multi_nfm(offsets, seconds):
    """One NFM carrier per offset, each with its own audio tone."""
    n = int(round(FS * seconds))
    t = np.arange(n, dtype=np.float64) / FS
    iq = np.zeros(n, np.complex128)
    for k, off in enumerate(offsets):
        audio = np.sin(2.0 * math.pi * (700.0 + 300.0 * k) * t)
        phase = 2.0 * math.pi * np.cumsum(off + 2_500.0 * audio) / FS
        iq += 0.7 / len(offsets) * np.exp(1j * (phase + 0.5 * k))
    rng = np.random.default_rng(17)
    iq += rng.normal(scale=0.005, size=n) + 1j * rng.normal(scale=0.005, size=n)
    return iq.astype(np.complex64)


def _twin(iq, offset, mix_sign):
    decim, fs_ch = compute_decimation(FS, 96_000.0)
    taps = design_channel_filter(FS, 12_500.0, decim)
    audio_ch, _ = ref_demod_chain(
        iq.astype(np.complex128), sample_rate=FS, freq_offset=offset, taps=taps,
        decimation=decim, mode="nfm", agc_enabled=True, mix_sign=mix_sign,
    )
    plan = ResamplePlan.create(fs_ch, 48_000.0, 1)
    return np.clip(RefResampler(plan.up, plan.down).resample_all(audio_ch), -0.99, 0.99)


@pytest.mark.parametrize("channels", [2, 5])
def test_multi_target_matches_twin(tmp_path, channels):
    offsets = OFFSETS[:channels]
    iq = _multi_nfm(offsets, 0.6)
    path = tmp_path / f"baseband_{int(CENTER)}Hz_multi.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(FS), codec="pcm_f32le")
    explicit = tmp_path / "named" / "second.wav"
    cfg = tpkg.ProcessingConfig(
        in_path=path, target_freq=CENTER + offsets[0],
        extra_target_freqs=[CENTER + o for o in offsets[1:]],
        extra_output_paths=[explicit], output_path=tmp_path / "multi.wav",
        device="cpu", chunk_size=65_536,
    )
    result = tpkg.ProcessingPipeline(cfg).run()
    want_paths = [tmp_path / f"multi_{int(CENTER + offsets[0])}.wav", explicit]
    want_paths += [tmp_path / f"multi_{int(CENTER + o)}.wav" for o in offsets[2:]]
    assert result.output_paths == want_paths
    assert len(result.audio_peaks) == len(result.stats) == channels
    assert result.target_freq == CENTER + offsets[0]
    assert result.freq_offset == offsets[0]
    for c, (p, off) in enumerate(zip(result.output_paths, offsets)):
        got, rate = read_wav(p)
        got = got[:, 0]
        assert rate == 48_000
        ref = _twin(iq, off, result.mix_sign)
        n = min(got.size, ref.size)
        assert abs(got.size - ref.size) <= 2
        assert error_db(got[:n], ref[:n]) < -60.0, (c, off)
        assert result.audio_peaks[c] > 0.01
        rms_db = 20.0 * np.log10(np.sqrt(np.mean(got.astype(np.float64) ** 2)))
        assert abs(result.stats[c].rms_dbfs - rms_db) < 0.1


def test_default_names_and_target_limit(tmp_path):
    iq = _multi_nfm(OFFSETS[:2], 0.2)
    path = tmp_path / f"baseband_{int(CENTER)}Hz_names.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(FS))
    freqs = [CENTER + o for o in OFFSETS[:2]]
    cfg = tpkg.ProcessingConfig(
        in_path=path, target_freq=freqs[0], extra_target_freqs=freqs[1:], device="cpu",
        chunk_size=65_536,
    )
    result = tpkg.ProcessingPipeline(cfg).run()
    assert result.output_paths == [tmp_path / f"audio_{int(f)}_48k.wav" for f in freqs]
    assert all(p.exists() for p in result.output_paths)
    too_many = tpkg.ProcessingConfig(
        in_path=path, target_freq=freqs[0],
        extra_target_freqs=[CENTER + 1_000.0 * k for k in range(1, 6)], device="cpu",
    )
    with pytest.raises(ValueError, match="At most five"):
        tpkg.ProcessingPipeline(too_many).run()


def test_run_benchmark_five_channels_on_cpu(tmp_path):
    """``channels=5``: carriers spread over the band, five WAVs, one
    channelizer call per chunk for all five channels (the wrapper's plain
    version on the CPU, so no kernel launch is counted)."""
    results: dict = {}
    before = tpoly.poly_fir_il.launches
    rc = run_benchmark(
        seconds=0.3, sample_rate=FS, freq_offset=25_000.0, center_freq=None,
        target_freq=None, channels=5, base_kwargs={"device": "cpu", "chunk_size": 32_768},
        warmup=False, results_out=results, workdir=tmp_path,
    )
    assert rc == 0
    assert tpoly.poly_fir_il.launches == before
    assert len(results["output_paths"]) == 5 and len(results["freq_offsets"]) == 5
    assert results["mix_sign"] == 1
    offsets = results["freq_offsets"]
    assert len(set(offsets)) == 5 and max(abs(o) for o in offsets) < 0.5 * FS
    for p in results["output_paths"]:
        audio, rate = read_wav(p)
        assert rate == 48_000 and abs(audio.shape[0] - 0.3 * 48_000) <= 2
        assert np.all(np.isfinite(audio))
