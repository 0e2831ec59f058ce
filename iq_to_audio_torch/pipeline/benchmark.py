"""Synthetic-capture benchmark (port of the JAX package's
``pipeline/benchmark.py::generate_synthetic_iq`` and ``run_benchmark``).

The flagship workload: a 2.5 MS/s s16 WAV capture, one NFM channel at a
12.5 kHz bandwidth, written as 48 kHz s16 WAV; ``channels > 1`` adds
carriers spread across the band and batches them through the shared
channelizer.  One timed pipeline pass gives the realtime factor (capture
seconds per wall second).
"""

from __future__ import annotations

import logging
import math
import tempfile
import time
from collections.abc import Mapping
from pathlib import Path
from typing import Any

import numpy as np

from ..io.writer import write_stereo_wav
from .config import ProcessingConfig
from .pipeline import ProcessingPipeline

LOG = logging.getLogger(__name__)


def generate_synthetic_iq(
    path: Path,
    sample_rate: float,
    seconds: float,
    freq_offset: float,
    *,
    amplitude: float = 0.7,
    noise_std: float = 0.02,
    extra_offsets: tuple[float, ...] = (),
) -> None:
    """Write a synthetic IQ WAV: one carrier at ``freq_offset`` (plus one
    per entry of ``extra_offsets``) over seeded Gaussian noise, clipped and
    stored as PCM_16 stereo (the JAX package's generator)."""
    n = int(round(sample_rate * seconds))
    if n <= 0:
        raise ValueError("Benchmark duration is too short to generate samples.")
    t = np.arange(n, dtype=np.float64) / sample_rate
    carriers = np.exp(2j * math.pi * freq_offset * t)
    for k, off in enumerate(extra_offsets):
        carriers = carriers + 0.6 * np.exp(1j * (2.0 * math.pi * off * t + 0.37 * (k + 1)))
    # normalise so the summed carriers still peak near `amplitude`
    gain = amplitude / (1.0 + 0.6 * len(extra_offsets))
    noise = np.random.default_rng(42).normal(scale=noise_std, size=(n, 2))
    frames = np.empty((n, 2), dtype=np.float32)
    frames[:, 0] = gain * carriers.real + noise[:, 0]
    frames[:, 1] = gain * carriers.imag + noise[:, 1]
    np.clip(frames, -0.999, 0.999, out=frames)
    write_stereo_wav(path, frames, int(sample_rate), codec="pcm_s16le")


def _resolve_freqs(
    center: float | None, target: float | None, offset: float
) -> tuple[float, float, float]:
    """Fill in whichever of (center, target) is missing; return
    (center, target, actual_offset)."""
    if center is not None and target is not None:
        return center, target, target - center
    if center is not None:
        return center, center + offset, offset
    if target is not None:
        return target - offset, target, offset
    center = 400_000_000.0
    return center, center + offset, offset


def _spread_channels(center: float, sample_rate: float, channels: int):
    """Extra carriers alternating above/below center across 35% of the band."""
    if channels <= 1:
        return (), []
    span = sample_rate * 0.35
    offsets = tuple(
        span * (k + 1) / channels * (1 if k % 2 == 0 else -1)
        for k in range(channels - 1)
    )
    return offsets, [center + o for o in offsets]


def run_benchmark(
    *,
    seconds: float,
    sample_rate: float,
    freq_offset: float,
    center_freq: float | None,
    target_freq: float | None,
    base_kwargs: Mapping[str, object] | None,
    warmup: bool = True,
    results_out: dict | None = None,
    channels: int = 1,
    workdir: Path | None = None,
) -> int:
    """Generate a synthetic capture and time one full pipeline pass.

    ``channels > 1`` benchmarks the batched shared-channelizer path by
    spreading additional carriers across the capture bandwidth.
    ``workdir`` keeps the capture and the audio there; by default both go
    to a temporary directory removed at the end.  Returns 0 (CLI exit
    code); detailed numbers land in ``results_out`` if given.
    """
    if seconds <= 0:
        raise ValueError("Benchmark duration must be positive.")
    if sample_rate <= 0:
        raise ValueError("Benchmark sample rate must be positive.")

    overrides: dict[str, Any] = dict(base_kwargs) if base_kwargs else {}
    mode = overrides.get("demod_mode")
    demod = mode.lower() if isinstance(mode, str) else "nfm"
    center_freq, target_freq, offset = _resolve_freqs(center_freq, target_freq, freq_offset)
    if abs(offset) >= sample_rate / 2.0:
        raise ValueError("Benchmark offset must be within half the sample rate.")
    LOG.info(
        "Running benchmark: %.2f s at %.2f MS/s, demod=%s, offset %.1f kHz",
        seconds, sample_rate / 1e6, demod.upper(), offset / 1e3,
    )

    with tempfile.TemporaryDirectory() as tmpdir:
        work = Path(workdir) if workdir is not None else Path(tmpdir)
        work.mkdir(parents=True, exist_ok=True)
        capture = work / f"benchmark_fc-{int(center_freq)}Hz.wav"
        extra_offsets, extra_targets = _spread_channels(center_freq, sample_rate, channels)
        generate_synthetic_iq(capture, sample_rate=sample_rate, seconds=seconds,
                              freq_offset=offset, extra_offsets=extra_offsets)
        overrides.pop("target_freqs", None)
        overrides.update(
            target_freq=target_freq,
            extra_target_freqs=extra_targets,
            center_freq=center_freq,
            center_freq_source="benchmark",
            demod_mode=demod,
            output_path=work / f"benchmark_audio_{demod}.wav",
            probe_only=False,
        )
        if channels > 1:
            overrides["mix_sign_override"] = 1

        def _one_pass():
            cfg = ProcessingConfig(in_path=capture, **overrides)
            t0 = time.perf_counter()
            res = ProcessingPipeline(cfg).run()
            return time.perf_counter() - t0, res

        cold_elapsed = None
        if warmup:
            cold_elapsed, _ = _one_pass()
            LOG.info("Warm-up pass: %.2f s.", cold_elapsed)
        elapsed, result = _one_pass()

    iq_samples = sample_rate * seconds
    realtime = seconds / elapsed if elapsed > 0 else float("inf")
    peak_dbfs = 20.0 * math.log10(max(result.audio_peak, 1e-6))
    LOG.info(
        "Benchmark processed %.0f IQ samples in %.2f s (%.2f x realtime); "
        "audio peak %.2f dBFS.",
        iq_samples, elapsed, realtime, peak_dbfs,
    )
    if results_out is not None:
        results_out.update(
            seconds=seconds,
            sample_rate=sample_rate,
            demod=demod,
            iq_samples=iq_samples,
            elapsed=elapsed,
            cold_elapsed=cold_elapsed,
            realtime_factor=realtime,
            loop_seconds=result.loop_seconds,
            msps=iq_samples / max(elapsed, 1e-12) / 1e6,
            audio_peak_dbfs=peak_dbfs,
            decimation=result.decimation,
            fs_channel=result.fs_channel,
            mix_sign=result.mix_sign,
            dispatched_chunks=result.dispatched_chunks,
            output_path=result.output_paths[0],
            output_paths=list(result.output_paths),
            freq_offsets=[offset, *extra_offsets],
        )
    return 0
