"""Synthetic-capture benchmark and the resident step rate (port of the
JAX package's ``pipeline/benchmark.py``: ``generate_synthetic_iq``,
``run_benchmark`` and ``measure_step_resident_msps``).

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

__all__ = ["run_benchmark", "generate_synthetic_iq", "measure_step_resident_msps"]


def measure_step_resident_msps(
    sample_rate: float = 2_500_000.0,
    *,
    offset_hz: float = 25_000.0,
    target_chunk: int = 1 << 22,
    channels: int = 1,
    device: str | None = None,
    seconds_target: float = 1.0,
    graph_groups: int = 4,
) -> dict:
    """The full chunk step's resident-compute rate, in input Msps.

    Runs the production ``ChunkStep.fn_super`` (``build_chunk_step`` with
    its real channelizer selection, at the flagship NFM geometry: taps,
    decimation, de-emphasis, 48 kHz out) over int16 input that already lies
    on the device, so reads, uploads, downloads and file writes stay off
    the clock.  ``channels > 1`` batches carriers spread over the band.

    On a CUDA device ``graph_groups`` dispatch groups (three resident
    inputs in turn, the stream state carried from group to group) are
    captured in one CUDA graph and the graph is replayed for about
    ``seconds_target`` between two CUDA events: the device's clock, with no
    Python launches in the window (the JAX package times one compiled
    ``fori_loop``).  Every replay starts from the state the capture started
    from.  The result also holds the rate implied by the profiler's
    device-busy time of one replay (``busy_msps``).  A step that cannot be
    captured is timed by the profiler's device-busy time instead
    (``"method": "profiler_busy"``).  On the CPU the host clock times
    ``graph_groups`` eager groups (``"host_clock"``).  See
    :func:`~iq_to_audio_torch.utils.device_clock.resident_rate`.

    Returns ``{"msps", "x_realtime", "method", "calls", "replays",
    "super_chunks", "chunk_size", "channels", "channelizer", "elapsed_s",
    "device"}``, plus ``busy_msps`` and ``kernel_events`` from a graph.
    """
    import torch

    from ..demod import create_decoder
    from ..ops.ddc import DDCPlan, bandpass_kernel
    from ..utils.device import resolve_device
    from ..utils.device_clock import resident_rate
    from .capture import channel_geometry, nco_increments, resampler_kernel
    from .step import build_chunk_step

    dev = resolve_device(device)
    geo = channel_geometry(sample_rate, 12_500.0, 96_000.0)
    taps = geo.taps
    ddc_plan = DDCPlan.create(
        len(taps), geo.decimation, target_chunk=target_chunk, out_align=geo.out_align,
        max_chunk=max(target_chunk, 1 << 22),
    )
    rs_plan = geo.resampler(ddc_plan.out_size)
    decoder = create_decoder("nfm", deemph_us=300.0, agc_enabled=True)
    decoder.setup(geo.fs_channel)
    offsets = [offset_hz, *_spread_channels(0.0, sample_rate, channels)[0]]
    incs, nco_res = nco_increments(offsets, sample_rate)
    step = build_chunk_step(
        ddc_plan=ddc_plan,
        rs_plan=rs_plan,
        ddc_kernel_np=bandpass_kernel(taps, incs, nco_res),
        rs_kernel_np=resampler_kernel(rs_plan),
        incs_fixed=incs,
        nco_res=nco_res,
        codec="pcm_s16le",
        iq_order="iq",
        decoder=decoder,
        device=dev,
        est_total_chunks=8,
        taps_np=np.asarray(taps),
    )
    groups_per_window = step.acc_chunks // step.super_chunks
    S = step.super_chunks
    rng = np.random.default_rng(0)
    raws = [
        torch.from_numpy(
            (rng.normal(scale=0.05, size=(S, 2 * ddc_plan.chunk_size)) * 8000.0).astype("<i2")
        ).to(dev)
        for _ in range(3)
    ]
    rs_offset = 0 if rs_plan.identity else rs_plan.chunk_offset(0)
    accs = step.init_accs()
    box = {"state": step.init_state()}

    def group(r: int) -> None:
        slot = (r % groups_per_window) * S
        box["state"] = step.fn_super(box["state"], accs, raws[r % len(raws)], rs_offset, slot)

    probe = resident_rate(
        group, S * ddc_plan.chunk_size, dev, calls=graph_groups,
        seconds_target=seconds_target, kernel_name="poly_fir_kernel", busy=dev.type == "cuda",
    )
    # one consumption of the accumulator and the carried state
    if not np.isfinite(float(accs["audio"][..., -1].to(torch.float32).sum()
                             + box["state"]["peak"].sum())):
        raise RuntimeError("resident step: non-finite output")
    msps = probe["msps"]
    out = {
        **probe,
        "x_realtime": msps * 1e6 / sample_rate,
        "super_chunks": S,
        "chunk_size": ddc_plan.chunk_size,
        "channels": len(incs),
        "channelizer": step.channelizer,
    }
    LOG.info(
        "full-step resident: %.0f Msps = %.1fx realtime of the %.1f MS/s workload "
        "(%s, %d groups x %d replays of %d chunk(s), chunk %d, %d channel(s), "
        "channelizer %s)",
        msps, out["x_realtime"], sample_rate / 1e6, probe["method"], graph_groups,
        probe["replays"], S, ddc_plan.chunk_size, len(incs), step.channelizer,
    )
    return out


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
