"""Per-capture set-up: what every entry decides about one capture before it
builds a step, and the rules those decisions follow.

The serial pipeline, the preview, burst mode (:mod:`.hetero`), the
multi-capture runner (:mod:`..parallel.dp_runner`) and the resident step
rate of ``--benchmark`` (:mod:`.benchmark`) take the format, rate, centre
and offsets (:func:`resolve_capture`), the channel geometry
(:func:`channel_geometry`), the mixer sign and NCO increments
(:func:`decide_mix_sign`, :func:`nco_increments`) and the output names
(:func:`channel_paths`) from here.  Chunk sizing stays with the callers.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from collections.abc import Callable
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..io.formats import InputFormatSpec, resolve_input_format
from ..io.probe import SampleRateProbe, probe_sample_rate
from ..io.reader import IQReader, convert_to_complex
from ..ops.mix_probe import choose_mix_sign_on
from ..ops.nco import nco_increment_fixed, nco_increment_residual
from ..ops.resample import ResamplePlan, design_resampler_kernel
from ..ref.chain import mix_probe_len
from ..utils import spans
from ..utils.freq import detect_center_frequency
from .filters import compute_decimation, design_channel_filter

LOG = logging.getLogger(__name__)

#: the audio rate every demodulated channel is resampled to (Hz)
OUTPUT_RATE = 48_000.0
#: the most target channels one run batches
MAX_TARGETS = 5


def is_pass_through(mode: str | None) -> bool:
    """Whether ``demod_mode`` writes the decimated IQ instead of audio."""
    return (mode or "").lower() in {"none", "pass", "iq"}


@dataclass
class Capture:
    """One capture as resolved: its format, rate, centre and targets."""

    path: Path
    spec: InputFormatSpec
    #: where the format came from (``manual`` or the detector's source)
    format_source: str
    probe: SampleRateProbe
    sample_rate: float
    center_freq: float
    #: where the centre came from (``config`` when the caller gave it)
    center_source: str
    #: the positive targets, or the centre when there is none
    freqs: list[float]
    offsets: list[float]

    def reader(self, chunk_size: int, iq_order: str, start_frame: int = 0) -> IQReader:
        """A synchronous reader of ``chunk_size`` frames per block."""
        return IQReader(
            self.path, chunk_size, iq_order, self.spec,
            sample_rate=self.sample_rate if self.spec.container == "raw" else None,
            start_frame=start_frame,
            prefetch_depth=0,  # no Python thread beside dispatch
        )


def resolve_capture(
    path: Path,
    *,
    input_format: str | None = None,
    container: str | None = None,
    sample_rate: float | None = None,
    center_freq: float | None = None,
    center_source: str | None = None,
    targets: list[float] = (),
) -> Capture:
    """Resolve a capture: the format (``input_format`` overrides detection),
    the rate (a raw capture needs ``sample_rate``, which otherwise replaces
    the probe's value), the centre (detected when not given) and the
    targets' offsets (at most :data:`MAX_TARGETS`)."""
    path = Path(path)
    with spans.span("iq2a.setup.probe"):
        spec, format_source = resolve_input_format(
            path, requested=input_format, container_hint=container
        )
    if sample_rate is not None and sample_rate <= 0:
        raise ValueError("Input sample rate override must be positive.")
    if spec.container == "raw":
        if sample_rate is None:
            raise ValueError(
                "Raw IQ inputs require --input-sample-rate (CLI) or a "
                "manual entry in the GUI."
            )
        probe = SampleRateProbe(override=float(sample_rate))
    else:
        with spans.span("iq2a.setup.probe"):
            probe = probe_sample_rate(path)
        if sample_rate is not None:
            probe = dataclasses.replace(probe, override=float(sample_rate))
    try:
        rate = float(probe.value)
    except RuntimeError as exc:
        raise RuntimeError(
            "Unable to determine input sample rate automatically. "
            "Provide --input-sample-rate or enter it manually."
        ) from exc

    if center_freq is None:
        with spans.span("iq2a.setup.probe"):
            detection = detect_center_frequency(path)
        if detection.value is None:
            raise ValueError(
                "Center frequency not supplied and could not be determined "
                "from metadata or filename. Use --fc to provide it explicitly."
            )
        center_freq, center_source = detection.value, detection.source
        LOG.info("Center frequency detected via %s.", center_source)

    freqs = [f for f in targets if f and f > 0] or [center_freq]
    if len(freqs) > MAX_TARGETS:
        raise ValueError("At most five target frequencies are supported per run.")
    return Capture(
        path=path, spec=spec, format_source=format_source, probe=probe, sample_rate=rate,
        center_freq=center_freq, center_source=center_source or "config",
        freqs=freqs, offsets=[f - center_freq for f in freqs],
    )


@dataclass(frozen=True)
class ChannelGeometry:
    """The channelizer's and the resampler's shape at one input rate."""

    decimation: int
    fs_channel: float
    taps: np.ndarray
    #: the resampler's ratio to :data:`OUTPUT_RATE` (``in_size`` 1); None
    #: in pass-through, whose slices stay at ``fs_channel``
    ratio: ResamplePlan | None

    @property
    def out_align(self) -> int:
        """What the decimated count of a chunk is a multiple of: the
        resampler's ``down``, so every chunk's blocks repeat."""
        return 1 if self.ratio is None or self.ratio.identity else self.ratio.down

    def resampler(self, in_size: int) -> ResamplePlan | None:
        """The resampler's plan for ``in_size`` decimated samples a chunk."""
        return self.ratio and ResamplePlan.create(self.fs_channel, OUTPUT_RATE, in_size)


def channel_geometry(
    sample_rate: float, bandwidth: float, fs_ch_target: float, pass_through: bool = False
) -> ChannelGeometry:
    """Decimation, channel rate, channel-filter taps and resampler ratio."""
    decimation, fs_channel = compute_decimation(sample_rate, fs_ch_target)
    taps = design_channel_filter(sample_rate, bandwidth, decimation)
    ratio = None if pass_through else ResamplePlan.create(fs_channel, OUTPUT_RATE, 1)
    return ChannelGeometry(decimation, fs_channel, taps, ratio)


def resampler_kernel(rs_plan: ResamplePlan | None) -> np.ndarray | None:
    """The polyphase kernel of ``rs_plan``; None when nothing resamples."""
    resampling = rs_plan is not None and not rs_plan.identity
    return design_resampler_kernel(rs_plan.up, rs_plan.down) if resampling else None


def warm_frames(sample_rate: float, num_taps: int) -> int:
    """Frames of a warm-up block that hold all the mixer-sign probe reads."""
    return mix_probe_len(sys.maxsize, sample_rate, num_taps)


def decide_mix_sign(
    read_warm: Callable[[], np.ndarray | None],
    device: torch.device,
    codec: str,
    iq_order: str,
    sample_rate: float,
    freq_offset: float,
    geometry: ChannelGeometry,
    *,
    resumed: int | None = None,
    override: int | None = None,
) -> int:
    """The run's mixer sign: a checkpoint's (``resumed``), else the
    ``override`` (+1 or -1), else the probe's on the head of the raw
    warm-up block that ``read_warm()`` returns, called only to probe."""
    if resumed is not None:
        return int(resumed)
    if override in (1, -1):
        return int(override)
    raw = read_warm()
    if raw is None or raw.size == 0:
        raise ValueError("Input stream produced no samples.")
    n = mix_probe_len(raw.size // 2, sample_rate, len(geometry.taps))
    warm = convert_to_complex(raw[: 2 * n], codec, iq_order)
    return choose_mix_sign_on(
        device, warm, sample_rate, freq_offset, geometry.taps, geometry.decimation
    )


def nco_increments(
    offsets: list[float], sample_rate: float, sign: int = 1
) -> tuple[list[int], list[int]]:
    """The uint32 NCO increment of every offset at ``sign``, and each one's
    residual (``ops/nco.py``: together the 62-bit increment)."""
    return (
        [nco_increment_fixed(off, sample_rate, sign=sign) for off in offsets],
        [nco_increment_residual(off, sample_rate, sign=sign) for off in offsets],
    )


def annotate(base: Path, freq: float) -> Path:
    """``base`` with ``_<freq>`` before its suffix: one output of a batch."""
    return base.with_name(f"{base.stem}_{int(round(freq))}{base.suffix}")


def default_output_path(
    in_path: Path, target_freq: float, *, pass_through: bool = False,
    spec: InputFormatSpec | None = None,
) -> Path:
    """The output beside the input: ``audio_<ft>_48k.wav``, or in
    pass-through ``slice_<ft>`` with the input's extension."""
    ft = int(target_freq)
    if not pass_through:
        return in_path.with_name(f"audio_{ft}_48k.wav")
    in_suffix = in_path.suffix
    if spec and spec.container == "wav":
        ext = in_suffix if in_suffix.lower() in {".wav", ".wave", ".wv", ".rf64"} else ".wav"
    elif spec and spec.container == "raw":
        codec_ext = {"pcm_u8": ".cu8", "pcm_s16le": ".cs16", "pcm_f32le": ".cf32"}
        ext = in_suffix or codec_ext.get(spec.codec, ".raw")
    else:
        ext = in_suffix or ".wav"
    return in_path.with_name(f"slice_{ft}{ext}")


def channel_paths(
    config, freqs: list[float], base: Path | None, spec: InputFormatSpec | None = None
) -> list[Path]:
    """Per-channel output paths: an explicit extra path of ``config``
    verbatim, else the shared ``base`` suffixed with ``_<freq>`` when
    batching, else the default name (reference cli ``annotate_path``)."""
    paths: list[Path] = []
    extras = config.extra_output_paths
    multi = len(freqs) > 1
    for i, freq in enumerate(freqs):
        explicit = extras[i - 1] if i > 0 and i - 1 < len(extras) else None
        if explicit is not None:
            paths.append(Path(explicit))
        elif base is not None:
            paths.append(annotate(Path(base), freq) if multi else Path(base))
        else:
            paths.append(default_output_path(
                Path(config.in_path), freq,
                pass_through=is_pass_through(config.demod_mode), spec=spec,
            ))
    return paths
