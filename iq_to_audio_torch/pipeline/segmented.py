"""Segmented (burst-mode) capture processing: frame-aligned time windows
(port of the JAX package's ``pipeline/segmented.py``, numpy only).

Splits one capture into input windows that independent pipeline streams
can process at the same time (the card's stream and host-CPU worker
processes, :mod:`.hetero`), then splices the per-window outputs back into
one file.  The plans are the JAX package's, field for field.

Exactness model
---------------
Segment boundaries sit on *frames* of ``decimation x resampler_down``
input samples.  At a frame boundary a **fresh** decimator/resampler state
is stream-position-correct by construction (offset 0, polyphase phase 0),
and the NCO is phase-seeded from the absolute sample index in uint32
arithmetic (exact at any start — ``ChunkStep.init_state``).  The
remaining carried state converges exponentially:

* channel FIR tail — exact after ``taps - 1`` input samples,
* de-emphasis IIR (pole ``exp(-1/(fs_ch*tau))``),
* DC blocker (pole 0.995/sample),
* feedback AGC gain (pole ~0.999/sample — the slowest),
* audio-resampler FIR tail (a few hundred channel samples).

Every segment after the first therefore processes a *lead-in* window
whose audio is discarded: the default 0.5 s puts the slowest pole at
``0.999^48000 ~ e^-48`` — far below the -60 dB golden contract
(segment-vs-serial in ``tests/test_torch_segmented.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .capture import OUTPUT_RATE, is_pass_through

LOG = logging.getLogger(__name__)

#: default lead-in; see the exactness model above
WARM_SECONDS = 0.5


def warm_seconds_for(
    demod_mode: str | None,
    agc_enabled: bool,
    fs_channel: float,
    num_taps: int,
    sample_rate: float,
    deemph_us: float | None = None,
) -> float:
    """Shortest lead-in that parks every carried recurrence below the
    -60 dB golden contract with >=60 dB of margin, per mode.

    The blanket ``WARM_SECONDS`` (0.5 s) prices every mode for the
    slowest pole (feedback AGC, ~0.999/sample); the lead-ins of a plan
    are pure overhead.  Convergence is mode-specific:

    * pass-through: no recurrences — only the channel-filter input
      history (L-1 samples) and the splice's frame alignment matter;
    * NFM/AM: DC blocker pole 0.995 (-174 dB after 4096 channel samples)
      and the de-emphasis pole exp(-1/(fs_ch*tau)) (16 time constants);
    * SSB with AGC: gain pole ~0.999 -> 16384 channel samples (-142 dB).

    Never returns more than ``WARM_SECONDS`` (the validated ceiling).
    """
    mode = (demod_mode or "").lower()
    if is_pass_through(mode):
        ch_samples = 256.0
    elif mode in {"usb", "lsb", "ssb"} and agc_enabled:
        ch_samples = 16384.0
    else:
        ch_samples = 4096.0
    if deemph_us and deemph_us > 0:
        ch_samples = max(ch_samples, 16.0 * fs_channel * deemph_us * 1e-6)
    lead = ch_samples / max(fs_channel, 1.0)
    # at least the channel filter's full input history
    lead = max(lead, 2.0 * num_taps / max(sample_rate, 1.0))
    return float(min(WARM_SECONDS, lead))


@dataclass(frozen=True)
class Segment:
    """One worker's input window and output splice instructions."""

    index: int
    #: absolute first input sample of the OWNED region (frame-aligned)
    start: int
    #: owned input samples (frame-aligned except for the final segment)
    length: int
    #: lead-in input samples processed before ``start`` and discarded
    lead: int
    #: audio samples to drop from the head of this worker's output
    audio_skip: int

    @property
    def read_start(self) -> int:
        return self.start - self.lead

    @property
    def read_samples(self) -> int:
        return self.lead + self.length


def plan_segments(
    total_samples: int,
    sample_rate: float,
    decimation: int,
    rs_up: int,
    rs_down: int,
    n_workers: int,
    warm_seconds: float = WARM_SECONDS,
    front_split: int = 1,
) -> list[Segment]:
    """Frame-aligned, equal-length (except the tail) segment plan.

    ``rs_up``/``rs_down`` are the audio resampler's rational ratio (1/1
    when the channel rate already equals the output rate).  Workers get
    equal owned lengths so they share one device geometry; the final
    segment absorbs the capture's unaligned tail.

    ``front_split > 1`` subdivides the FIRST segment into up to that many
    frame-aligned sub-segments (re-indexed so the plan still tiles
    0..k-1).  This is the heterogeneous executor's fractional-claim
    granularity: the device stream claims from the FRONT of the queue, so
    finer front segments let a slow side contribute a share smaller than
    1/n_workers instead of abstaining, while back-of-queue claims (the
    fast side) keep merging contiguous runs into single pipeline windows
    — one lead-in per claim either way, so a side that drains the whole
    plan pays no extra overhead.  Each sub-segment keeps at least two
    lead-ins of owned length so its lead-in overhead stays bounded.
    """
    if total_samples <= 0:
        raise ValueError("total_samples must be positive")
    frame = decimation * rs_down
    # ResamplePlan reduces the ratio, so rs_up IS the audio per frame
    # (identity rate reduces to 1/1)
    audio_per_frame = rs_up
    lead_frames = max(1, math.ceil(warm_seconds * sample_rate / frame))
    total_frames = total_samples // frame
    # a segment shorter than its lead-in is pointless overhead: bound the
    # worker count so each owned region is at least 4 lead-ins long
    max_workers = max(1, total_frames // (4 * lead_frames))
    k = max(1, min(n_workers, max_workers))
    per = total_frames // k  # owned frames per worker (tail extra on last)
    segments: list[Segment] = []
    for i in range(k):
        start = i * per * frame
        if i == k - 1:
            length = total_samples - start
        else:
            length = per * frame
        lead = min(lead_frames * frame, start) if i else 0
        segments.append(
            Segment(
                index=i,
                start=start,
                length=length,
                lead=lead,
                audio_skip=(lead // frame) * audio_per_frame,
            )
        )
    if front_split > 1 and k >= 2:
        first = segments[0]
        frames0 = first.length // frame
        pieces = min(int(front_split), max(1, frames0 // max(2 * lead_frames, 1)))
        if pieces > 1:
            per0 = frames0 // pieces
            subs: list[Segment] = []
            for j in range(pieces):
                start = j * per0 * frame
                length = (
                    first.length - start if j == pieces - 1 else per0 * frame
                )
                lead = min(lead_frames * frame, start) if j else 0
                subs.append(
                    Segment(
                        index=j,
                        start=start,
                        length=length,
                        lead=lead,
                        audio_skip=(lead // frame) * audio_per_frame,
                    )
                )
            segments = subs + [
                dataclasses.replace(s, index=s.index + pieces - 1)
                for s in segments[1:]
            ]
    return segments


def splice_iq_slices(
    segment_paths: list[Path],
    frame_skips: list[int],
    out_path: Path,
    sample_rate: float,
    spec,
) -> tuple[float, int]:
    """Concatenate segment IQ-slice files (pass-through mode) into one,
    dropping each segment's lead-in of ``frame_skips`` complex frames.

    ``spec`` is the :class:`~..io.formats.InputFormatSpec` the slices were
    written with (container wav/raw + codec), mirroring the serial
    IQSliceWriter's codec-preserving behavior.  Returns ``(peak, frames)``
    where ``peak`` is max |I+jQ| of the written (already encoded) stream —
    the post-quantisation counterpart of the serial writer's pre-encode
    peak.
    """
    from ..io.reader import _CODEC_DTYPE, convert_to_complex
    from ..io.riff import WavStreamWriter, parse_wav_header

    out_path = Path(out_path)
    frame_bytes = spec.bytes_per_frame
    dtype = _CODEC_DTYPE[spec.codec]  # single source of codec dtypes
    peak = 0.0
    frames = 0
    writer = None
    fd = None
    if spec.container == "wav":
        writer = WavStreamWriter(
            out_path, max(1, int(round(sample_rate))), 2, spec.codec
        )
    else:
        fd = out_path.open("wb")
    try:
        for path, skip in zip(segment_paths, frame_skips):
            if spec.container == "wav":
                info = parse_wav_header(path)
                offset, size = info.data_offset, info.data_size
            else:
                offset, size = 0, Path(path).stat().st_size
            skip_bytes = skip * frame_bytes
            if size < skip_bytes:
                raise ValueError(
                    f"Segment {path} holds {size // frame_bytes} frames — "
                    f"fewer than its {skip}-frame lead-in; the worker run "
                    "was truncated."
                )
            with Path(path).open("rb") as f:
                f.seek(offset + skip_bytes)
                payload = f.read(size - skip_bytes)
            payload = payload[: (len(payload) // frame_bytes) * frame_bytes]
            if not payload:
                continue
            raw = np.frombuffer(payload, dtype=dtype)
            iq = convert_to_complex(raw, spec.codec, "iq")
            peak = max(peak, float(np.max(np.abs(iq))))
            frames += iq.size
            if writer is not None:
                writer.write_raw(payload)
            else:
                fd.write(payload)
    finally:
        if writer is not None:
            writer.close()
        if fd is not None:
            fd.close()
    return peak, frames


def splice_audio(
    segment_paths: list[Path],
    audio_skips: list[int],
    out_path: Path,
    output_rate: int = int(OUTPUT_RATE),
) -> tuple[float, int, float]:
    """Concatenate segment WAVs (dropping each lead-in) into ``out_path``.

    Returns ``(peak, total_samples, rms_dbfs)`` where ``peak`` is the exact
    peak of the written (already clipped+quantised) sample stream, matching
    the writers' written-sample peak semantics, and ``rms_dbfs`` is the
    capture-level RMS (the DecoderStats metric; -200 when empty).
    """
    from ..io.riff import WavStreamWriter, parse_wav_header
    from ..io.writer import RmsAccumulator

    out_path = Path(out_path)
    peak_q = 0
    total = 0
    rms = RmsAccumulator()
    writer = WavStreamWriter(out_path, int(output_rate), 1, "pcm_s16le")
    try:
        for path, skip in zip(segment_paths, audio_skips):
            info = parse_wav_header(path)
            if info.data_size < 2 * skip:
                raise ValueError(
                    f"Segment {path} holds {info.data_size // 2} samples — "
                    f"fewer than its {skip}-sample lead-in; the worker run "
                    "was truncated."
                )
            remaining = info.data_size - 2 * skip
            remaining -= remaining % 2
            with Path(path).open("rb") as f:
                f.seek(info.data_offset + 2 * skip)
                # stream in bounded blocks: a segment's audio payload can be
                # gigabytes, and slurping it whole (plus the int conversion
                # copies) would spike peak memory to ~3x the payload size
                while remaining > 0:
                    payload = f.read(min(remaining, 8 << 20))
                    if not payload:
                        break
                    take = len(payload) - (len(payload) % 2)
                    payload = payload[:take]
                    remaining -= take
                    samples = np.frombuffer(payload, dtype="<i2")
                    peak_q = max(
                        peak_q, int(np.max(np.abs(samples.astype(np.int32))))
                    )
                    rms.add_s16(samples)
                    total += samples.size
                    writer.write_raw(payload)
    finally:
        writer.close()
    return peak_q / 32767.0, total, rms.dbfs
