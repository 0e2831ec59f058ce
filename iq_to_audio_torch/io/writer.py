"""Output writers: 48 kHz audio WAV, IQ slice, cf32 debug dump.

First-party replacements for the reference's second ffmpeg subprocess
(reference ``processing.py:381-524``) and soundfile slice writer
(``processing.py:542-596``).  Resampling happens on device before these run,
so the writers are pure encode+IO; a dedicated drain thread keeps the DSP
loop from blocking on disk, mirroring the reference's writer-thread design.
"""

from __future__ import annotations

import contextlib
import logging
import math
import queue
import threading
from pathlib import Path

import numpy as np

from .formats import InputFormatSpec
from .riff import WavStreamWriter

LOG = logging.getLogger(__name__)


class RmsAccumulator:
    """Running capture-level RMS over written samples, reported in dBFS
    (the reference's DecoderStats metric, ``decoders/base.py:9-13``).

    One implementation for every consumer — the float and s16 writer paths
    here and the segment splicer (:func:`..pipeline.segmented.splice_audio`)
    — so the floor/sentinel/normalisation constants cannot drift apart.
    """

    __slots__ = ("_sumsq", "_count")

    def __init__(self):
        self._sumsq = 0.0
        self._count = 0

    def add_float(self, samples: np.ndarray) -> None:
        """Accumulate float samples in [-1, 1]."""
        d = np.asarray(samples, dtype=np.float64)
        self._sumsq += float(np.dot(d, d))
        self._count += d.size

    def add_s16(self, samples: np.ndarray) -> None:
        """Accumulate s16-encoded samples (normalised by 32767)."""
        s = np.asarray(samples).astype(np.int64)
        self._sumsq += float(np.dot(s, s)) / (32767.0 * 32767.0)
        self._count += s.size

    @property
    def dbfs(self) -> float:
        """RMS in dBFS; -200.0 when nothing was accumulated."""
        if self._count == 0:
            return -200.0
        return 10.0 * math.log10(max(self._sumsq / self._count, 1e-20))

    @property
    def state(self) -> tuple[float, int]:
        """(sum of squares, sample count) — checkpointable."""
        return self._sumsq, self._count

    def seed(self, sumsq: float, count: int) -> None:
        """Restore a checkpointed accumulation (resume support)."""
        self._sumsq = float(sumsq)
        self._count = int(count)


class AudioWriter:
    """Stream float32 mono audio into a 48 kHz pcm_s16le WAV.

    Input samples are expected already at the output rate (the device
    resampler did the rate conversion); clipping to +-0.99 and peak tracking
    match the reference (``processing.py:449-452``).
    """

    def __init__(
        self,
        output_path: Path,
        *,
        output_rate: int = 48_000,
        append: bool = False,
        threaded: bool = False,
    ):
        self.output_path = Path(output_path)
        self.output_rate = int(output_rate)
        self.peak = 0.0
        self._rms = RmsAccumulator()
        self._writer = WavStreamWriter(
            self.output_path, self.output_rate, 1, "pcm_s16le", append=append
        )
        # bounded: a disk slower than the DSP loop must apply backpressure
        # (block the producer) instead of growing payload copies without
        # limit — the reference's SimpleQueue relied on ffmpeg's stdin pipe
        # for the same effect
        self._queue: queue.Queue = queue.Queue(maxsize=64)
        self._error: BaseException | None = None
        self._closed = False
        # synchronous by default: writes land once per accumulation window
        # (page-cache speed), and extra Python threads measurably degrade
        # accelerator dispatch on some runtimes.  threaded=True restores the
        # reference's drain-thread design (processing.py:430-476).
        self._thread = None
        if threaded:
            self._thread = threading.Thread(
                target=self._drain, name="AudioWriter", daemon=True
            )
            self._thread.start()

    def write(self, samples: np.ndarray) -> None:
        if self._closed:
            raise RuntimeError("AudioWriter has already been closed.")
        if self._error:
            raise RuntimeError("audio writer failed") from self._error
        samples = np.asarray(samples)
        if samples.size == 0:
            return
        peak = float(np.max(np.abs(samples)))
        if peak > self.peak:
            self.peak = peak
        safe = np.clip(samples, -0.99, 0.99).astype(np.float32, copy=False)
        self._rms.add_float(safe)
        self._submit(safe)
        if self._error:
            raise RuntimeError("audio writer failed") from self._error

    @property
    def rms_dbfs(self) -> float:
        """RMS level of everything written so far, in dBFS (-200 when
        nothing was written) — the reference's DecoderStats metric."""
        return self._rms.dbfs

    @property
    def rms_state(self) -> tuple[float, int]:
        """Checkpointable (sumsq, count) of the RMS accumulator."""
        return self._rms.state

    def seed_rms(self, sumsq: float, count: int) -> None:
        """Restore the RMS accumulation of an earlier run (resume keeps the
        capture-level RMS covering the WHOLE capture, not just the samples
        written after the checkpoint)."""
        self._rms.seed(sumsq, count)

    def write_s16(self, samples: np.ndarray) -> None:
        """Enqueue audio that was already s16-encoded (e.g. on device).

        The peak is tracked from the written samples (exact for everything
        the stream contains); when the device-side +-0.99 clipper engaged,
        the pipeline max-merges the device's pre-clip float peak on top
        (pipeline.py EOF flush).
        """
        if self._closed:
            raise RuntimeError("AudioWriter has already been closed.")
        if self._error:
            raise RuntimeError("audio writer failed") from self._error
        samples = np.asarray(samples, dtype=np.int16)
        if samples.size == 0:
            return
        peak = float(np.max(np.abs(samples.astype(np.int32)))) / 32767.0
        if peak > self.peak:
            self.peak = peak
        self._rms.add_s16(samples)
        self._submit(samples)

    def _submit(self, payload: np.ndarray) -> None:
        if self._thread is not None:
            self._queue.put(payload)
        else:
            try:
                self._write_payload(payload)
            except Exception as exc:
                # Exception, not BaseException: a KeyboardInterrupt landing
                # mid-write must propagate as itself (callers route
                # interrupts differently from IO failures)
                self._error = exc
                raise RuntimeError("audio writer failed") from exc

    def _write_payload(self, payload: np.ndarray) -> None:
        if payload.dtype == np.int16:  # already device-encoded
            self._writer.write_raw(payload.tobytes())
            return
        from .native import encode_s16

        encoded = encode_s16(payload, clip=1.0)  # input pre-clipped
        if encoded is not None:
            self._writer.write_raw(encoded[0].tobytes())
        else:
            self._writer.write_float(payload)

    def _drain(self) -> None:
        while True:
            payload = self._queue.get()
            if payload is None:
                return
            if self._error is not None:
                continue
            try:
                self._write_payload(payload)
            except Exception as exc:  # surfaced on next write/close
                self._error = exc

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._queue.put(None)
            if self._thread.is_alive():
                self._thread.join(timeout=60)
            if self._thread.is_alive():
                # NEVER patch the header while the drain thread may still
                # be writing payload bytes on the same fd — leave the
                # placeholder sizes (readers treat data as running to EOF)
                # and surface the condition instead of corrupting the file.
                # The raw fd is still released (a wedged writer in a
                # long-lived GUI process must not leak descriptors); the
                # drain thread's next write then fails into _error, which
                # is already latched.
                self._error = self._error or RuntimeError(
                    "audio drain thread did not finish within 60 s"
                )
                with contextlib.suppress(Exception):
                    if self._writer._fd is not None:
                        self._writer._fd.close()
                        self._writer._fd = None
                raise RuntimeError("audio writer failed") from self._error
        self._writer.close()
        if self._error:
            raise RuntimeError("audio writer failed") from self._error


class IQDebugWriter:
    """Raw interleaved float32 (.cf32) dump of the channelized IQ
    (reference ``processing.py:363-378``)."""

    def __init__(self, path: Path | None, sample_rate: float, *, append: bool = False):
        self.path = Path(path) if path else None
        self.sample_rate = sample_rate
        mode = "ab" if append else "wb"
        self.fd = self.path.open(mode) if self.path else None

    def write(self, samples: np.ndarray) -> None:
        if not self.fd or samples.size == 0:
            return
        data = np.asarray(samples, dtype=np.complex64).view(np.float32)
        self.fd.write(data.tobytes())

    def close(self) -> None:
        if self.fd:
            self.fd.close()
            self.fd = None


def _encode_iq_raw(samples: np.ndarray, codec: str) -> bytes:
    """Raw IQ encoding rules (reference ``processing.py:527-539``)."""
    from .native import interleave_encode

    payload = interleave_encode(samples, codec)
    if payload is not None:
        return payload
    interleaved = np.empty(samples.size * 2, dtype=np.float32)
    interleaved[0::2] = samples.real
    interleaved[1::2] = samples.imag
    if codec == "pcm_f32le":
        return interleaved.astype("<f4", copy=False).tobytes()
    if codec == "pcm_s16le":
        scaled = np.clip(interleaved, -1.0, 0.999969) * 32767.0
        return scaled.astype("<i2", copy=False).tobytes()
    if codec == "pcm_u8":
        scaled = np.clip(interleaved, -1.0, 1.0)
        return np.round((scaled + 1.0) * 127.5).astype(np.uint8, copy=False).tobytes()
    raise ValueError(f"Unsupported raw codec {codec}")


class IQSliceWriter:
    """Write complex IQ slices preserving container/codec (pass-through mode,
    reference ``processing.py:542-596``)."""

    def __init__(
        self,
        output_path: Path,
        sample_rate: float,
        spec: InputFormatSpec,
        *,
        append: bool = False,
    ):
        self.output_path = Path(output_path)
        self.sample_rate = float(sample_rate)
        self.spec = spec
        self.peak = 0.0
        self._wav: WavStreamWriter | None = None
        self._fd = None
        if spec.container == "wav":
            self._wav = WavStreamWriter(
                self.output_path,
                max(1, int(round(self.sample_rate))),
                2,
                spec.codec,
                append=append,
            )
        else:
            self._fd = self.output_path.open("ab" if append else "wb")

    def write(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples)
        if samples.size == 0:
            return
        peak = float(np.max(np.abs(samples)))
        if peak > self.peak:
            self.peak = peak
        if self._wav is not None:
            interleaved = np.column_stack((samples.real, samples.imag)).astype(np.float32)
            self._wav.write_float(interleaved)
        else:
            self._fd.write(_encode_iq_raw(samples, self.spec.codec))

    def close(self) -> None:
        if self._wav is not None:
            self._wav.close()
            self._wav = None
        if self._fd is not None:
            self._fd.close()
            self._fd = None


def write_stereo_wav(
    path: Path | str,
    frames: np.ndarray,
    sample_rate: int,
    codec: str = "pcm_s16le",
) -> None:
    """One-shot stereo WAV write (test/benchmark fixture helper)."""
    with WavStreamWriter(path, sample_rate, 2, codec) as w:
        w.write_float(np.asarray(frames, dtype=np.float32))


def read_wav(path: Path | str) -> tuple[np.ndarray, int]:
    """One-shot WAV read returning (frames x channels float32, rate)."""
    from .riff import parse_wav_header

    info = parse_wav_header(path)
    # drop a truncated trailing frame (data-to-EOF semantics make data_size
    # whatever is on disk, incl. a capture cut mid-frame)
    usable = info.data_size - (info.data_size % max(info.bytes_per_frame, 1))
    with Path(path).open("rb") as f:
        f.seek(info.data_offset)
        payload = f.read(usable)
    payload = payload[: len(payload) - (len(payload) % max(info.bytes_per_frame, 1))]
    codec = info.codec
    if codec == "pcm_u8":
        data = (np.frombuffer(payload, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif codec == "pcm_s16le":
        data = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
    elif codec == "pcm_s32le":
        data = np.frombuffer(payload, "<i4").astype(np.float32) / 2147483648.0
    elif codec == "pcm_f32le":
        data = np.frombuffer(payload, "<f4").astype(np.float32)
    elif codec == "pcm_f64le":
        data = np.frombuffer(payload, "<f8").astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAV codec {codec}")
    frames = data.reshape(-1, info.channels)
    return frames, info.sample_rate
