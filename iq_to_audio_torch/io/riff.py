"""Minimal, robust RIFF/WAVE (and RF64) header parser and streaming writer.

First-party replacement for the ffmpeg/ffprobe/libsndfile header handling the
reference shells out to.  Covers everything an SDR baseband recording can
throw at us:

* PCM (format 1), IEEE float (format 3) and WAVE_FORMAT_EXTENSIBLE (0xFFFE,
  resolved via the SubFormat GUID).
* RF64/BW64 64-bit sizes via the ``ds64`` chunk.
* Broken/placeholder ``data`` sizes (SDR++ leaves 0 or 0xFFFFFFFF while
  streaming): when the data chunk extends to end-of-file — the overwhelmingly
  common layout for SDR captures — we read to EOF, matching the reference's
  unconditional ``ffmpeg -ignore_length 1`` (reference ``processing.py:149``).
* LIST/INFO metadata tags (for center-frequency detection).
"""

from __future__ import annotations

import logging
import struct
from dataclasses import dataclass, field
from pathlib import Path

LOG = logging.getLogger(__name__)

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE

# INFO sub-chunk ids -> human tag names (the interesting ones; unknown ids
# pass through with their fourcc lowercased)
_INFO_TAGS = {
    b"INAM": "title",
    b"IART": "artist",
    b"ICMT": "comment",
    b"ICRD": "date",
    b"ISFT": "software",
    b"IPRD": "product",
}


class WavFormatError(ValueError):
    """Raised when a file is not a parsable WAV."""


@dataclass
class WavInfo:
    sample_rate: int
    channels: int
    bits_per_sample: int
    audio_format: int  # resolved (1 PCM / 3 float)
    data_offset: int
    data_size: int  # effective payload bytes (after ignore-length handling)
    declared_data_size: int  # raw size from the data chunk header
    tags: dict[str, str] = field(default_factory=dict)
    #: RF64/BW64 container (sizes may live in a ds64 chunk the streaming
    #: writer cannot re-finalize — append mode rejects these)
    rf64: bool = False

    @property
    def bytes_per_frame(self) -> int:
        return self.channels * (self.bits_per_sample // 8)

    @property
    def num_frames(self) -> int:
        bpf = self.bytes_per_frame
        return self.data_size // bpf if bpf else 0

    @property
    def codec(self) -> str | None:
        """ffmpeg-style codec name, or None if unsupported."""
        if self.audio_format == _WAVE_FORMAT_PCM:
            return {8: "pcm_u8", 16: "pcm_s16le", 24: "pcm_s24le", 32: "pcm_s32le"}.get(
                self.bits_per_sample
            )
        if self.audio_format == _WAVE_FORMAT_IEEE_FLOAT:
            return {32: "pcm_f32le", 64: "pcm_f64le"}.get(self.bits_per_sample)
        return None


def parse_wav_header(path: Path | str) -> WavInfo:
    path = Path(path)
    file_size = path.stat().st_size
    with path.open("rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[0:4] not in (b"RIFF", b"RF64", b"BW64") or riff[8:12] != b"WAVE":
            raise WavFormatError(f"{path} is not a RIFF/WAVE file.")
        is_rf64 = riff[0:4] in (b"RF64", b"BW64")
        ds64_data_size: int | None = None

        fmt: tuple[int, int, int, int] | None = None  # format, channels, rate, bits
        data_offset: int | None = None
        declared_data_size: int | None = None
        tags: dict[str, str] = {}

        pos = 12
        while pos + 8 <= file_size:
            f.seek(pos)
            header = f.read(8)
            if len(header) < 8:
                break
            cid, csize = struct.unpack("<4sI", header)
            body = pos + 8

            if cid == b"ds64" and csize >= 28:
                raw = f.read(min(csize, 28))
                if len(raw) < 16:  # truncated file: chunk body cut short
                    break
                _riff_sz, data_sz = struct.unpack("<QQ", raw[0:16])
                ds64_data_size = data_sz
            elif cid == b"fmt " and csize >= 16:
                raw = f.read(min(csize, 40))
                if len(raw) < 16:  # truncated file: chunk body cut short
                    break
                audio_format, channels, rate, _byte_rate, _align, bits = struct.unpack(
                    "<HHIIHH", raw[0:16]
                )
                if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(raw) >= 26:
                    # cbSize(2) validBits(2) channelMask(4) SubFormat GUID(16)
                    sub = raw[24:26]
                    if len(sub) == 2:
                        audio_format = struct.unpack("<H", sub)[0]
                fmt = (audio_format, channels, rate, bits)
            elif cid == b"data":
                data_offset = body
                declared_data_size = csize
                if (
                    is_rf64
                    and csize in (0, 0xFFFFFFFF)
                    and ds64_data_size is not None
                ):
                    declared_data_size = ds64_data_size
            elif cid == b"LIST" and csize >= 4:
                list_type = f.read(4)
                if list_type == b"INFO":
                    _parse_info_list(f, body + 4, min(csize - 4, 1 << 20), tags)

            step = csize
            if cid == b"data" and is_rf64 and csize in (0, 0xFFFFFFFF):
                if ds64_data_size is None:
                    break  # no ds64: data runs to EOF, nothing follows
                # advance by the TRUE 64-bit size — stepping by the 32-bit
                # placeholder would land the scan inside the payload on
                # >4 GiB captures and random-walk over IQ bytes
                step = ds64_data_size
            advance = step + (step & 1)  # chunks are word-aligned
            if cid == b"data" and (csize == 0 or csize == 0xFFFFFFFF) and not is_rf64:
                break  # placeholder size: data runs to EOF, nothing follows
            pos = body + advance

    if fmt is None or data_offset is None:
        raise WavFormatError(f"{path}: missing fmt/data chunk.")
    audio_format, channels, rate, bits = fmt

    declared = declared_data_size if declared_data_size is not None else 0
    to_eof = max(0, file_size - data_offset)
    if declared == 0 or declared == 0xFFFFFFFF:
        effective = to_eof
    elif data_offset + declared >= file_size:
        # data is the final chunk: trust the file, not the (possibly stale)
        # header — equivalent to ffmpeg's -ignore_length for SDR captures
        effective = to_eof
    else:
        effective = declared

    return WavInfo(
        sample_rate=int(rate),
        channels=int(channels),
        bits_per_sample=int(bits),
        audio_format=int(audio_format),
        data_offset=int(data_offset),
        data_size=int(effective),
        declared_data_size=int(declared),
        tags=tags,
        rf64=is_rf64,
    )


def _parse_info_list(f, start: int, size: int, tags: dict[str, str]) -> None:
    f.seek(start)
    raw = f.read(size)
    pos = 0
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        (csize,) = struct.unpack("<I", raw[pos + 4 : pos + 8])
        value = raw[pos + 8 : pos + 8 + csize]
        try:
            text = value.split(b"\0", 1)[0].decode("utf-8", errors="replace").strip()
        except Exception:
            text = ""
        if text:
            key = _INFO_TAGS.get(cid, cid.decode("ascii", errors="replace").strip().lower())
            tags[key] = text
        pos += 8 + csize + (csize & 1)


# ---------------------------------------------------------------------------
# Streaming writer
# ---------------------------------------------------------------------------

_CODEC_FMT = {
    "pcm_u8": (_WAVE_FORMAT_PCM, 8),
    "pcm_s16le": (_WAVE_FORMAT_PCM, 16),
    "pcm_f32le": (_WAVE_FORMAT_IEEE_FLOAT, 32),
}


class WavStreamWriter:
    """Streaming WAV writer: header with placeholder sizes, patched on close.

    ``append=True`` reopens an existing WAV (same rate/channels/codec) and
    continues after its last frame — used by checkpoint/resume.
    """

    def __init__(
        self,
        path: Path | str,
        sample_rate: int,
        channels: int,
        codec: str,
        *,
        append: bool = False,
    ):
        if codec not in _CODEC_FMT:
            raise ValueError(f"Unsupported WAV writer codec: {codec}")
        self.path = Path(path)
        self.codec = codec
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        fmt, bits = _CODEC_FMT[codec]
        self._fmt = fmt
        self._bits = bits
        self._data_bytes = 0
        if append and self.path.exists():
            info = parse_wav_header(self.path)
            if info.rf64:
                # close() patches only the 32-bit RIFF/data fields; an RF64
                # file's true sizes live in its ds64 chunk, which would go
                # stale and hide every appended sample from readers
                raise ValueError(
                    f"Cannot append to {self.path}: RF64/BW64 containers "
                    "cannot be re-finalized by the streaming writer."
                )
            if (
                info.sample_rate != self.sample_rate
                or info.channels != self.channels
                or info.codec != codec
            ):
                raise ValueError(
                    f"Cannot append to {self.path}: existing format "
                    f"{info.codec}@{info.sample_rate}x{info.channels} does not match."
                )
            self._data_bytes = info.data_size
            self._data_offset = info.data_offset
            self._fd = self.path.open("r+b")
            self._fd.seek(info.data_offset + info.data_size)
        else:
            self._fd = self.path.open("wb")
            self._write_header(0)
            self._data_offset = 44  # canonical RIFF/fmt/data layout

    def _write_header(self, data_size: int) -> None:
        bits = self._bits
        block_align = self.channels * bits // 8
        byte_rate = self.sample_rate * block_align
        self._fd.write(b"RIFF")
        self._fd.write(struct.pack("<I", 36 + data_size))
        self._fd.write(b"WAVE")
        self._fd.write(b"fmt ")
        self._fd.write(
            struct.pack(
                "<IHHIIHH", 16, self._fmt, self.channels, self.sample_rate, byte_rate, block_align, bits
            )
        )
        self._fd.write(b"data")
        self._fd.write(struct.pack("<I", data_size))

    def write_raw(self, payload: bytes) -> None:
        self._fd.write(payload)
        self._data_bytes += len(payload)

    def write_float(self, samples) -> None:
        """Encode float32 samples (frames x channels or flat) per codec."""
        import numpy as np

        arr = np.asarray(samples, dtype=np.float32).reshape(-1)
        if self.codec == "pcm_f32le":
            self.write_raw(arr.astype("<f4", copy=False).tobytes())
        elif self.codec == "pcm_s16le":
            scaled = np.round(np.clip(arr, -1.0, 0.999969) * 32767.0)
            self.write_raw(scaled.astype("<i2").tobytes())
        elif self.codec == "pcm_u8":
            scaled = np.clip(arr, -1.0, 1.0)
            self.write_raw(np.round((scaled + 1.0) * 127.5).astype(np.uint8).tobytes())

    def close(self) -> None:
        """Patch the two size fields in place.

        Only the RIFF size (offset 4) and the data size (data_offset - 4)
        are touched — an appended file may carry LIST/INFO or extensible
        fmt chunks before data, and rewriting a canonical 44-byte header
        over them would shift the stream.  Payloads past the 32-bit RIFF
        limit get placeholder sizes (this parser, ffmpeg -ignore_length
        and most SDR tools read such data chunks to EOF)."""
        if self._fd is None:
            return
        try:
            riff_size = self._data_offset - 8 + self._data_bytes
            data_size = self._data_bytes
            if riff_size > 0xFFFFFFFE:
                LOG.warning(
                    "%s payload (%d bytes) exceeds the 32-bit RIFF limit; "
                    "writing placeholder sizes (data runs to EOF).",
                    self.path,
                    self._data_bytes,
                )
                riff_size = data_size = 0xFFFFFFFF
            self._fd.seek(4)
            self._fd.write(struct.pack("<I", riff_size))
            self._fd.seek(self._data_offset - 4)
            self._fd.write(struct.pack("<I", data_size))
        finally:
            self._fd.close()
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
