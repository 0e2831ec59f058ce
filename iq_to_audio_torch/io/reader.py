"""Chunked IQ ingest with background prefetch.

First-party replacement for the reference's ffmpeg-subprocess reader
(reference ``processing.py:84-279``).  The payload formats are trivial PCM,
so no external decoder is needed:

* WAV (pcm_u8 / pcm_s16le / pcm_f32le) via the RIFF parser — including
  broken/streaming headers (the ``-ignore_length`` equivalent).
* Raw interleaved cu8/cs16/cf32.

The reader hands out *raw interleaved* blocks (uint8/int16/float32); sample
conversion and I/Q de-interleaving happen **on device** inside the torch
chunk step — uploading s16 halves PCIe traffic versus complex64.  The
``read_block()``/iterator API additionally offers host-side complex64
conversion for analysis paths and warm-up probes (same conversion rules as
ffmpeg: u8 -> (x-128)/128, s16 -> x/32768).

A daemon prefetch thread keeps ``prefetch_depth`` chunks in flight so disk IO
overlaps device compute (the reference gets the same overlap from the ffmpeg
process pipe).
"""

from __future__ import annotations

import logging
import queue
import threading
from collections.abc import Iterator
from pathlib import Path

import numpy as np

from .formats import InputFormatSpec
from .riff import parse_wav_header

LOG = logging.getLogger(__name__)

_CODEC_DTYPE = {
    "pcm_u8": np.dtype(np.uint8),
    "pcm_s16le": np.dtype("<i2"),
    "pcm_f32le": np.dtype("<f4"),
}

_SENTINEL = object()


def convert_to_complex(raw: np.ndarray, codec: str, iq_order: str = "iq") -> np.ndarray:
    """Host-side conversion of raw interleaved samples to complex64.

    Mirrors ffmpeg's integer->float scaling and the reference's IQ-order
    handling (reference ``processing.py:268-279``).
    """
    if iq_order not in {"iq", "qi", "iq_inv", "qi_inv"}:
        raise ValueError(f"Unsupported iq_order '{iq_order}'")
    from .native import convert_deinterleave

    pair = convert_deinterleave(raw, codec, iq_order)
    if pair is not None:
        # assemble in place: pair is float32, so one complex64 allocation
        # and two stride-2 stores
        out = np.empty(pair[0].shape, dtype=np.complex64)
        out.real = pair[0]
        out.imag = pair[1]
        return out
    if codec == "pcm_u8":
        f = (raw.astype(np.float32) - 128.0) * np.float32(1.0 / 128.0)
    elif codec == "pcm_s16le":
        f = raw.astype(np.float32) * np.float32(1.0 / 32768.0)
    elif codec == "pcm_f32le":
        f = np.asarray(raw, dtype=np.float32)
    else:
        raise ValueError(f"Unsupported codec '{codec}'")
    if iq_order.startswith("iq"):
        i, q = f[0::2], f[1::2]
    else:
        q, i = f[0::2], f[1::2]
    if iq_order.endswith("_inv"):
        q = -q
    return (i + 1j * q).astype(np.complex64)


class IQReader:
    """Stream fixed-size raw blocks from a WAV or raw IQ recording."""

    def __init__(
        self,
        path: Path,
        chunk_size: int,
        iq_order: str,
        input_format: InputFormatSpec,
        *,
        sample_rate: float | None = None,
        prefetch_depth: int = 2,
        start_frame: int = 0,
    ):
        self.path = Path(path)
        self.chunk_size = int(chunk_size)  # complex frames per block
        self.iq_order = iq_order
        self.input_format = input_format
        self.sample_rate = sample_rate
        #: 0 disables the prefetch thread (synchronous reads) — page-cache
        #: reads are cheap, and a busy Python thread can interfere with the
        #: accelerator dispatch path on high-latency runtimes
        self.prefetch_depth = max(0, prefetch_depth)
        self.start_frame = max(0, int(start_frame))  # resume offset
        self._remaining = 0
        self._dtype = _CODEC_DTYPE[input_format.codec]
        self._payload_offset = 0
        self._payload_size = 0
        self._fd = None
        self._queue: queue.Queue | None = None
        self._eof = False  # prefetch-mode sentinel already consumed
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._error: BaseException | None = None

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "IQReader":
        if self.input_format.container == "raw":
            if self.sample_rate is None or self.sample_rate <= 0:
                raise ValueError(
                    "Raw IQ inputs require a sample rate override. "
                    "Provide --input-sample-rate or set it in the GUI."
                )
            self._payload_offset = 0
            self._payload_size = self.path.stat().st_size
        else:
            info = parse_wav_header(self.path)
            if info.channels != 2:
                raise ValueError(
                    f"IQ WAV input must be stereo (I/Q); {self.path} has "
                    f"{info.channels} channel(s)."
                )
            self._payload_offset = info.data_offset
            self._payload_size = info.data_size
        frame_bytes = self.input_format.bytes_per_frame
        self._payload_size -= self._payload_size % frame_bytes
        if self.start_frame:
            skip = min(self.start_frame * frame_bytes, self._payload_size)
            self._payload_offset += skip
            self._payload_size -= skip
        self._fd = self.path.open("rb", buffering=0)
        self._fd.seek(self._payload_offset)
        self._remaining = self._payload_size
        self._eof = False
        self._stop.clear()
        # re-entry support: a stale error/queue from a previous pass must
        # not poison a clean second pass (the error would otherwise
        # resurface at the fresh run's EOF sentinel)
        self._error = None
        self._queue = None
        if self.prefetch_depth > 0:
            self._queue = queue.Queue(maxsize=self.prefetch_depth)
            self._thread = threading.Thread(
                target=self._producer, name="IQReader-prefetch", daemon=True
            )
            self._thread.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()

    def close(self) -> None:
        self._stop.set()
        if self._queue is not None:
            # unblock the producer if it is waiting to put
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=2)
        self._thread = None
        if self._fd is not None:
            self._fd.close()
            self._fd = None

    def seek_frame(self, frame: int) -> None:
        """Move a synchronous reader (``prefetch_depth=0``) to complex frame
        ``frame`` of the payload (counted from ``start_frame``): the next
        block starts there.  A sequence-parallel rank reads its own slice
        of every chunk this way."""
        if self._fd is None:
            raise RuntimeError("IQReader has not been entered.")
        if self._queue is not None:
            raise RuntimeError("seek_frame needs a reader without prefetch")
        skip = min(max(0, int(frame)) * self.input_format.bytes_per_frame, self._payload_size)
        self._fd.seek(self._payload_offset + skip)
        self._remaining = self._payload_size - skip

    # -- streaming ---------------------------------------------------------

    @property
    def total_frames(self) -> int:
        """Exact number of complex frames in the payload."""
        return self._payload_size // self.input_format.bytes_per_frame

    @property
    def raw_dtype(self) -> np.dtype:
        return self._dtype

    def _producer(self) -> None:
        try:
            while not self._stop.is_set():
                arr = self._read_block_owned()
                if arr is None:
                    break
                self._put(arr)
        except BaseException as exc:  # surfaced on next consumer read
            self._error = exc
        finally:
            self._put(_SENTINEL)

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _read_block_owned(self) -> np.ndarray | None:
        """Read the next block into a FRESH owned, aligned numpy array.

        Owned contiguous buffers matter: accelerator runtimes take a
        zero-copy/pinned fast path for them, while `np.frombuffer` views
        over `bytes` can fall into a slow chopped-copy transfer path.
        """
        want = min(self.chunk_size * self.input_format.bytes_per_frame, self._remaining)
        if want <= 0:
            return None
        arr = np.empty(want // self._dtype.itemsize, dtype=self._dtype)
        frames = self._read_into(arr, self.chunk_size)
        if not frames:
            return None
        return arr if 2 * frames == arr.size else arr[: 2 * frames]

    def _read_into(self, dest: np.ndarray, frames: int) -> int:
        """Read up to ``frames`` whole frames into the start of ``dest``;
        returns the frames read, 0 at EOF."""
        frame_bytes = self.input_format.bytes_per_frame
        want = min(frames * frame_bytes, self._remaining)
        if want <= 0:
            return 0
        # refill until full or true EOF: a single readinto can return short
        # on NFS/FUSE or for very large requests, and treating that as the
        # block end would drop partial-frame bytes mid-stream (every later
        # frame then starts mid-pair — silent I/Q swap for the rest of the
        # capture)
        view = memoryview(dest).cast("B")[:want]
        got = 0
        while got < want:
            n = self._fd.readinto(view[got:])
            if not n:
                break
            got += n
        if not got:
            self._remaining = 0
            return 0
        self._remaining -= got
        usable = got - (got % frame_bytes)
        if usable <= 0:
            self._remaining = 0  # truncated final frame: genuine EOF
        return usable // frame_bytes

    def read_into(self, dest: np.ndarray, max_frames: int | None = None) -> int:
        """Read the next block into ``dest``, a caller's C-contiguous array
        of the codec's dtype (:attr:`raw_dtype`), from its start: at most
        ``min(chunk_size, max_frames)`` frames.  Returns the frames read, 0
        at EOF (and at every call after it); ``dest`` beyond them is left
        as it was.  The chunk loop reads each block straight into its
        pinned upload slot this way.  Needs a reader without prefetch."""
        if self._fd is None:
            raise RuntimeError("IQReader has not been entered.")
        if self._queue is not None:
            raise RuntimeError("read_into needs a reader without prefetch")
        frames = self.chunk_size if max_frames is None else min(self.chunk_size, max_frames)
        frames = max(0, int(frames))
        if dest.dtype != self._dtype or not dest.flags.c_contiguous:
            raise ValueError(f"read_into needs a C-contiguous {self._dtype} array")
        if dest.size < 2 * frames:
            raise ValueError(f"read_into: {dest.size} samples cannot hold {frames} frames")
        return self._read_into(dest, frames)

    def read_block_raw(self) -> np.ndarray | None:
        """Next raw interleaved block (dtype per codec), or None at EOF.

        Idempotent at EOF in both modes: the prefetch queue holds a single
        sentinel, so a consumed-EOF flag keeps later calls returning None
        instead of blocking on the empty queue forever."""
        if self._fd is None:
            raise RuntimeError("IQReader has not been entered.")
        if self._queue is None:
            return self._read_block_owned()
        if self._eof:
            return None
        item = self._queue.get()
        if item is _SENTINEL:
            self._eof = True
            if self._error is not None:
                raise RuntimeError(f"IQ read failed: {self._error}") from self._error
            return None
        return item

    def read_block(self) -> np.ndarray | None:
        """Next block as complex64 (host-side conversion), or None at EOF."""
        raw = self.read_block_raw()
        if raw is None:
            return None
        return convert_to_complex(raw, self.input_format.codec, self.iq_order)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            block = self.read_block()
            if block is None or block.size == 0:
                return
            yield block

    def iter_raw(self) -> Iterator[np.ndarray]:
        while True:
            block = self.read_block_raw()
            if block is None or block.size == 0:
                return
            yield block
