"""The port's capture reader (``iq_to_audio_torch/io/reader.py``):
``read_into``, which fills a caller's array with the next block, against
the JAX package's ``IQReader.read_block_raw`` on the same file and against
the payload's bytes as ``np.fromfile`` reads them."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from iq_to_audio_torch.io.formats import get_format
from iq_to_audio_torch.io.reader import IQReader
from iq_to_audio_torch.io.writer import write_stereo_wav
from iq_to_audio_tpu.io import formats as jformats
from iq_to_audio_tpu.io import reader as jreader
from iq_to_audio_tpu.io.riff import parse_wav_header

FS = 250_000.0
FRAMES = 10_007  # a prime: no chunk below divides it
# (container, codec, chunk size in frames)
FORMATS = [("wav", "pcm_s16le", 4_096), ("raw", "pcm_u8", 1_000), ("raw", "pcm_f32le", 3_333)]
IDS = [f"{c}-{k}" for c, k, _ in FORMATS]


def capture(tmp_path: Path, container: str, codec: str) -> Path:
    rng = np.random.default_rng(7)
    iq = rng.uniform(-0.9, 0.9, (FRAMES, 2)).astype(np.float32)
    if container == "wav":
        path = tmp_path / "cap.wav"
        write_stereo_wav(path, iq, int(FS), codec=codec)
    elif codec == "pcm_u8":
        path = tmp_path / "cap.cu8"
        np.round(iq * 127 + 128).astype(np.uint8).tofile(path)
    else:
        path = tmp_path / "cap.cf32"
        iq.tofile(path)
    return path


def reader(path: Path, container: str, codec: str, chunk: int, **kw) -> IQReader:
    kw.setdefault("prefetch_depth", 0)
    rate = FS if container == "raw" else None
    return IQReader(path, chunk, "iq", get_format(container, codec), sample_rate=rate, **kw)


def jax_reader(path: Path, container: str, codec: str, chunk: int, **kw) -> jreader.IQReader:
    """The JAX package's reader on the same file: the reference side."""
    rate = FS if container == "raw" else None
    fmt = jformats.get_format(container, codec)
    return jreader.IQReader(path, chunk, "iq", fmt, sample_rate=rate, prefetch_depth=0, **kw)


def blocks(r: jreader.IQReader) -> list[np.ndarray]:
    out = []
    while (block := r.read_block_raw()) is not None:
        out.append(block.copy())
    return out


def payload(path: Path, container: str, codec: str) -> np.ndarray:
    """The capture's interleaved samples, straight from the file."""
    dtype = {"pcm_s16le": np.int16, "pcm_u8": np.uint8, "pcm_f32le": np.float32}[codec]
    offset = parse_wav_header(path).data_offset if container == "wav" else 0
    return np.fromfile(path, dtype, 2 * FRAMES, offset=offset)


def filled(r: IQReader, chunk: int, max_frames=None) -> list[np.ndarray]:
    """Every block through one reused array, as ``read_into`` leaves it."""
    dest = np.empty(2 * chunk, r.raw_dtype)
    out = []
    while n := r.read_into(dest, max_frames):
        out.append(dest[: 2 * n].copy())
    return out


def same(a: list[np.ndarray], b: list[np.ndarray]) -> None:
    assert [x.size for x in a] == [x.size for x in b]
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("container, codec, chunk", FORMATS, ids=IDS)
def test_read_into_matches_read_block_raw(tmp_path, container, codec, chunk):
    path = capture(tmp_path, container, codec)
    with jax_reader(path, container, codec, chunk) as r:
        want = blocks(r)
    with reader(path, container, codec, chunk) as r:
        got = filled(r, chunk)
    same(got, want)
    whole = payload(path, container, codec)
    assert np.concatenate(got).tobytes() == whole.tobytes()
    assert got[-1].size == 2 * (FRAMES % chunk)  # the short last block
    # from a resume offset too
    with jax_reader(path, container, codec, chunk, start_frame=1_234) as r:
        want = blocks(r)
    with reader(path, container, codec, chunk, start_frame=1_234) as r:
        got = filled(r, chunk)
    same(got, want)
    assert np.concatenate(got).tobytes() == whole[2 * 1_234 :].tobytes()


class Trickle:
    """A file whose ``readinto`` returns at most ``cap`` bytes a call, as
    NFS or FUSE may: frames straddle calls."""

    def __init__(self, fd, cap: int):
        self.fd, self.cap, self.calls = fd, cap, 0

    def readinto(self, view) -> int:
        self.calls += 1
        return self.fd.readinto(view[: self.cap])

    def close(self) -> None:
        self.fd.close()


@pytest.mark.parametrize("container, codec, chunk", FORMATS, ids=IDS)
def test_short_readinto_returns_are_refilled(tmp_path, container, codec, chunk):
    path = capture(tmp_path, container, codec)
    with jax_reader(path, container, codec, chunk) as r:
        want = blocks(r)
    for cap in (3, 1_001):
        with reader(path, container, codec, chunk) as r:
            r._fd = Trickle(r._fd, cap)
            got = filled(r, chunk)
            assert r._fd.calls > len(got)
        same(got, want)


def test_a_budget_caps_the_frames_read(tmp_path):
    container, codec, chunk = FORMATS[0]
    path = capture(tmp_path, container, codec)
    whole = payload(path, container, codec)
    with reader(path, container, codec, chunk) as r:
        dest = np.full(2 * chunk, -1, r.raw_dtype)
        assert r.read_into(dest, 0) == 0  # reads nothing, ends nothing
        assert (dest == -1).all()
        assert r.read_into(dest, 5) == 5
        assert dest[:10].tobytes() == whole[:10].tobytes()
        assert (dest[10:] == -1).all()  # the rest of the array is left as it was
        assert r.read_into(dest, 10 * chunk) == chunk  # never more than a chunk
        assert dest.tobytes() == whole[10 : 10 + 2 * chunk].tobytes()
        got = 5 + chunk
        while n := r.read_into(dest, 1_000):
            assert dest[: 2 * n].tobytes() == whole[2 * got : 2 * (got + n)].tobytes()
            got += n
    assert got == FRAMES


@pytest.mark.parametrize("cut", [1, 3], ids=["one byte", "three bytes"])
def test_a_truncated_final_frame_is_dropped(tmp_path, cut):
    """The capture loses bytes after the reader opened it: the last whole
    frame is the last one read, by the port and by the JAX package, and the
    end stays."""
    container, codec, chunk = FORMATS[0]
    path = capture(tmp_path, container, codec)
    whole = payload(path, container, codec)
    size = path.stat().st_size
    with jax_reader(path, container, codec, chunk) as r:
        with path.open("r+b") as f:
            f.truncate(size - cut)  # 4-byte frames: the last one loses `cut`
        want = blocks(r)
    with path.open("r+b") as f:
        f.truncate(size)
    with reader(path, container, codec, chunk) as r:
        with path.open("r+b") as f:
            f.truncate(size - cut)
        got = filled(r, chunk)
        assert r.read_into(np.empty(2 * chunk, r.raw_dtype)) == 0
    same(got, want)
    assert np.concatenate(got).tobytes() == whole[: 2 * (FRAMES - 1)].tobytes()


def test_a_lone_partial_frame_is_the_end(tmp_path):
    container, codec, chunk = FORMATS[0]
    path = capture(tmp_path, container, codec)
    size = path.stat().st_size
    with reader(path, container, codec, chunk, start_frame=FRAMES - 1) as r:
        with path.open("r+b") as f:
            f.truncate(size - 2)  # half of the one frame left
        dest = np.empty(2 * chunk, r.raw_dtype)
        assert r.read_into(dest) == 0
        assert r.read_into(dest) == 0


@pytest.mark.parametrize("container, codec, chunk", FORMATS, ids=IDS)
def test_eof_is_idempotent(tmp_path, container, codec, chunk):
    path = capture(tmp_path, container, codec)
    with reader(path, container, codec, chunk) as r:
        filled(r, chunk)
        dest = np.full(2 * chunk, 7, r.raw_dtype)
        for _ in range(3):
            assert r.read_into(dest) == 0
            assert r.read_into(dest, 1) == 0
            assert r.read_block_raw() is None
        assert (dest == 7).all()


def test_read_into_refuses_a_prefetching_reader_and_a_wrong_array(tmp_path):
    container, codec, chunk = FORMATS[0]
    path = capture(tmp_path, container, codec)
    dest = np.empty(2 * chunk, np.int16)
    with pytest.raises(RuntimeError, match="not been entered"):
        reader(path, container, codec, chunk).read_into(dest)
    with reader(path, container, codec, chunk, prefetch_depth=2) as r:
        with pytest.raises(RuntimeError, match="without prefetch"):
            r.read_into(dest)
        assert r.read_block_raw().size == 2 * chunk  # the prefetch path still reads
    with reader(path, container, codec, chunk) as r:
        with pytest.raises(ValueError, match="C-contiguous"):
            r.read_into(np.empty(2 * chunk, np.float32))
        with pytest.raises(ValueError, match="C-contiguous"):
            r.read_into(np.empty(4 * chunk, np.int16)[::2])
        with pytest.raises(ValueError, match="cannot hold"):
            r.read_into(np.empty(2 * chunk - 2, np.int16))
        assert r.read_into(np.empty(10, np.int16), 5) == 5  # big enough for its budget
