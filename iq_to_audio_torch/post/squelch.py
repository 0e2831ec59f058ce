"""Batch audio squelch and silence trimming.

Feature parity with the reference post-processor (reference
``squelch.py``): static, adaptive and transient gating, hold-time
opening of the mask, fade ramps at gate edges, lead/trail trimming,
and per-file plus batch summaries. Everything is plain vectorised
NumPy — audio-rate gating is host-trivial compared to the IQ pipeline,
so nothing here touches the accelerator.  This module is the port's
own copy of the JAX package's ``post/squelch.py`` (which imports no JAX):
the same float32 arithmetic, so the two write the same bytes.

IO: WAV containers go through the first-party reader/writer (primary
path, no external dependency).  Anything else libsndfile handles
(flac/ogg/aiff/..., reference ``squelch.py:272-289``) is read and
written through the optional ``soundfile`` package when it is
importable; without it such files are skipped with a LOUD per-file log
line naming the missing dependency, never silently.
"""

from __future__ import annotations

import logging
import os
from collections.abc import Callable, Iterable, Iterator, Sequence
from dataclasses import dataclass
from pathlib import Path
from typing import Literal

import numpy as np

from ..io.riff import WavStreamWriter, parse_wav_header
from ..io.writer import read_wav

LOG = logging.getLogger(__name__)

SquelchMethod = Literal["adaptive", "static", "transient"]

_DB_FLOOR = -160.0
_TINY = 1e-10
_GATE_OPEN_EPS = 1e-3  # gain above this counts as "gate open" for trimming


# --------------------------------------------------------------------------
# configuration / results
# --------------------------------------------------------------------------


@dataclass(slots=True)
class SquelchConfig:
    """Gate tuning knobs; defaults mirror the reference CLI defaults."""

    method: SquelchMethod = "adaptive"
    auto_noise_floor: bool = True
    manual_noise_floor_db: float | None = None
    noise_floor_percentile: float = 0.2
    threshold_margin_db: float = 6.0
    window_seconds: float = 0.04
    transient_window_seconds: float = 0.012
    transient_margin_db: float = 8.0
    hold_seconds: float = 0.12
    fade_seconds: float = 0.01
    trim_silence: bool = True
    trim_lead_seconds: float = 0.15
    trim_trail_seconds: float = 0.35

    def resolve_noise_floor(self, envelope_db: np.ndarray) -> float:
        """Noise floor in dBFS: auto (envelope percentile) or manual."""
        if self.auto_noise_floor:
            q = 100.0 * float(np.clip(self.noise_floor_percentile, 0.0, 1.0))
            return float(np.percentile(envelope_db, q))
        if self.manual_noise_floor_db is None:
            raise ValueError(
                "manual_noise_floor_db must be provided when auto_noise_floor=False."
            )
        return float(self.manual_noise_floor_db)


# formats the optional soundfile (libsndfile) fallback can read
_SOUNDFILE_SUFFIXES = (
    ".flac", ".ogg", ".oga", ".opus", ".aiff", ".aif", ".aifc",
    ".au", ".snd", ".caf", ".w64", ".rf64", ".voc", ".mp3",
)


def _soundfile():
    """The optional ``soundfile`` module, or None when not installed."""
    try:
        import soundfile
    except ImportError:
        return None
    return soundfile


def supported_suffixes() -> tuple[str, ...]:
    """Suffixes the current environment can actually process."""
    if _soundfile() is not None:
        return (".wav", *_SOUNDFILE_SUFFIXES)
    return (".wav",)


@dataclass(slots=True)
class AudioPostOptions:
    config: SquelchConfig
    overwrite: bool = False
    cleaned_suffix: str = "-cleaned"
    # empty = everything the environment supports (see supported_suffixes)
    allowed_suffixes: Sequence[str] = ()
    #: WAV inputs whose data payload exceeds this many bytes are squelched
    #: by the bounded-memory streaming engine instead of a whole-file load
    #: (the reference loads everything, ``squelch.py:272-279``, and OOMs on
    #: multi-GB session recordings).  None -> $IQ2A_POST_BLOCK_BYTES, else
    #: 256 MiB.  Outputs are bit-identical either way.
    stream_threshold_bytes: int | None = None


@dataclass(slots=True)
class SquelchFileResult:
    input_path: Path
    output_path: Path
    samples_in: int
    samples_out: int
    duration_in: float
    duration_out: float
    bytes_in: int
    bytes_out: int
    noise_floor_db: float
    threshold_db: float
    method: SquelchMethod
    retained_ratio: float


@dataclass(slots=True)
class SquelchSummary:
    results: list[SquelchFileResult]
    errors: list[tuple[Path, Exception]]

    @property
    def processed(self) -> int:
        return len(self.results)

    @property
    def failed(self) -> int:
        return len(self.errors)

    @property
    def total(self) -> int:
        return self.processed + self.failed

    def aggregate_duration_delta(self) -> float:
        return float(sum(r.duration_out - r.duration_in for r in self.results))

    def aggregate_size_delta(self) -> int:
        return int(sum(r.bytes_out - r.bytes_in for r in self.results))


# --------------------------------------------------------------------------
# envelope + mask construction
# --------------------------------------------------------------------------


def _as_frames(audio: np.ndarray) -> np.ndarray:
    """Coerce to (frames, channels) float32."""
    x = np.asarray(audio, dtype=np.float32)
    if x.ndim == 1:
        return x[:, None]
    if x.ndim == 2:
        return x
    raise ValueError(f"Expected mono/stereo audio, received shape {x.shape!r}.")


#: canonical block grid for the sliding-mean evaluation.  The in-memory and
#: the streaming paths both compute the envelope block-by-block on THIS
#: absolute grid (local float64 cumsum per block), so their outputs are
#: bit-identical — a single whole-signal cumsum would round differently
#: from any blocked evaluation and make streamed runs diverge by ulps.
_ENV_BLOCK = 1 << 20


def _box_mean_block(
    x_ctx: np.ndarray, ctx_start: int, width: int, b0: int, b1: int, n: int
) -> np.ndarray:
    """Sliding-mean outputs ``[b0, b1)`` of the GLOBAL length-``n`` signal,
    given the context slice ``x_ctx = x[ctx_start : ctx_start + len(x_ctx)]``
    (which must cover ``[b0 + lead + 1 - width, b1 + lead)`` clamped to the
    signal).  Semantics match ``np.convolve(mode="same")`` zero padding."""
    lead = (width - 1) // 2  # np.convolve("same") centre offset
    cs = np.zeros(x_ctx.size + 1, dtype=np.float64)
    np.cumsum(x_ctx, dtype=np.float64, out=cs[1:])
    idx = np.arange(b0, b1)
    hi = np.minimum(idx + lead + 1, n) - ctx_start
    lo = np.maximum(idx + lead + 1 - width, 0) - ctx_start
    out = (cs[hi] - cs[lo]) * (1.0 / width)
    return out.astype(np.float32)


def _box_mean(x: np.ndarray, width: int) -> np.ndarray:
    """Sliding mean with ``np.convolve(mode="same")`` zero-pad semantics,
    evaluated in O(N) via blocked float64 cumulative sums — the direct
    convolution is O(N*width) and a 10-minute 48 kHz capture with the
    ~1920-tap window would cost ~5e10 multiply-adds per envelope."""
    x = np.asarray(x, dtype=np.float32)
    # cap at the signal length: convolve(mode="same") returns max(len, width)
    # values, and a gain vector longer than the frames breaks broadcasting
    # for sub-window-length clips
    width = min(max(int(width), 1), max(x.size, 1))
    if width == 1:
        return x
    n = x.size
    lead = (width - 1) // 2
    out = np.empty(n, np.float32)
    for b0 in range(0, n, _ENV_BLOCK):
        b1 = min(b0 + _ENV_BLOCK, n)
        c0 = max(b0 + lead + 1 - width, 0)
        c1 = min(b1 + lead, n)
        out[b0:b1] = _box_mean_block(x[c0:c1], c0, width, b0, b1, n)
    return out


def _envelope(frames: np.ndarray, width: int) -> np.ndarray:
    """Smoothed channel-mean magnitude envelope."""
    mag = np.mean(np.abs(frames), axis=1, dtype=np.float64)
    return _box_mean(mag.astype(np.float32), width)


def _to_db(x: np.ndarray) -> np.ndarray:
    lvl = 20.0 * np.log10(np.maximum(np.asarray(x, dtype=np.float64), _TINY))
    return np.maximum(lvl, _DB_FLOOR).astype(np.float32)


def _mask_static(env_db, threshold_db, frames, fs, cfg):
    return env_db >= threshold_db


def _adaptive_local_threshold(rel, threshold_db, lo, hi):
    """Per-sample adaptive threshold from the relative-lift score — shared
    verbatim by the in-memory and streaming paths so their float dtype
    promotions (and therefore outputs) are identical."""
    score = (rel - lo) / max(hi - lo, 1e-6)
    local_thr = np.clip(
        threshold_db + 6.0 * (1.0 - score), threshold_db - 6.0, threshold_db + 6.0
    )
    return local_thr.astype(np.float32)


def _mask_adaptive(env_db, threshold_db, frames, fs, cfg):
    coarse = env_db >= threshold_db
    if not coarse.any():
        return coarse
    # score each sample by how far the envelope sits above its running
    # minimum, normalised to the 5th..95th percentile span, then let the
    # threshold breathe ±6 dB against that score
    rel = env_db - np.minimum.accumulate(env_db)
    lo, hi = (np.percentile(rel, q) for q in (5.0, 95.0))
    return env_db >= _adaptive_local_threshold(rel, threshold_db, lo, hi)


def _mask_transient(env_db, threshold_db, frames, fs, cfg):
    fast_w = max(1, round(cfg.transient_window_seconds * fs))
    slow_w = max(fast_w * 4, round(cfg.window_seconds * fs))
    fast_db = _to_db(_envelope(frames, fast_w))
    slow_db = _to_db(_envelope(frames, slow_w) + _TINY)
    return np.asarray(fast_db - slow_db >= cfg.transient_margin_db, dtype=bool)


_MASK_BUILDERS = {
    "static": _mask_static,
    "adaptive": _mask_adaptive,
    "transient": _mask_transient,
}


# --------------------------------------------------------------------------
# gating
# --------------------------------------------------------------------------


def _hold_open(mask: np.ndarray, before: int, after: int) -> np.ndarray:
    """Keep the gate open ``before``/``after`` samples around every active
    sample (morphological dilation via an interval difference array)."""
    if (before <= 0 and after <= 0) or not mask.any():
        return mask
    active = np.flatnonzero(mask)
    bumps = np.zeros(mask.size + 1, dtype=np.int64)
    np.add.at(bumps, np.maximum(active - before, 0), 1)
    np.add.at(bumps, np.minimum(active + after + 1, mask.size), -1)
    return np.cumsum(bumps[:-1]) > 0


def _fade_gain(mask: np.ndarray, fade: int) -> np.ndarray:
    """Boolean mask -> float gain with triangular ramps at gate edges.

    Parity note: like the reference (``squelch.py:85-96``, same
    max-normalised kernel + clip), the effective ramp saturates in
    ~sqrt(2*fade) samples rather than ``fade`` — the clip of an
    unnormalised triangular convolution IS the documented gate shape, so
    it is kept bit-for-bit rather than "fixed" into a different curve."""
    gate = mask.astype(np.float32, copy=False)
    if fade <= 0:
        return gate
    up = np.linspace(0.0, 1.0, fade + 1, dtype=np.float32)
    tri = np.concatenate((up[:-1], [np.float32(1.0)], up[1:][::-1]))
    tri /= float(tri.max(initial=1.0))
    half = tri.size // 2
    padded = np.pad(gate, half, mode="edge")
    ramped = np.convolve(padded, tri, mode="same")
    if half > 0:
        ramped = ramped[half:-half]
    return np.clip(ramped, 0.0, 1.0).astype(np.float32, copy=False)


def _trim_to_activity(
    frames: np.ndarray, gain: np.ndarray, fs: float, lead_s: float, trail_s: float
) -> np.ndarray:
    open_idx = np.flatnonzero(gain > _GATE_OPEN_EPS)
    if open_idx.size == 0:
        return frames[:0].copy()
    first = max(0, int(open_idx[0]) - max(0, round(fs * lead_s)))
    last = min(frames.shape[0], int(open_idx[-1]) + max(0, round(fs * trail_s)) + 1)
    return frames[first:last].copy()


def apply_squelch(
    audio: np.ndarray,
    sample_rate: float,
    config: SquelchConfig,
) -> tuple[np.ndarray, float, float]:
    """Gate + (optionally) trim ``audio``.

    Returns ``(cleaned_frames, noise_floor_db, threshold_db)``.
    """
    frames = _as_frames(audio)
    if frames.shape[0] == 0:
        # empty input (e.g. a previous run trimmed everything): nothing to
        # gate, and np.percentile on an empty envelope would raise
        return frames.astype(np.float32, copy=False), _DB_FLOOR, _DB_FLOOR
    env_db = _to_db(_envelope(frames, max(1, round(config.window_seconds * sample_rate))))
    floor_db = config.resolve_noise_floor(env_db)
    threshold_db = floor_db + config.threshold_margin_db

    try:
        build = _MASK_BUILDERS[config.method]
    except KeyError:
        raise ValueError(f"Unsupported squelch method: {config.method}") from None
    mask = build(env_db, threshold_db, frames, sample_rate, config)

    hold = round(sample_rate * config.hold_seconds)
    gain = _fade_gain(
        _hold_open(mask, hold, hold), round(sample_rate * config.fade_seconds)
    )
    gated = frames * gain[:, None]

    if config.trim_silence:
        gated = _trim_to_activity(
            gated, gain, sample_rate, config.trim_lead_seconds, config.trim_trail_seconds
        )
    else:
        gated = gated.copy()
    if gated.size == 0:
        gated = np.zeros((0, frames.shape[1]), dtype=np.float32)
    return gated.astype(np.float32, copy=False), floor_db, threshold_db


# --------------------------------------------------------------------------
# batch driver
# --------------------------------------------------------------------------


def gather_audio_targets(path: Path, options: AudioPostOptions) -> list[Path]:
    """Expand a file or directory into the list of processable inputs.

    Every file that is passed over gets a logged reason — in particular a
    WARNING naming the missing optional ``soundfile`` dependency for
    formats the reference would have processed via libsndfile."""
    if path.is_file():
        candidates: Iterable[Path] = [path]
    elif path.is_dir():
        candidates = sorted(path.iterdir())
    else:
        raise FileNotFoundError(f"No such file or directory: {path}")
    allowed = tuple(s.lower() for s in options.allowed_suffixes) or supported_suffixes()
    targets: list[Path] = []
    cleaned_tag = (options.cleaned_suffix or "-cleaned").lower()
    for p in candidates:
        if not p.is_file():
            continue
        if path.is_dir() and p.stem.lower().endswith(cleaned_tag):
            # a directory re-run must not reprocess its own outputs (the
            # batch would double with x-cleaned-cleaned.wav every pass);
            # an explicitly-passed file is honoured verbatim.  Deliberate
            # improvement over the reference, which re-gathers them.
            LOG.info("Skipping %s: already carries the %r output suffix.",
                     p, cleaned_tag)
            continue
        suffix = p.suffix.lower()
        if suffix in allowed:
            targets.append(p)
        elif suffix in _SOUNDFILE_SUFFIXES and _soundfile() is None:
            LOG.warning(
                "Skipping %s: reading %s needs the optional 'soundfile' "
                "package (pip install soundfile).",
                p,
                suffix,
            )
        elif suffix in (".wav", *_SOUNDFILE_SUFFIXES):
            LOG.warning("Skipping %s: %s not in the allowed set %s.", p, suffix, allowed)
        else:
            LOG.debug("Ignoring non-audio file %s", p)
    return targets


def _read_audio(path: Path) -> tuple[np.ndarray, float, str | None]:
    """(frames, rate, wav_codec_or_None) via the first-party WAV path or
    the optional soundfile fallback."""
    if path.suffix.lower() == ".wav":
        data, sample_rate = read_wav(path)
        codec = parse_wav_header(path).codec or "pcm_s16le"
        if codec not in {"pcm_u8", "pcm_s16le", "pcm_f32le"}:
            # s32/f64 inputs are readable but the streaming writer cannot
            # produce them: write float32 (lossless for the float32 frames
            # in hand — a silent s16 coercion would downconvert bit depth,
            # destructively so in overwrite mode) and say so
            LOG.warning(
                "%s: %s output is not supported; writing pcm_f32le.",
                path, codec,
            )
            codec = "pcm_f32le"
        return data, float(sample_rate), codec
    sf = _soundfile()
    if sf is None:
        raise RuntimeError(
            f"Reading {path.suffix} requires the optional 'soundfile' package."
        )
    data, rate = sf.read(str(path), always_2d=True, dtype="float32")
    return np.asarray(data), float(rate), None


def _write_audio(path: Path, frames: np.ndarray, rate: float, codec: str | None) -> None:
    if path.suffix.lower() == ".wav":
        with WavStreamWriter(
            path, int(rate), frames.shape[1], codec or "pcm_s16le"
        ) as writer:
            writer.write_float(frames)
        return
    sf = _soundfile()
    if sf is None:
        raise RuntimeError(
            f"Writing {path.suffix} requires the optional 'soundfile' package."
        )
    sf.write(str(path), frames, int(round(rate)))


def _output_path(path: Path, options: AudioPostOptions) -> Path:
    if options.overwrite:
        return path
    return path.with_name(
        path.stem + (options.cleaned_suffix or "-cleaned") + path.suffix
    )


def process_audio_file(path: Path, options: AudioPostOptions) -> SquelchFileResult:
    bytes_in = path.stat().st_size  # BEFORE overwrite mode rewrites the file
    if path.suffix.lower() == ".wav":
        streamed = _maybe_stream_wav(path, options, bytes_in)
        if streamed is not None:
            return streamed
    data, sample_rate, codec = _read_audio(path)
    cleaned, floor_db, threshold_db = apply_squelch(
        data, float(sample_rate), options.config
    )

    out_path = _output_path(path, options)
    _write_audio(out_path, cleaned, sample_rate, codec)

    n_in, n_out = int(data.shape[0]), int(cleaned.shape[0])
    return SquelchFileResult(
        input_path=path,
        output_path=out_path,
        samples_in=n_in,
        samples_out=n_out,
        duration_in=n_in / float(sample_rate),
        duration_out=n_out / float(sample_rate),
        bytes_in=bytes_in,
        bytes_out=out_path.stat().st_size,
        noise_floor_db=floor_db,
        threshold_db=threshold_db,
        method=options.config.method,
        retained_ratio=n_out / n_in if n_in else 0.0,
    )


def process_audio_batch(
    targets: Sequence[Path],
    options: AudioPostOptions,
    *,
    progress_cb: Callable[[int, int, Path], None] | None = None,
) -> SquelchSummary:
    """Run every target through :func:`process_audio_file`, collecting
    failures instead of aborting the batch."""
    done: list[SquelchFileResult] = []
    failed: list[tuple[Path, Exception]] = []
    for i, path in enumerate(targets):
        if progress_cb:
            progress_cb(i, len(targets), path)
        try:
            done.append(process_audio_file(path, options))
        except Exception as exc:  # pragma: no cover - surfaced to UI/CLI
            LOG.error("Audio post-processing failed for %s: %s", path, exc)
            failed.append((path, exc))
            continue
        if progress_cb:
            progress_cb(i + 1, len(targets), path)
    return SquelchSummary(results=done, errors=failed)


# --------------------------------------------------------------------------
# streaming engine (bounded-memory WAV squelch)
# --------------------------------------------------------------------------
#
# Everything below re-evaluates apply_squelch() over a WAV file in bounded
# memory — multiple cheap sweeps instead of one whole-file load (the
# reference post-processor loads entire files, reference ``squelch.py:
# 272-279``, which OOMs the post stage on multi-GB session recordings while
# the IQ stage streams happily).  The contract is BIT-IDENTICAL output:
#   * the envelope is evaluated blockwise on the same canonical _ENV_BLOCK
#     grid by the same _box_mean_block in both paths;
#   * np.percentile's float32 'linear' path is replicated exactly (float32
#     virtual index (n-1)*(q/100), float32 gamma, numpy's two-branch lerp)
#     over two-pass histogram+candidate order-statistic selection;
#   * masks/gains are computed per owned block from a halo'd window wide
#     enough (hold + 2*fade + 2) that dilation and fade convolution match
#     the global evaluation sample-for-sample;
#   * the same WavStreamWriter quantisation writes the gated blocks.

_STREAM_WAV_CODECS = ("pcm_u8", "pcm_s16le", "pcm_s32le", "pcm_f32le", "pcm_f64le")
_STREAM_DEFAULT_THRESHOLD = 256 * 1024 * 1024


def _resolved_stream_threshold(options: AudioPostOptions) -> int:
    if options.stream_threshold_bytes is not None:
        return int(options.stream_threshold_bytes)
    raw = os.environ.get("IQ2A_POST_BLOCK_BYTES", "")
    if raw:
        try:
            return int(raw)
        except ValueError:
            LOG.warning("Ignoring non-integer IQ2A_POST_BLOCK_BYTES=%r", raw)
    return _STREAM_DEFAULT_THRESHOLD


class _WavBlockReader:
    """Random-access float32 frame reads from a PCM/float WAV — the same
    per-sample decode as :func:`..io.writer.read_wav`, applied per block."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.info = parse_wav_header(path)
        codec = self.info.codec
        if codec not in _STREAM_WAV_CODECS:
            raise ValueError(f"Unsupported WAV codec {codec}")
        self.codec: str = codec
        bpf = max(self.info.bytes_per_frame, 1)
        # drop a truncated trailing frame, like read_wav
        usable = self.info.data_size - self.info.data_size % bpf
        self.n_frames = usable // bpf
        self.channels = self.info.channels
        self.sample_rate = self.info.sample_rate
        self._fd = self.path.open("rb")

    def read(self, start: int, count: int) -> np.ndarray:
        """Frames ``[start, start + count)`` as (count, channels) float32."""
        bpf = self.info.bytes_per_frame
        self._fd.seek(self.info.data_offset + start * bpf)
        payload = self._fd.read(count * bpf)
        if len(payload) != count * bpf:
            raise OSError(
                f"{self.path}: short read at frame {start} "
                f"(wanted {count * bpf} bytes, got {len(payload)})"
            )
        codec = self.codec
        if codec == "pcm_u8":
            data = (np.frombuffer(payload, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif codec == "pcm_s16le":
            data = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        elif codec == "pcm_s32le":
            data = np.frombuffer(payload, "<i4").astype(np.float32) / 2147483648.0
        elif codec == "pcm_f32le":
            data = np.frombuffer(payload, "<f4").astype(np.float32)
        else:  # pcm_f64le
            data = np.frombuffer(payload, "<f8").astype(np.float32)
        return data.reshape(-1, self.channels)

    def close(self) -> None:
        self._fd.close()

    def __enter__(self) -> _WavBlockReader:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _stream_env_db(
    reader: _WavBlockReader, n: int, width: int, *, add_tiny: bool = False
) -> Iterator[tuple[int, int, np.ndarray]]:
    """Yield ``(b0, b1, env_db)`` blocks over the canonical grid —
    bit-identical to ``_to_db(_envelope(frames, width) [+ _TINY])`` of the
    whole file, because each block runs the same _box_mean_block with the
    same context bounds the in-memory _box_mean uses."""
    width = min(max(int(width), 1), max(n, 1))
    lead = (width - 1) // 2
    block = _ENV_BLOCK
    for b0 in range(0, n, block):
        b1 = min(b0 + block, n)
        if width == 1:
            frames = reader.read(b0, b1 - b0)
            mag = np.mean(np.abs(frames), axis=1, dtype=np.float64)
            env = mag.astype(np.float32)
        else:
            c0 = max(b0 + lead + 1 - width, 0)
            c1 = min(b1 + lead, n)
            frames = reader.read(c0, c1 - c0)
            mag = np.mean(np.abs(frames), axis=1, dtype=np.float64)
            env = _box_mean_block(mag.astype(np.float32), c0, width, b0, b1, n)
        if add_tiny:
            env = env + _TINY
        yield b0, b1, _to_db(env)


def _percentile_plan(n: int, q: float) -> tuple[int, int, np.float32]:
    """(lo_k, hi_k, gamma) of numpy's float32 'linear' quantile path: the
    virtual index is ``(n - 1) * float32(q / 100)`` evaluated in float32
    (numpy divides q by ``a.dtype.type(100)``), gamma its float32
    fractional part.  Out-of-range indexes clamp to the end samples, where
    the lerp degenerates and gamma is irrelevant."""
    q32 = np.true_divide(q, np.float32(100))
    virt = (n - 1) * q32
    if virt >= n - 1:
        return n - 1, n - 1, np.float32(0.0)
    if virt < 0:
        return 0, 0, np.float32(0.0)
    prev = np.floor(virt)
    return int(prev), int(prev) + 1, np.float32(virt - prev)


def _lerp_f32(a: np.float32, b: np.float32, gamma: np.float32) -> np.float32:
    """numpy's _lerp on float32 operands (same two-branch rounding)."""
    d = np.subtract(b, a)
    r = np.add(a, d * gamma)
    if gamma >= 0.5:
        r = np.subtract(b, d * (1 - gamma))
    return np.float32(r)


def _stream_order_stats(
    make_blocks: Callable[[], Iterator[np.ndarray]],
    n: int,
    ks: Iterable[int],
    lo_edge: float,
    hi_edge: float,
    nbins: int = 1 << 17,
) -> dict[int, np.float32]:
    """Exact 0-based order statistics of a re-iterable float32 value stream
    in two passes and O(nbins) memory: a fixed-range histogram locates the
    bin holding each wanted rank, then a candidate pass collects the (few)
    distinct values in those bins and walks them in sorted order.  Exact
    because binning is monotone in the value — each bin covers a contiguous
    value range, so rank arithmetic across bins is exact integer counting."""
    wanted = sorted({int(k) for k in ks})
    inv = np.float64(nbins) / (float(hi_edge) - float(lo_edge))

    def bin_of(v: np.ndarray) -> np.ndarray:
        pos = (v.astype(np.float64) - float(lo_edge)) * inv
        # non-finite envelopes (inf from float-codec garbage) clamp to the
        # end bins; the same mapping runs in both passes so selection stays
        # consistent
        pos = np.nan_to_num(pos, nan=0.0, posinf=float(nbins - 1), neginf=0.0)
        return np.clip(pos, 0.0, float(nbins - 1)).astype(np.int64)

    hist = np.zeros(nbins, np.int64)
    total = 0
    for blk in make_blocks():
        v = np.asarray(blk, dtype=np.float32)
        hist += np.bincount(bin_of(v), minlength=nbins)
        total += v.size
    if total != n:
        raise RuntimeError(f"value stream yielded {total} samples, expected {n}")
    cum = np.cumsum(hist)
    need = {k: int(np.searchsorted(cum, k + 1)) for k in wanted}
    counters: dict[int, dict[float, int]] = {b: {} for b in need.values()}
    for blk in make_blocks():
        v = np.asarray(blk, dtype=np.float32)
        idx = bin_of(v)
        for b, d in counters.items():
            sel = v[idx == b]
            if sel.size:
                vals, cnts = np.unique(sel, return_counts=True)
                for val, c in zip(vals.tolist(), cnts.tolist()):
                    d[val] = d.get(val, 0) + int(c)
    out: dict[int, np.float32] = {}
    for k in wanted:
        b = need[k]
        rank = k - (int(cum[b - 1]) if b else 0)
        acc = 0
        for val in sorted(counters[b]):
            acc += counters[b][val]
            if acc > rank:
                out[k] = np.float32(val)
                break
        else:
            raise RuntimeError("order-statistic walk overran its bin")
    return out


def _stream_percentile_f32(
    make_blocks: Callable[[], Iterator[np.ndarray]],
    n: int,
    qs: Sequence[float],
    lo_edge: float,
    hi_edge: float,
) -> dict[float, np.float32]:
    """``np.percentile(stream, q)`` for float32 populations, replicated
    bit-for-bit (validated property-test in tests/test_squelch.py) without
    materialising the stream."""
    plans = {q: _percentile_plan(n, q) for q in qs}
    ks = {k for lo, hi, _ in plans.values() for k in (lo, hi)}
    stats = _stream_order_stats(make_blocks, n, ks, lo_edge, hi_edge)
    return {
        q: _lerp_f32(stats[lo], stats[hi], gamma)
        for q, (lo, hi, gamma) in plans.items()
    }


#: preset histogram ranges.  env_db is clamped to [-160, 20*log10(float32
#: max) ~ 771]; rel = env_db - running_min is within [0, 931].  Values
#: outside (inf envelopes) clamp to the end bins.
_ENV_DB_EDGES = (-200.0, 800.0)
_REL_DB_EDGES = (-1.0, 961.0)


def _stream_mask(
    reader: _WavBlockReader,
    n: int,
    fs: float,
    cfg: SquelchConfig,
    threshold_db: float,
    rel_stats: tuple[np.float32, np.float32] | None,
    coarse_any: bool,
) -> Iterator[tuple[int, int, np.ndarray]]:
    """Yield ``(b0, b1, mask)`` blocks bit-identical to the corresponding
    _MASK_BUILDERS entry evaluated on the whole file."""
    width = max(1, round(cfg.window_seconds * fs))
    if cfg.method == "static":
        for b0, b1, env in _stream_env_db(reader, n, width):
            yield b0, b1, env >= threshold_db
    elif cfg.method == "adaptive":
        if not coarse_any:
            # parity with _mask_adaptive's all-quiet early return
            for b0 in range(0, n, _ENV_BLOCK):
                b1 = min(b0 + _ENV_BLOCK, n)
                yield b0, b1, np.zeros(b1 - b0, dtype=bool)
            return
        assert rel_stats is not None
        lo, hi = rel_stats
        carry = np.float32(np.inf)
        for b0, b1, env in _stream_env_db(reader, n, width):
            run = np.minimum(np.minimum.accumulate(env), carry)
            rel = env - run
            carry = run[-1]
            yield b0, b1, env >= _adaptive_local_threshold(rel, threshold_db, lo, hi)
    else:  # transient (method already validated by the driver)
        fast_w = max(1, round(cfg.transient_window_seconds * fs))
        slow_w = max(fast_w * 4, round(cfg.window_seconds * fs))
        fast_it = _stream_env_db(reader, n, fast_w)
        slow_it = _stream_env_db(reader, n, slow_w, add_tiny=True)
        for (b0, b1, fast_db), (_s0, _s1, slow_db) in zip(fast_it, slow_it):
            yield b0, b1, np.asarray(
                fast_db - slow_db >= cfg.transient_margin_db, dtype=bool
            )


def _stream_gain(
    mask_blocks: Iterator[tuple[int, int, np.ndarray]],
    n: int,
    fs: float,
    cfg: SquelchConfig,
) -> Iterator[tuple[int, int, np.ndarray]]:
    """Yield ``(b0, b1, gain)`` blocks bit-identical to
    ``_fade_gain(_hold_open(mask, hold, hold), fade)`` of the whole mask.

    Each owned block is evaluated on a window extended by ``halo = hold +
    2*fade + 2`` samples per side: hold dilation reaches ``hold`` samples,
    the fade convolution another ``fade``, and its edge padding influences
    only outputs within ``fade`` of the WINDOW edge — all strictly inside
    the discarded margin, so owned outputs equal the global evaluation
    (true signal boundaries coincide with window boundaries and keep the
    global edge-padding semantics)."""
    hold = round(fs * cfg.hold_seconds)
    fade = round(fs * cfg.fade_seconds)
    halo = max(hold, 0) + 2 * max(fade, 0) + 2
    buf: list[tuple[int, int, np.ndarray]] = []
    it = iter(mask_blocks)
    eof = False
    pos = 0
    while pos < n:
        owned = next((x for x in buf if x[0] == pos), None)
        if not eof and (owned is None or buf[-1][1] < min(owned[1] + halo, n)):
            try:
                buf.append(next(it))
            except StopIteration:
                eof = True
            continue
        if owned is None:
            raise RuntimeError("mask stream ended before covering the signal")
        b0, b1, _m = owned
        w0 = max(b0 - halo, 0)
        w1 = min(b1 + halo, n)
        window = np.concatenate(
            [m[max(w0 - s, 0) : min(w1, e) - s] for (s, e, m) in buf if e > w0 and s < w1]
        )
        gain = _fade_gain(_hold_open(window, hold, hold), fade)
        off = b0 - w0
        yield b0, b1, gain[off : off + (b1 - b0)]
        pos = b1
        buf = [x for x in buf if x[1] > pos - halo]


def _maybe_stream_wav(
    path: Path, options: AudioPostOptions, bytes_in: int
) -> SquelchFileResult | None:
    """Route large WAVs to the streaming engine; None falls back to the
    in-memory path (which also surfaces the canonical errors for broken
    headers / unsupported codecs)."""
    try:
        info = parse_wav_header(path)
    except Exception:
        return None
    if info.codec not in _STREAM_WAV_CODECS:
        return None
    if info.data_size <= _resolved_stream_threshold(options):
        return None
    return _process_wav_streaming(path, options, bytes_in)


def _process_wav_streaming(
    path: Path, options: AudioPostOptions, bytes_in: int
) -> SquelchFileResult:
    cfg = options.config
    if cfg.method not in _MASK_BUILDERS:
        raise ValueError(f"Unsupported squelch method: {cfg.method}")
    out_path = _output_path(path, options)
    with _WavBlockReader(path) as reader:
        n = reader.n_frames
        fs = float(reader.sample_rate)
        codec = reader.codec
        if codec not in {"pcm_u8", "pcm_s16le", "pcm_f32le"}:
            # same output-codec rule (and message) as _read_audio
            LOG.warning("%s: %s output is not supported; writing pcm_f32le.", path, codec)
            codec = "pcm_f32le"

        if n == 0:
            floor_db = threshold_db = _DB_FLOOR
            wstart = wend = 0
            gain_source = None
        else:
            width = max(1, round(cfg.window_seconds * fs))

            def env_values() -> Iterator[np.ndarray]:
                for _b0, _b1, env in _stream_env_db(reader, n, width):
                    yield env

            if cfg.auto_noise_floor:
                q = 100.0 * float(np.clip(cfg.noise_floor_percentile, 0.0, 1.0))
                floor_db = float(
                    _stream_percentile_f32(env_values, n, [q], *_ENV_DB_EDGES)[q]
                )
            elif cfg.manual_noise_floor_db is None:
                raise ValueError(
                    "manual_noise_floor_db must be provided when auto_noise_floor=False."
                )
            else:
                floor_db = float(cfg.manual_noise_floor_db)
            threshold_db = floor_db + cfg.threshold_margin_db

            rel_stats: tuple[np.float32, np.float32] | None = None
            coarse_any = True
            if cfg.method == "adaptive":
                coarse_box = [False]

                def rel_values() -> Iterator[np.ndarray]:
                    carry = np.float32(np.inf)
                    for _b0, _b1, env in _stream_env_db(reader, n, width):
                        if not coarse_box[0] and bool((env >= threshold_db).any()):
                            coarse_box[0] = True
                        run = np.minimum(np.minimum.accumulate(env), carry)
                        carry = run[-1]
                        yield env - run

                stats = _stream_percentile_f32(
                    rel_values, n, [5.0, 95.0], *_REL_DB_EDGES
                )
                coarse_any = coarse_box[0]
                rel_stats = (stats[5.0], stats[95.0])

            def gain_source() -> Iterator[tuple[int, int, np.ndarray]]:
                return _stream_gain(
                    _stream_mask(reader, n, fs, cfg, threshold_db, rel_stats, coarse_any),
                    n,
                    fs,
                    cfg,
                )

            if cfg.trim_silence:
                first_open = last_open = None
                for b0, _b1, g in gain_source():
                    open_idx = np.flatnonzero(g > _GATE_OPEN_EPS)
                    if open_idx.size:
                        if first_open is None:
                            first_open = b0 + int(open_idx[0])
                        last_open = b0 + int(open_idx[-1])
                if first_open is None:
                    wstart = wend = 0
                else:
                    wstart = max(
                        0, first_open - max(0, round(fs * cfg.trim_lead_seconds))
                    )
                    wend = min(
                        n, last_open + max(0, round(fs * cfg.trim_trail_seconds)) + 1
                    )
            else:
                wstart, wend = 0, n

        # write pass — overwrite mode cannot read and rewrite the same file,
        # so it streams to a sibling temp file and atomically replaces
        target = out_path
        if options.overwrite:
            target = out_path.with_name(out_path.name + ".iq2a-stream-tmp")
        n_out = 0
        try:
            with WavStreamWriter(target, int(fs), reader.channels, codec) as writer:
                if wend > wstart and gain_source is not None:
                    for b0, b1, g in gain_source():
                        if b1 <= wstart:
                            continue
                        if b0 >= wend:
                            break
                        frames = reader.read(b0, b1 - b0)
                        gated = frames * g[:, None]
                        s0 = max(wstart - b0, 0)
                        s1 = min(wend, b1) - b0
                        writer.write_float(gated[s0:s1])
                        n_out += s1 - s0
            if options.overwrite:
                os.replace(target, out_path)
        except BaseException:
            if options.overwrite:
                Path(target).unlink(missing_ok=True)
            raise

    return SquelchFileResult(
        input_path=path,
        output_path=out_path,
        samples_in=n,
        samples_out=n_out,
        duration_in=n / fs,
        duration_out=n_out / fs,
        bytes_in=bytes_in,
        bytes_out=out_path.stat().st_size,
        noise_floor_db=floor_db,
        threshold_db=threshold_db,
        method=cfg.method,
        retained_ratio=n_out / n if n else 0.0,
    )
