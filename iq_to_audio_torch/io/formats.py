"""Input format registry, override grammar, and detection.

Capability match with the reference ``input_formats.py`` (same six supported
encodings, the same override vocabulary, the same 24/32-bit rejection and
diagnostic strings — those are the user-facing contract), built differently:
everything here is *generated from one codec table* (:data:`_CODECS`).  Each
codec row declares its sample width, labels, raw-file extensions, and the
override tokens that select it; the registry, the extension map, the token
lexicon, and the container-inference rules are all derived from the rows, so
adding an encoding is a one-line change.  Detection reads WAV headers with
the first-party RIFF parser (``riff.py``) instead of libsndfile/ffprobe and
routes through a suffix-class dispatch table.
"""

from __future__ import annotations

import logging
from collections.abc import Iterable
from dataclasses import dataclass
from pathlib import Path

from .riff import WavFormatError, parse_wav_header

LOG = logging.getLogger(__name__)

_WAV_SUFFIXES = frozenset({".wav", ".wave", ".wv", ".rf64"})
_OVERRIDE_SEPARATORS = (":", "-")


# ---------------------------------------------------------------------------
# The codec table — single source of truth
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class _CodecRow:
    codec: str  # canonical name (ffmpeg-style)
    sample_bytes: int  # bytes per real sample on disk
    wav_label: str
    raw_label: str
    raw_suffixes: tuple[str, ...]  # extensions implying raw + this codec
    tokens: tuple[str, ...]  # override tokens (canonical name is implicit)


_CODECS: tuple[_CodecRow, ...] = (
    _CodecRow(
        codec="pcm_u8",
        sample_bytes=1,
        wav_label="WAV PCM unsigned 8-bit",
        raw_label="RAW complex u8 (.cu8)",
        raw_suffixes=(".cu8",),
        # "s8" aliases to the unsigned decode — reference parity (reference
        # input_formats.py:105,152 maps PCM_S8/"s8" to pcm_u8 the same way)
        tokens=("u8", "cu8", "s8"),
    ),
    _CodecRow(
        codec="pcm_s16le",
        sample_bytes=2,
        wav_label="WAV PCM signed 16-bit",
        raw_label="RAW complex s16 (.cs16)",
        raw_suffixes=(".cs16", ".iq"),
        tokens=("s16", "cs16", "pcm16", "pcm_s16"),
    ),
    _CodecRow(
        codec="pcm_f32le",
        sample_bytes=4,
        wav_label="WAV float32",
        raw_label="RAW complex f32 (.cf32)",
        raw_suffixes=(".cf32",),
        tokens=("f32", "float32", "cf32"),
    ),
)


@dataclass(slots=True, frozen=True)
class InputFormatSpec:
    """Descriptor for one supported IQ input encoding (capability contract
    of the reference ``input_formats.py:17-31``)."""

    container: str  # "wav" or "raw"
    codec: str  # pcm_u8, pcm_s16le, pcm_f32le
    label: str
    bytes_per_frame: int  # bytes per complex sample on disk (I+Q)
    requires_sample_rate: bool

    @property
    def key(self) -> str:
        return f"{self.container}:{self.codec}"


@dataclass(slots=True)
class InputFormatDetection:
    spec: InputFormatSpec | None
    source: str
    message: str | None = None
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.spec is not None and self.error is None

    @classmethod
    def found(cls, spec: InputFormatSpec, source: str, message: str) -> "InputFormatDetection":
        return cls(spec=spec, source=source, message=message)

    @classmethod
    def failed(cls, source: str, error: str) -> "InputFormatDetection":
        return cls(spec=None, source=source, error=error)


def _derive_registry() -> dict[tuple[str, str], InputFormatSpec]:
    registry: dict[tuple[str, str], InputFormatSpec] = {}
    for row in _CODECS:
        for container in ("wav", "raw"):
            registry[(container, row.codec)] = InputFormatSpec(
                container=container,
                codec=row.codec,
                label=row.wav_label if container == "wav" else row.raw_label,
                bytes_per_frame=2 * row.sample_bytes,
                requires_sample_rate=(container == "raw"),
            )
    return registry


def _derive_token_lexicon() -> dict[str, str]:
    """token -> canonical codec, covering aliases and canonical names."""
    lexicon: dict[str, str] = {}
    for row in _CODECS:
        lexicon[row.codec] = row.codec
        for token in row.tokens:
            lexicon[token] = row.codec
    return lexicon


_FORMAT_MAP = _derive_registry()
_RAW_SUFFIX_MAP: dict[str, tuple[str, str]] = {
    suffix: ("raw", row.codec) for row in _CODECS for suffix in row.raw_suffixes
}
_TOKEN_TO_CODEC = _derive_token_lexicon()


# ---------------------------------------------------------------------------
# Registry access
# ---------------------------------------------------------------------------


def list_supported_formats(container: str | None = None) -> Iterable[InputFormatSpec]:
    for spec in _FORMAT_MAP.values():
        if container is None or spec.container == container:
            yield spec


def get_format(container: str, codec: str) -> InputFormatSpec:
    try:
        return _FORMAT_MAP[(container, codec)]
    except KeyError as exc:
        raise ValueError(f"Unsupported input format: {container}:{codec}") from exc


# ---------------------------------------------------------------------------
# Override grammar:  [container(:|-)]codec-token
# ---------------------------------------------------------------------------


def _lex_override(value: str) -> tuple[str | None, str]:
    """Split an override string into ``(container_token, codec_token)``.

    Grammar: an optional container token joined to a codec token by the
    first separator that yields exactly two non-empty parts; otherwise the
    whole string is one codec token.
    """
    normalized = value.strip().lower()
    if not normalized or normalized == "auto":
        raise ValueError("parse_user_format() expects a non-auto value.")
    for sep in _OVERRIDE_SEPARATORS:
        if sep not in normalized:
            continue
        parts = [p for p in normalized.split(sep) if p]
        if len(parts) == 2:
            return parts[0], parts[1]
    return None, normalized


def _infer_container(codec_token: str) -> str:
    """Raw-flavoured tokens (the ``c``-prefixed interleaved-complex names)
    imply a headerless file; anything else defaults to WAV."""
    return "raw" if codec_token.startswith("c") else "wav"


def parse_user_format(value: str, *, default_container: str | None = None) -> tuple[str, str]:
    """Parse CLI/GUI overrides like ``raw:cu8``, ``wav-s16``, or ``f32``
    (the reference's override vocabulary, ``input_formats.py:132-171``)."""
    container_token, codec_token = _lex_override(value)
    codec = _TOKEN_TO_CODEC.get(codec_token)
    if codec is None:
        codec = _TOKEN_TO_CODEC.get(codec_token.replace(".", ""))
    if codec is None:
        raise ValueError(f"Unsupported input codec override: {value}")

    container = container_token or default_container or _infer_container(codec_token)
    if container not in ("wav", "raw"):
        raise ValueError(f"Unknown input container override: {container}")
    return container, codec


# ---------------------------------------------------------------------------
# Detection: suffix classification -> per-class handler
# ---------------------------------------------------------------------------


def _detect_raw_suffix(path: Path, suffix: str) -> InputFormatDetection:
    spec = get_format(*_RAW_SUFFIX_MAP[suffix])
    return InputFormatDetection.found(
        spec, f"extension:{suffix}", f"Detected {spec.label} via extension."
    )


def _detect_bare_raw(path: Path, suffix: str) -> InputFormatDetection:
    return InputFormatDetection.failed(
        "extension:.raw",
        "Raw '.raw' files need a manual format selection (cu8/cs16/cf32).",
    )


def _detect_unknown_suffix(path: Path, suffix: str) -> InputFormatDetection:
    return InputFormatDetection.failed(
        f"extension:{suffix or 'none'}",
        "Unsupported input type. Provide a WAV/RAW IQ recording.",
    )


def _detect_wav_header(path: Path, suffix: str) -> InputFormatDetection:
    try:
        info = parse_wav_header(path)
    except (WavFormatError, OSError) as exc:
        LOG.debug("WAV header read failed for %s: %s", path, exc)
        return InputFormatDetection.failed(
            "header", "Unable to read WAV header; specify format manually."
        )
    codec = info.codec
    if (("wav", codec)) in _FORMAT_MAP:
        return InputFormatDetection.found(
            _FORMAT_MAP[("wav", codec)], f"wav:{codec}", f"WAV codec {codec} detected."
        )
    if codec in ("pcm_s24le", "pcm_s32le"):
        reason = (
            "32-bit/24-bit PCM WAV inputs are not supported. "
            "Export as 16-bit or float32."
        )
    else:
        reason = (
            f"Unsupported WAV format {info.audio_format} "
            f"({info.bits_per_sample}-bit). Export as PCM 16-bit or float32."
        )
    return InputFormatDetection.failed(f"wav:{codec}", reason)


def _classify_suffix(suffix: str) -> str:
    if suffix in _RAW_SUFFIX_MAP:
        return "raw"
    if suffix == ".raw":
        return "bare_raw"
    if suffix in _WAV_SUFFIXES:
        return "wav"
    return "unknown"


_DETECTORS = {
    "raw": _detect_raw_suffix,
    "bare_raw": _detect_bare_raw,
    "wav": _detect_wav_header,
    "unknown": _detect_unknown_suffix,
}


def detect_input_format(path: Path) -> InputFormatDetection:
    """Detect supported IQ encodings from WAV headers or RAW filename hints."""
    suffix = path.suffix.lower()
    return _DETECTORS[_classify_suffix(suffix)](path, suffix)


def deduce_container(path: Path) -> str:
    kind = _classify_suffix(path.suffix.lower())
    return "raw" if kind in ("raw", "bare_raw") else "wav"


def resolve_input_format(
    path: Path,
    *,
    requested: str | None,
    container_hint: str | None = None,
) -> tuple[InputFormatSpec, str]:
    """Resolve the effective input format: a manual override wins, detection
    otherwise; detection failures surface their diagnostic as ValueError."""
    override = (requested or "").strip().lower()
    if override and override != "auto":
        container = container_hint or deduce_container(path)
        return get_format(*parse_user_format(requested, default_container=container)), "manual"
    detection = detect_input_format(path)
    if not detection.ok:
        raise ValueError(detection.error or "Unable to determine input format.")
    return detection.spec, detection.source
