"""Center-frequency detection from metadata tags and filename heuristics.

Behavioral parity with the reference (``utils.py:24-199``), re-expressed as
a ranked candidate stream: every possible source (known metadata keys,
frequency-ish stray tags, filename tokens) yields scored candidates in
priority order and the first parseable one wins.  Tags come from the
first-party RIFF INFO parser instead of libsndfile/ffprobe; embedded
``key=value`` / ``key:value`` lines inside comment-style tags are unpacked
(reference ``utils.py:216-218``), with ``;`` accepted both as a line
separator and as a comment prefix.

Contract pinned by tests/test_utils.py: largest filename candidate >= 1 kHz
wins; sources are ``metadata:<key>``, ``filename:sdrpp``,
``filename:sdrsharp``, ``filename``, ``unavailable``.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

LOG = logging.getLogger(__name__)

# "145.5 M", "145500000", "433.92MHz", ... — magnitude + optional SI scale
_TEXT_FREQ = re.compile(
    r"(?P<mag>[-+]?\d+(?:\.\d+)?)(?P<scale>\s*[kKmMgG]?)\s*(?P<unit>[Hh][Zz])?"
)
# filename tokens must spell out the unit: "145500000Hz", "433920kHz"
_NAME_FREQ = re.compile(r"(?i)(?P<mag>\d+(?:\.\d+)?)(?P<scale>[kmg]?)hz")

_SCALE = {"": 1.0, "k": 1e3, "m": 1e6, "g": 1e9}

# tag keys that explicitly mean "tuner center", most specific first; any
# other key merely *mentioning* freq/hz ranks after all of these
_KNOWN_KEYS = (
    "center_frequency",
    "centerfrequency",
    "frequency",
    "tuner_frequency",
    "tunerfrequency",
    "carrier_frequency",
    "rx_frequency",
    "hz",
)
_KEY_RANK = {key: rank for rank, key in enumerate(_KNOWN_KEYS)}

# filename layout fingerprints -> source label suffix
_STEM_STYLES = (
    ("sdrpp", re.compile(r"^baseband_")),
    ("sdrsharp", re.compile(r"^\d{2}-\d{2}-\d{2}_")),
)


@dataclass
class CenterFrequencyResult:
    value: float | None
    source: str = "unavailable"


def detect_center_frequency(path: Path) -> CenterFrequencyResult:
    """Detect center frequency (Hz): metadata outranks filename."""
    for candidate in _candidates(path):
        return candidate
    return CenterFrequencyResult(value=None, source="unavailable")


def parse_center_frequency(path: Path) -> float | None:
    """Backwards-compatible shim returning only the detected value."""
    return detect_center_frequency(path).value


def _candidates(path: Path) -> Iterator[CenterFrequencyResult]:
    """All parseable frequency candidates, best source first."""
    tags = _file_tags(path)
    ranked = sorted(
        (k for k in tags if k in _KEY_RANK or _frequencyish(k)),
        key=lambda k: _KEY_RANK.get(k, len(_KNOWN_KEYS)),
    )
    for key in ranked:
        hz = _parse_frequency_text(tags[key])
        if hz:
            yield CenterFrequencyResult(hz, f"metadata:{key}")
    hit = _filename_candidate(path)
    if hit is not None:
        yield hit


def _frequencyish(key: str) -> bool:
    lowered = key.lower()
    return "freq" in lowered or "hz" in lowered


def _file_tags(path: Path) -> dict[str, str]:
    """RIFF INFO tags, lowercased, with packed sub-tags unfolded.

    SDR recorders often stuff ``key=value`` (or ``key:value``) lines into a
    single comment/title tag; each such line becomes its own entry unless a
    real tag already claimed the key.  Lines opening with ``;`` are
    comments.
    """
    from ..io.riff import WavFormatError, parse_wav_header

    try:
        info = parse_wav_header(path)
    except (WavFormatError, OSError):
        return {}
    tags = {k.lower(): v for k, v in info.tags.items()}
    for packed in list(tags.values()):
        for line in packed.splitlines():
            line = line.strip()
            if not line or line.startswith(";"):
                continue  # comment line (reference utils.py:213-214)
            # some recorders pack several pairs onto one line with ";"
            for part in line.split(";"):
                part = part.strip()
                sep = "=" if "=" in part else ":" if ":" in part else None
                if not part or sep is None:
                    continue
                key, _, sub = part.partition(sep)
                if key.strip():
                    tags.setdefault(key.strip().lower(), sub.strip())
    return tags


def _filename_candidate(path: Path) -> CenterFrequencyResult | None:
    hits = [
        hz
        for m in _NAME_FREQ.finditer(path.name)
        if (hz := _scaled(m["mag"], m["scale"])) is not None and hz >= 1_000.0
    ]
    if not hits:
        return None
    stem = path.stem.lower()
    style = next(
        (name for name, pattern in _STEM_STYLES if pattern.match(stem)), None
    )
    source = f"filename:{style}" if style else "filename"
    return CenterFrequencyResult(max(hits), source)


def _parse_frequency_text(text: str | None) -> float | None:
    """Hz from free-form tag text: plain number, or magnitude + SI scale."""
    cleaned = (text or "").strip().replace(",", "").replace("_", "")
    if not cleaned:
        return None
    try:
        plain = float(cleaned)
    except ValueError:
        pass
    else:
        return plain if plain > 0 else None
    m = _TEXT_FREQ.search(cleaned)
    if m is None:
        return None
    scale = m["scale"].strip()
    rest = cleaned[m.end():]
    # Grouped-digit guard: a UNIT-LESS match immediately continued by more
    # digit groups means the regex truncated a grouped number
    # ("145 500 000" -> 145, "145.500.000" -> 145.500) — reparse the whole
    # value instead of returning the leading group.  An explicit scale
    # letter OR a spelled-out Hz terminates the number unambiguously
    # ("96.5M 2024-01-01", "145.5 MHz ch 2", "145500000 Hz 2024" keep the
    # reference's search() semantics, reference utils.py:280).
    if scale or m["unit"] or not re.match(r"[ .,']*\d", rest):
        return _scaled(m["mag"], m["scale"])
    compact = "".join(cleaned.split())
    if compact != cleaned:
        try:
            plain = float(compact)
        except ValueError:
            pass
        else:
            return plain if plain > 0 else None
        m2 = _TEXT_FREQ.match(compact)
        if m2 and not any(ch.isdigit() for ch in compact[m2.end():]):
            return _scaled(m2["mag"], m2["scale"])
    return None


def _scaled(magnitude: str, scale: str) -> float | None:
    try:
        hz = float(magnitude) * _SCALE.get(scale.strip().lower(), 1.0)
    except ValueError:
        return None
    return hz if hz > 0 else None
