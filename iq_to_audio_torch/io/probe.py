"""Sample-rate probing.

The reference triangulates ffprobe, libsndfile and the stdlib ``wave``
module (reference ``probe.py:14-37``).  This framework has no external
probers, so the sources are the ones that actually exist here: the
first-party RIFF parser (authoritative — it applies the same
ignore-length semantics as the reader), the stdlib ``wave`` module as an
independent cross-check, and an explicit user override (raw captures have
no header to probe).  A disagreement between parser and cross-check is
logged rather than silently resolved.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

from .riff import WavFormatError, parse_wav_header

LOG = logging.getLogger(__name__)


@dataclass(frozen=True)
class SampleRateProbe:
    """Best-effort sample-rate measurements, one slot per source."""

    header: float | None = None  # first-party RIFF parse
    wave: float | None = None  # stdlib ``wave`` cross-check
    override: float | None = None  # user-supplied (--input-sample-rate)

    @property
    def value(self) -> float:
        """The rate to run with: explicit user intent outranks the header,
        which outranks the stdlib fallback."""
        for rate in (self.override, self.header, self.wave):
            if rate:
                return rate
        raise RuntimeError("Unable to determine sample rate from header.")

    @property
    def consistent(self) -> bool:
        """False when two populated sources disagree."""
        rates = {r for r in (self.header, self.wave) if r}
        return len(rates) <= 1


def probe_sample_rate(path: Path) -> SampleRateProbe:
    probe = SampleRateProbe(
        header=_riff_rate(path), wave=_stdlib_wave_rate(path)
    )
    if not probe.consistent:
        LOG.warning(
            "Sample-rate sources disagree for %s: RIFF parser says %s, "
            "stdlib wave says %s — using %s.",
            path,
            probe.header,
            probe.wave,
            probe.value,
        )
    return probe


def _riff_rate(path: Path) -> float | None:
    try:
        info = parse_wav_header(path)
    except (WavFormatError, OSError):
        return None
    return float(info.sample_rate) or None


def _stdlib_wave_rate(path: Path) -> float | None:
    import wave

    try:
        with wave.open(str(path), "rb") as wf:
            return float(wf.getframerate())
    except (wave.Error, EOFError, FileNotFoundError, OSError):
        return None
