"""Registry of digital-decoder presets runnable in the backend container.

Covers the same three routing targets as the reference (reference
``digital.py:19-46``): DSD-FME for digital voice, multimon-ng for
paging/data bursts, and FT8/FT4 weak-signal staging.
"""

from __future__ import annotations

from collections.abc import Iterable
from dataclasses import dataclass

from .docker_backend import default_decoder_command


@dataclass(slots=True, frozen=True)
class DigitalDecoder:
    """One decoder routing target."""

    key: str
    label: str
    description: str
    default_command: tuple[str, ...]


_PRESETS: dict[str, tuple[str, str, tuple[str, ...]]] = {
    "dsd-fme": (
        "DSD-FME — Digital voice decoding",
        "Configure piping voice channels to the DSD-FME toolkit.",
        ("dsd-fme", "--help"),
    ),
    "multimon-ng": (
        "Multimon-NG — Packet data decoding",
        "Batch process paging/data bursts via multimon-ng.",
        ("multimon-ng", "--help"),
    ),
    "ft8": (
        "FT8/FT4 — Weak signal workflows",
        "Stage audio bursts for FT8 or FT4 decoders.",
        ("ft8", "--help"),
    ),
}

DIGITAL_DECODERS: tuple[DigitalDecoder, ...] = tuple(
    DigitalDecoder(
        key=key,
        label=label,
        description=desc,
        default_command=default_decoder_command(cmd),
    )
    for key, (label, desc, cmd) in _PRESETS.items()
)

DIGITAL_DECODER_MAP: dict[str, DigitalDecoder] = {d.key: d for d in DIGITAL_DECODERS}
DEFAULT_DECODER_KEY = next(iter(_PRESETS))


def iter_decoders() -> Iterable[DigitalDecoder]:
    return DIGITAL_DECODERS


def get_decoder(key: str) -> DigitalDecoder:
    try:
        return DIGITAL_DECODER_MAP[key]
    except KeyError as exc:
        raise KeyError(f"Unknown decoder key: {key}") from exc
