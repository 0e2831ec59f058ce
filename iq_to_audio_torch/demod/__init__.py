"""Demodulator registry.  The port carries NFM; the other modes of the JAX
package's registry raise :class:`NotImplementedError` until they are ported
(``ROADMAP.md`` Queue 1 item 7)."""

from .base import Decoder, DecoderStats
from .nfm import NFMDecoder

__all__ = ["Decoder", "DecoderStats", "NFMDecoder", "create_decoder"]

_NOT_YET = {
    "am": "ROADMAP.md Queue 1 item 7 (AM)",
    "usb": "ROADMAP.md Queue 1 item 7 (SSB with AGC)",
    "ssb": "ROADMAP.md Queue 1 item 7 (SSB with AGC)",
    "lsb": "ROADMAP.md Queue 1 item 7 (SSB with AGC)",
}


def create_decoder(mode: str, *, deemph_us: float, agc_enabled: bool) -> Decoder:
    key = mode.lower()
    if key in ("nfm", "fm"):
        return NFMDecoder(deemph_us=deemph_us)
    if key in _NOT_YET:
        raise NotImplementedError(
            f"demod mode '{mode}' is not ported to torch yet: {_NOT_YET[key]}"
        )
    raise ValueError(f"Unsupported demod mode '{mode}'.")
