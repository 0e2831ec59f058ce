"""Demodulator registry: the JAX package's mode set (reference
``decoders/__init__.py:9-24``): ``nfm``/``fm``, ``am``, ``usb``/``ssb`` and
``lsb``."""

from .am import AMDecoder
from .base import Decoder, DecoderStats
from .nfm import NFMDecoder
from .ssb import SSBDecoder

__all__ = [
    "AMDecoder",
    "Decoder",
    "DecoderStats",
    "NFMDecoder",
    "SSBDecoder",
    "create_decoder",
]

_FACTORIES = {
    "nfm": lambda deemph_us, agc: NFMDecoder(deemph_us=deemph_us),
    "fm": lambda deemph_us, agc: NFMDecoder(deemph_us=deemph_us),
    "am": lambda deemph_us, agc: AMDecoder(),
    "usb": lambda deemph_us, agc: SSBDecoder(sideband="usb", agc_enabled=agc),
    "ssb": lambda deemph_us, agc: SSBDecoder(sideband="usb", agc_enabled=agc),
    "lsb": lambda deemph_us, agc: SSBDecoder(sideband="lsb", agc_enabled=agc),
}


def create_decoder(mode: str, *, deemph_us: float, agc_enabled: bool) -> Decoder:
    try:
        make = _FACTORIES[mode.lower()]
    except KeyError:
        raise ValueError(f"Unsupported demod mode '{mode}'.") from None
    return make(deemph_us, agc_enabled)
