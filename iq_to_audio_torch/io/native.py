"""ctypes bindings for the native host IO kernels (``native/iqio.cpp``).

The library is optional: everything has a NumPy fallback.  The loader
compiles the source with ``g++`` at first use into ``build/torch_native/``
(:mod:`iq_to_audio_torch.utils.native_build`); nothing is written under
``native/``.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path

import numpy as np

from ..utils.native_build import build_native

LOG = logging.getLogger(__name__)

_CODEC_IDS = {"pcm_u8": 0, "pcm_s16le": 1, "pcm_f32le": 2}
_ORDER_IDS = {"iq": 0, "qi": 1, "iq_inv": 2, "qi_inv": 3}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_ABI_VERSION = 2


def _load(path: Path) -> ctypes.CDLL | None:
    try:
        lib = ctypes.CDLL(str(path))
        lib.iqio_abi_version.restype = ctypes.c_int32
        if lib.iqio_abi_version() != _ABI_VERSION:
            return None
        lib.iqio_convert_deinterleave.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.iqio_encode_s16.restype = ctypes.c_float
        lib.iqio_encode_s16.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.iqio_interleave_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p,
        ]
        return lib
    except (OSError, AttributeError) as exc:
        LOG.debug("native iqio load failed: %s", exc)
        return None


def get_lib() -> ctypes.CDLL | None:
    """Load (building on demand) the native library, or None: everything
    then stays on the NumPy paths."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build_native("iqio", "iqio.cpp")
        if path is not None:
            _lib = _load(path)
        return _lib


def convert_deinterleave(raw: np.ndarray, codec: str, iq_order: str):
    """(i, q) float32 arrays from raw interleaved samples, or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw)
    frames = raw.size // 2
    i_out = np.empty(frames, dtype=np.float32)
    q_out = np.empty(frames, dtype=np.float32)
    lib.iqio_convert_deinterleave(
        raw.ctypes.data_as(ctypes.c_void_p),
        _CODEC_IDS[codec],
        _ORDER_IDS[iq_order],
        frames,
        i_out.ctypes.data_as(ctypes.c_void_p),
        q_out.ctypes.data_as(ctypes.c_void_p),
    )
    return i_out, q_out


def encode_s16(samples: np.ndarray, clip: float = 0.99):
    """(payload_bytes, peak) for float32 mono audio, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    out = np.empty(samples.size, dtype=np.int16)
    peak = lib.iqio_encode_s16(
        samples.ctypes.data_as(ctypes.c_void_p),
        samples.size,
        ctypes.c_float(clip),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out, float(peak)


def interleave_encode(samples: np.ndarray, codec: str):
    """Raw interleaved payload bytes for complex64 IQ, or None.

    Semantics match ``io.writer._encode_iq_raw`` exactly (s16 truncates
    after the asymmetric clip, u8 rounds half-to-even).
    """
    lib = get_lib()
    if lib is None:
        return None
    i = np.ascontiguousarray(samples.real, dtype=np.float32)
    q = np.ascontiguousarray(samples.imag, dtype=np.float32)
    frames = i.size
    dtype = {"pcm_u8": np.uint8, "pcm_s16le": np.int16,
             "pcm_f32le": np.float32}[codec]
    out = np.empty(2 * frames, dtype=dtype)
    lib.iqio_interleave_encode(
        i.ctypes.data_as(ctypes.c_void_p),
        q.ctypes.data_as(ctypes.c_void_p),
        frames,
        _CODEC_IDS[codec],
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out.tobytes()
