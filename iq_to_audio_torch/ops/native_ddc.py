"""Native host channelizer (``native/ddc.cpp``) for runs on the CPU device.

Port of the JAX package's ``ops/native_ddc.py``.  The C++ kernel computes
the decimated channel samples directly (fused convert, separable-oscillator
mix, phase-split decimating FIR) and agrees with
:func:`iq_to_audio_torch.ops.ddc.ddc_apply_il` at the -100 dB level
(``tests/test_torch_native.py``).  Its oscillator is the JAX package's
uint32 one: each chunk starts it at the uint32 phase and increment nearest
the port's 62-bit ones (:mod:`.nco`), and the decimated output is turned
the rest of the way by the difference, through the port's own low-rate
oscillator (:func:`~.ddc.mix_and_advance`).  On the uint32 grid the
difference is zero and the turn leaves the output as it was, bit for bit.  Here it is called through :mod:`ctypes`
on the memory of CPU tensors: ``native/ddc.cpp`` alone is compiled (its C
entry point ``iq2a_ddc_run``; the XLA custom-call wrapper beside it is not
used), at first use, into ``build/torch_native/``.

The library is optional: when ``g++`` or the source is missing, callers
fall back to the FFT bank (a CPU path; nothing on a CUDA device depends on
it, and a CUDA tensor is refused).
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np
import torch

from ..utils.native_build import build_native
from .ddc import MASK32, mix_and_advance, nco_advance
from .nco import LOW_BITS, MASK62

LOG = logging.getLogger(__name__)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_CODEC_IDS = {"pcm_u8": 0, "pcm_s16le": 1, "pcm_f32le": 2}
_CODEC_DTYPES = {"pcm_u8": torch.uint8, "pcm_s16le": torch.int16, "pcm_f32le": torch.float32}
# re = pair[re_idx], im = im_sign * pair[1 - re_idx]
_ORDERS = {
    "iq": (0, 1.0),
    "iq_inv": (0, -1.0),
    "qi": (1, 1.0),
    "qi_inv": (1, -1.0),
}


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("IQ2A_NATIVE_DDC", "1") == "0":
            return None
        # -ffast-math at compile only (vectorised sincos); see native_build
        path = build_native("ddc", "ddc.cpp", ("-ffast-math",))
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.iq2a_ddc_fast_path.restype = ctypes.c_int
            lib.iq2a_ddc_scratch_floats.restype = ctypes.c_int64
            lib.iq2a_ddc_scratch_floats.argtypes = [ctypes.c_int64] * 3
            lib.iq2a_ddc_run.restype = ctypes.c_int
            lib.iq2a_ddc_run.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
        except (OSError, AttributeError) as exc:
            LOG.debug("native DDC load failed: %s", exc)
            return None
        _lib = lib
        LOG.info(
            "Native channelizer: C++ %s path (native/ddc.cpp)",
            "phase-split AVX-512" if lib.iq2a_ddc_fast_path() else "portable",
        )
        return _lib


def available() -> bool:
    """Whether the native channelizer is built and loaded."""
    return _load() is not None


def _nearest_u32(t: torch.Tensor) -> torch.Tensor:
    """The nearest uint32 phase or increment to a 62-bit one (int64)."""
    return ((t + (1 << (LOW_BITS - 1))) >> LOW_BITS) & MASK32


def _u32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.to(torch.int64).numpy().astype(np.uint32))


_scratch = threading.local()


def ddc_apply_native(
    plan,
    h_rev: torch.Tensor,
    incs: torch.Tensor,
    raw: torch.Tensor,
    itail: torch.Tensor,
    phase0_fixed: torch.Tensor,
    inc_lo_fixed: torch.Tensor,
    codec: str,
    iq_order: str,
):
    """One chunk through the native channelizer.

    Drop-in for :func:`~iq_to_audio_torch.ops.ddc.ddc_apply_il` (same
    returns, same carried state: the interleaved scaled float32 tail).
    ``h_rev`` is the reversed real lowpass taps, ``incs`` the per-channel
    full-rate increments (int64 holding 62-bit values), ``raw`` the UNSCALED
    interleaved chunk in its codec's dtype.  CPU tensors only.
    """
    from ..pipeline.step import _device_scale

    lib = _load()
    if lib is None:
        raise RuntimeError("the native channelizer library is unavailable")
    for name, t in (("raw", raw), ("itail", itail), ("h_rev", h_rev)):
        if t.device.type != "cpu":
            raise ValueError(
                f"the native channelizer runs on the CPU device only ({name} is on {t.device})"
            )
    if raw.dtype != _CODEC_DTYPES[codec]:
        raise TypeError(f"codec {codec} needs a {_CODEC_DTYPES[codec]} chunk, got {raw.dtype}")
    n, m, L = plan.chunk_size, plan.out_size, plan.num_taps
    c = int(incs.shape[0])
    re_idx, im_sign = _ORDERS[iq_order]
    raw = raw.contiguous()
    tail = itail.to(torch.float32).contiguous()
    h = h_rev.to(torch.float32).contiguous()
    assert raw.numel() == 2 * n and tail.numel() == 2 * (L - 1) and h.numel() == L
    phase32, incs32 = _nearest_u32(phase0_fixed), _nearest_u32(incs)
    phase_np, incs_np = _u32(phase32), _u32(incs32)
    yr = torch.empty((c, m), dtype=torch.float32)
    yi = torch.empty((c, m), dtype=torch.float32)
    want = int(lib.iq2a_ddc_scratch_floats(n, L, plan.decimation))
    scratch = getattr(_scratch, "buf", None)
    if scratch is None or scratch.numel() < want:
        scratch = _scratch.buf = torch.empty(want, dtype=torch.float32)
    rc = lib.iq2a_ddc_run(
        raw.data_ptr(), _CODEC_IDS[codec], n, tail.data_ptr(), L, h.data_ptr(),
        phase_np.ctypes.data, incs_np.ctypes.data, c, plan.decimation, re_idx,
        ctypes.c_float(im_sign), yr.data_ptr(), yi.data_ptr(), scratch.data_ptr(),
    )
    if rc != 0:
        raise RuntimeError("iq2a_ddc_run failed")
    # the rest of the way from the kernel's uint32 oscillator to the port's
    rest0 = (phase0_fixed - (phase32 << LOW_BITS)) & MASK62
    rest_lo = (inc_lo_fixed - (((incs32 * plan.decimation) & MASK32) << LOW_BITS)) & MASK62
    yr, yi, _ = mix_and_advance(yr, yi, rest0, rest_lo, m)
    phase_next = nco_advance(phase0_fixed, inc_lo_fixed, m)
    # the state owns its tail, as ddc_apply_il's does: a float32 codec's
    # scale is a view of ``raw``, whose buffer the caller may refill
    new_itail = _device_scale(raw[2 * n - 2 * (L - 1) :], codec).clone() if L > 1 else itail
    return yr, yi, new_itail, phase_next
