"""The warm-up mixer-sign probe on the device.

For each sign ``s`` of ``+1, -1`` the probe mixes the head of the warm-up
block by ``osc_s[n] = exp(-j*s*2*pi*f*n/fs)``, filters it with the real
channel taps ``h`` from zero history and keeps every ``D``-th output:

    y_s[k] = sum_{t=0}^{min(kD, T-1)} h[t] * x[kD - t] * osc_s[kD - t]

Its power is the mean of ``|y_s[k]|**2`` over ``k >= min(T, K // 4)`` of the
``K = ceil(N / D)`` outputs, and the larger power picks the sign
(:func:`~iq_to_audio_torch.ref.chain.pick_mix_sign`).  This is the quantity
of the host twin :func:`~iq_to_audio_torch.ref.chain.mix_sign_powers`, in
float64, computed in the direct decimated form: only the outputs the power
reads, where the twin runs the whole snippet through an overlap-save FFT
filter and drops 25 of every 26 outputs.

:func:`choose_mix_sign_on` is the one dispatch of the port's callers: on a
CUDA device the hand-written kernel ``csrc/mix_probe.cu``
(:func:`mix_sign_powers`), elsewhere the unchanged twin.
:func:`mix_sign_powers_plain` is the kernel's arithmetic in plain torch;
``mix_sign_powers.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..ref.chain import choose_mix_sign, mix_probe_len, pick_mix_sign
from ..utils import spans
from . import _cuda_build

#: the most dynamic shared memory one CTA may use on Hopper
_SMEM_MAX = 227 * 1024
#: SMs of an H100 SXM, the default of :func:`choose_tile`
_SM_COUNT = 132
#: bytes of one mixed sample (and of one output's sum) in shared memory: a double2
_SLOT = 16
#: output rows of :func:`mix_sign_powers_plain`'s windows taken at once
_PLAIN_ROWS = 256


def probe_geometry(n_warm: int, sample_rate: float, n_taps: int, decimation: int):
    """``(N, D, K, first)``: the snippet's samples, the decimation, the
    decimated outputs and the first output the power reads."""
    n = mix_probe_len(n_warm, sample_rate, n_taps)
    d = max(int(decimation), 1)
    k = -(-n // d)
    return n, d, k, min(n_taps, k // 4)


def phase_coefficient(sign: int, freq_offset: float) -> float:
    """``c`` of the phase ``(c * n) * (1 / fs)``: the twin's
    ``-1j * sign * 2.0 * np.pi * freq_offset * n / sample_rate`` rounds in this
    order (its complex division multiplies by ``1 / fs``)."""
    return (-1.0 * sign) * 2.0 * math.pi * float(freq_offset)


@functools.lru_cache(maxsize=64)
def choose_tile(n_out: int, n_taps: int, decimation: int, sm_count: int = _SM_COUNT):
    """``(M, Tc)``: outputs per CTA and taps per pass over its input span.

    A CTA keeps its ``M`` sums and the mixed span of one pass,
    ``(M - 1) D + Tc`` samples, in shared memory.  ``M`` is the least that
    puts both signs' ``ceil(n_out / M)`` CTAs on ``sm_count`` SMs in one
    wave, cut to what lets one pass take every tap (1,601 and 7,143 taps
    at D = 26 do); a filter too long even for ``M = 1`` takes as many taps a
    pass as fit."""
    cap = _SMEM_MAX // _SLOT
    m = max(1, -(-2 * n_out // sm_count))
    m = max(1, min(m, (cap - n_taps + decimation) // (decimation + 1)))
    return m, min(n_taps, cap - m - (m - 1) * decimation)


def smem_bytes(m: int, tc: int, decimation: int) -> int:
    """Dynamic shared memory of one CTA: ``M`` sums and the span of a pass."""
    return _SLOT * (m + (m - 1) * decimation + tc)


def _real_taps(taps: np.ndarray) -> np.ndarray:
    if np.iscomplexobj(taps) or np.size(taps) == 0:
        raise ValueError("mix probe: real channel taps required")
    return np.ascontiguousarray(taps, dtype=np.float64)


def mix_sign_powers_plain(
    warm: np.ndarray,
    sample_rate: float,
    freq_offset: float,
    taps: np.ndarray,
    decimation: int,
) -> tuple[float, float]:
    """The probe's powers at ``+1`` and ``-1`` in plain float64 torch on
    the CPU: the direct decimated form, a window of ``T`` samples reversed
    against the taps for each output the power reads."""
    h = torch.from_numpy(_real_taps(taps))
    h_rev = h.flip(0)
    n, d, k, first = probe_geometry(np.size(warm), sample_rate, h.numel(), decimation)
    if n == 0:
        return -math.inf, -math.inf
    x = torch.from_numpy(np.asarray(warm[:n], dtype=np.complex128))
    t = h.numel()
    idx = torch.arange(n, dtype=torch.float64)
    inv_fs = 1.0 / sample_rate
    powers = []
    for sign in (1, -1):
        theta = (phase_coefficient(sign, freq_offset) * idx) * inv_fs
        mixed = x * torch.complex(torch.cos(theta), torch.sin(theta))
        # zero history: T - 1 zeros before the snippet; window k holds
        # x[kD - T + 1 .. kD], the taps reversed
        xp = torch.nn.functional.pad(torch.view_as_real(mixed).T, (t - 1, 0))
        windows = xp.unfold(1, t, d)[:, first:k]
        total = 0.0
        for r0 in range(0, k - first, _PLAIN_ROWS):
            y = windows[:, r0 : r0 + _PLAIN_ROWS] @ h_rev
            total += float((y[0] * y[0] + y[1] * y[1]).sum())
        powers.append(total / (k - first))
    return powers[0], powers[1]


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load("mix_probe")
    ptr, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.iq2a_mix_probe.argtypes = [
        ptr, i64, ptr, i32, i32, i64, i64, i32, i32, f64, f64, f64, ptr, ptr, ptr,
    ]
    lib.iq2a_mix_probe.restype = i32
    return lib


def mix_sign_powers(
    warm: np.ndarray,
    sample_rate: float,
    freq_offset: float,
    taps: np.ndarray,
    decimation: int,
    device: torch.device,
) -> tuple[float, float]:
    """The probe's powers at ``+1`` and ``-1``.

    Parameters
    ----------
    warm: complex64 warm-up block on the host, as ``convert_to_complex``
        returns it.
    taps: the real channel filter.
    device: a CUDA device runs ``csrc/mix_probe.cu`` (one launch for both
        signs, one copy of the two float64 powers to the host); the CPU runs
        :func:`mix_sign_powers_plain`.
    """
    if device.type == "cpu":
        return mix_sign_powers_plain(warm, sample_rate, freq_offset, taps, decimation)
    if device.type != "cuda":
        raise ValueError(f"mix_sign_powers: unsupported device {device}")
    warm = np.asarray(warm)
    if warm.dtype != np.complex64 or warm.ndim != 1:
        raise ValueError("mix_sign_powers: a 1-D complex64 warm-up block required")
    h_np = _real_taps(taps)
    n, d, k, first = probe_geometry(warm.size, sample_rate, h_np.size, decimation)
    if n == 0:
        return -math.inf, -math.inf
    index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        dev = torch.device("cuda", index)
        n_out = k - first
        m, tc = choose_tile(n_out, h_np.size, d, _sm_count(index))
        tiles = -(-n_out // m)
        x = torch.from_numpy(np.ascontiguousarray(warm[:n]).view(np.float32)).to(dev)
        h = torch.from_numpy(h_np).to(dev)
        partial = torch.empty(2 * tiles, dtype=torch.float64, device=dev)
        power = torch.empty(2, dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().iq2a_mix_probe(
            x.data_ptr(), n, h.data_ptr(), h_np.size, d, first, n_out, m, tc,
            1.0 / sample_rate, phase_coefficient(1, freq_offset),
            phase_coefficient(-1, freq_offset), partial.data_ptr(), power.data_ptr(), stream,
        )
        if rc != 0:
            raise RuntimeError(f"mix_sign_powers: CUDA error {rc} at launch")
        mix_sign_powers.launches += 1
        plus, minus = power.cpu().tolist()
    return plus, minus


mix_sign_powers.launches = 0


def choose_mix_sign_on(
    device: torch.device,
    warm: np.ndarray,
    sample_rate: float,
    freq_offset: float,
    taps: np.ndarray,
    decimation: int,
) -> int:
    """The run's mixer sign: on a CUDA device from the kernel's powers
    (and ``probe_on_device`` counted on the innermost open span), elsewhere
    from the host twin :func:`~iq_to_audio_torch.ref.chain.choose_mix_sign`."""
    if device.type != "cuda":
        return choose_mix_sign(warm, sample_rate, freq_offset, taps, decimation)
    sign = pick_mix_sign(mix_sign_powers(warm, sample_rate, freq_offset, taps, decimation, device))
    spans.count("probe_on_device", 1)
    return sign
