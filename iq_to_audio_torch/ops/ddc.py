"""Digital downconverter: mix + channel filter + decimate as one decimating
polyphase FIR over the raw interleaved sample stream.

Port of the JAX package's ``ops/ddc.py`` main path.  Mixing commutes into
the taps (``g[j] = h[j] * e^{-j*theta*j}``, :func:`bandpass_kernel`), so the
full-rate NCO disappears: the raw stream is filtered by per-channel bandpass
taps at stride ``2D`` (:func:`iq_to_audio_torch.ops.poly_fir.poly_fir_il`)
and the oscillator runs only at the decimated rate (:func:`mix_and_advance`).

:func:`ddc_apply` is the pair-input entry point of the JAX package (an
(re, im) pair with a ``(2, L-1)`` tail): through the same kernel over the
pair (:func:`~iq_to_audio_torch.ops.poly_fir.poly_fir_pair`) when given the
polyphase tensor, else as a strided ``conv1d`` with TF32 off.

Phase is uint32 fixed point (1 cycle == 2**32 counts).  torch has no usable
uint32 arithmetic, so the device carries it as ``int64`` masked with
``& 0xFFFFFFFF``: ``inc_lo * n < 2**50`` for any chunk, so the product is
exact and the masked value equals the JAX package's uint32 bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .poly_fir import poly_fir_il, poly_fir_pair

_TWO32 = 1 << 32
MASK32 = _TWO32 - 1
_RAD_PER_COUNT = float(2.0 * np.pi / _TWO32)


@dataclass(frozen=True)
class DDCPlan:
    """Static geometry: chunk length N (multiple of D), taps L, decimation D."""

    num_taps: int
    decimation: int
    chunk_size: int

    @property
    def overlap(self) -> int:
        return self.num_taps - 1

    @property
    def out_size(self) -> int:
        return self.chunk_size // self.decimation

    @staticmethod
    def create(
        num_taps: int,
        decimation: int,
        *,
        target_chunk: int,
        max_chunk: int = 1 << 22,
        out_align: int = 1,
    ):
        """``out_align`` forces the decimated per-chunk count to a multiple
        (e.g. the resampler's ``down``) so downstream block geometry repeats
        identically every chunk."""
        d = max(1, int(decimation))
        unit = d * max(1, int(out_align))
        if unit > max_chunk:
            unit = d  # pathological alignment: fall back to plain D-alignment
        n = max(unit, min(max_chunk // unit, max(1, round(target_chunk / unit))) * unit)
        # the carried tail requires chunk >= L-1
        min_units = -(-(int(num_taps) - 1) // unit)
        n = max(n, min_units * unit)
        return DDCPlan(num_taps=int(num_taps), decimation=d, chunk_size=n)


def bandpass_kernel(taps: np.ndarray, incs_fixed: list[int]) -> np.ndarray:
    """Per-channel complex bandpass taps as a pair conv kernel, float32
    ``(2C, 2, L)``: input features (xr, xi), output features
    (yr_0, yi_0, yr_1, yi_1, ...), tap axis reversed (correlation form).

    ``g[j] = h[j] * e^{-j*theta*j}`` with theta from the uint32 fixed-point
    increment (exact modular phase, float64 trig on the host).
    """
    taps64 = np.asarray(taps, dtype=np.float64)
    L = taps64.size
    C = len(incs_fixed)
    kernel = np.empty((2 * C, 2, L), dtype=np.float64)
    j = np.arange(L, dtype=np.uint64)
    for c, inc in enumerate(incs_fixed):
        phase_counts = (np.uint64(inc) * j) % np.uint64(_TWO32)  # exact
        theta_j = phase_counts.astype(np.float64) * _RAD_PER_COUNT
        gr = taps64 * np.cos(theta_j)
        gi = -taps64 * np.sin(theta_j)
        gr_rev, gi_rev = gr[::-1], gi[::-1]
        # yr = gr*xr - gi*xi ; yi = gi*xr + gr*xi
        kernel[2 * c, 0] = gr_rev
        kernel[2 * c, 1] = -gi_rev
        kernel[2 * c + 1, 0] = gi_rev
        kernel[2 * c + 1, 1] = gr_rev
    return kernel.astype(np.float32)


def interleave_kernel(kernel_np: np.ndarray, iq_order: str = "iq") -> np.ndarray:
    """Repack the pair kernel ``(2C, 2, L)`` into the interleaved-domain
    kernel ``(2C, 1, 2L)`` that filters the scaled RAW sample stream (I/Q
    interleaved, as stored in the capture) at window stride ``2D``.

    The IQ-order convention (``iq``/``qi`` slot order, ``*_inv`` negates Q)
    is folded into the taps: channel-0 taps land on the raw slot holding I,
    the (sign-adjusted) channel-1 taps on the slot holding Q.
    """
    out_ch, in_ch, L = kernel_np.shape
    assert in_ch == 2, kernel_np.shape
    if iq_order not in {"iq", "qi", "iq_inv", "qi_inv"}:
        raise ValueError(f"Unsupported iq_order '{iq_order}'")
    first, second = (0, 1) if iq_order.startswith("iq") else (1, 0)
    qsign = -1.0 if iq_order.endswith("_inv") else 1.0
    ki = np.zeros((out_ch, 1, 2 * L), dtype=np.float32)
    ki[:, 0, first::2] = kernel_np[:, 0, :]
    ki[:, 0, second::2] = qsign * kernel_np[:, 1, :]
    return ki


def lowrate_osc(phase0_fixed: torch.Tensor, inc_lo_fixed: torch.Tensor, m: int):
    """(cos, sin) of the decimated-rate oscillator, shapes ``(..., m)``.

    ``phase0_fixed``/``inc_lo_fixed`` are per-channel int64 tensors holding
    uint32 values; the angle is ``float32(ph) * float32(2*pi / 2**32)``
    exactly as the JAX package rounds it.
    """
    n = torch.arange(m, dtype=torch.int64, device=phase0_fixed.device)
    ph = (phase0_fixed[..., None] + inc_lo_fixed[..., None] * n) & MASK32
    rad = torch.tensor(_RAD_PER_COUNT, dtype=torch.float32, device=ph.device)
    angle = ph.to(torch.float32) * rad
    return torch.cos(angle), torch.sin(angle)


def mix_and_advance(
    br: torch.Tensor,
    bi: torch.Tensor,
    phase0_fixed: torch.Tensor,
    inc_lo_fixed: torch.Tensor,
    m: int,
):
    """Rotate the decimated baseband by the per-channel oscillator and
    advance the phase by exactly ``m`` low-rate steps (mod 2**32).

    Returns ``(yr, yi, phase_next)``.
    """
    cos, sin = lowrate_osc(phase0_fixed, inc_lo_fixed, m)
    yr = br * cos - bi * sin
    yi = br * sin + bi * cos
    phase_next = (phase0_fixed + inc_lo_fixed * m) & MASK32
    return yr, yi, phase_next


def ddc_apply_il(
    plan: DDCPlan,
    poly_w: torch.Tensor,
    f: torch.Tensor,
    itail: torch.Tensor,
    phase0_fixed: torch.Tensor,
    inc_lo_fixed: torch.Tensor,
):
    """Interleaved-domain DDC: mix+filter+decimate straight off the scaled
    raw stream through the polyphase FIR.

    Parameters
    ----------
    poly_w: ``(K, 2D, 2C)`` = ``build_poly_kernel(interleave_kernel(...), 2D)``.
    f: float32 ``(2N,)`` scaled raw interleaved samples.
    itail: float32 ``(2(L-1),)`` carried raw-domain tail.

    Returns ``(yr, yi, new_itail, phase_next)``; ``yr/yi`` shaped ``(C, m)``.
    """
    L, D, N = plan.num_taps, plan.decimation, plan.chunk_size
    assert f.shape[-1] == 2 * N
    m = plan.out_size
    x = torch.cat([itail, f])  # (2(L-1) + 2N,)
    bb = poly_fir_il(x, poly_w, D, m).reshape(-1, 2, m)
    yr, yi, phase_next = mix_and_advance(
        bb[:, 0], bb[:, 1], phase0_fixed, inc_lo_fixed, m
    )
    # clone: a view would keep the whole chunk alive in the carried state
    new_itail = f[2 * N - 2 * (L - 1) :].clone() if L > 1 else itail
    return yr, yi, new_itail, phase_next


def ddc_apply(
    plan: DDCPlan,
    kernel: torch.Tensor,
    xr: torch.Tensor,
    xi: torch.Tensor,
    tail: torch.Tensor,
    phase0_fixed: torch.Tensor,
    inc_lo_fixed: torch.Tensor,
    *,
    poly_w: torch.Tensor | None = None,
):
    """One chunk of an (re, im) pair through mix+filter+decimate.

    Parameters
    ----------
    kernel: ``(2C, 2, L)`` from :func:`bandpass_kernel`.
    xr, xi: ``(N,)`` input pair (N = plan.chunk_size).
    tail: ``(2, L-1)`` carried input tail (rows: re, im).
    phase0_fixed, inc_lo_fixed: ``(C,)`` int64 holding uint32 values.
    poly_w: optional ``(K, 2D, 2C)`` = ``build_poly_kernel(kernel, D)``: the
        FIR then runs through :func:`~iq_to_audio_torch.ops.poly_fir.poly_fir_pair`
        instead of ``conv1d``.

    Returns ``(yr, yi, new_tail, phase_next)`` with ``yr/yi`` of shape
    ``(C, N/D)``.
    """
    L, D, N = plan.num_taps, plan.decimation, plan.chunk_size
    assert xr.shape[-1] == N
    m = plan.out_size
    x_pair = torch.stack([torch.cat([tail[0], xr]), torch.cat([tail[1], xi])])
    if poly_w is not None:
        bb = poly_fir_pair(x_pair, poly_w, D, m).reshape(-1, 2, m)
    else:
        with torch.backends.cudnn.flags(allow_tf32=False):
            out = torch.nn.functional.conv1d(x_pair[None], kernel, stride=D)
        bb = out[0].reshape(-1, 2, m)
    yr, yi, phase_next = mix_and_advance(
        bb[:, 0], bb[:, 1], phase0_fixed, inc_lo_fixed, m
    )
    if L > 1:
        new_tail = torch.stack([xr[N - (L - 1) :], xi[N - (L - 1) :]])
    else:
        new_tail = tail
    return yr, yi, new_tail, phase_next
