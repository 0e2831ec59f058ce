"""Digital downconverter: mix + channel filter + decimate as one decimating
polyphase FIR over the raw interleaved sample stream.

Port of the JAX package's ``ops/ddc.py``.  Mixing commutes into
the taps (``g[j] = h[j] * e^{-j*theta*j}``, :func:`bandpass_kernel`), so the
full-rate NCO disappears: the raw stream is filtered by per-channel bandpass
taps at stride ``2D`` and the oscillator runs only at the decimated rate
(:func:`mix_and_advance`).

:func:`ddc_apply_il` carries the JAX package's four formulations of that
filter: the hand-written polyphase FIR
(:func:`iq_to_audio_torch.ops.poly_fir.poly_fir_il`, what the chunk step
runs), and, as reference functions that the tests and the on-card check
hold and time against it, the shifted dense matmul
(:func:`shift_matmul_kernel`), the lane-filling J-conv
(:func:`j_lanes_kernel`) and the plain strided ``conv1d``.
:func:`ddc_apply_fft_il` / :func:`ddc_apply_fft` are the overlap-save FFT
bank (:mod:`.osfir`), and :func:`ddc_fullrate_stages` the full-rate stages
of the first-chunk snapshots.

:func:`ddc_apply` is the pair-input entry point of the JAX package (an
(re, im) pair with a ``(2, L-1)`` tail): through the same kernel over the
pair (:func:`~iq_to_audio_torch.ops.poly_fir.poly_fir_pair`) when given the
polyphase tensor, else as a strided ``conv1d`` with TF32 off.

Phase is 62-bit fixed point (1 cycle == 2**62 counts, :mod:`.nco`), held
as ``int64`` in ``[0, 2**62)``.  The JAX package's is uint32: the angle here
comes from the top 32 bits, rounded as it rounds its uint32 phase, so with
an increment on the uint32 grid (a zero residual) the oscillator is the JAX
package's bit for bit.  :func:`nco_advance` splits each product so that no
int64 intermediate overflows: the phase is exact modular arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .nco import LOW_BITS, MASK62, PHASE_BITS, device_increment
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


def bandpass_kernel(
    taps: np.ndarray, incs_fixed: list[int], residuals: list[int] | None = None
) -> np.ndarray:
    """Per-channel complex bandpass taps as a pair conv kernel, float32
    ``(2C, 2, L)``: input features (xr, xi), output features
    (yr_0, yi_0, yr_1, yi_1, ...), tap axis reversed (correlation form).

    ``g[j] = h[j] * e^{-j*theta*j}`` with theta from the device NCO's 62-bit
    increment (:func:`~.nco.device_increment` of the uint32 ``incs_fixed``
    and their ``residuals``, zero when not given): exact modular phase,
    float64 trig on the host.
    """
    taps64 = np.asarray(taps, dtype=np.float64)
    L = taps64.size
    C = len(incs_fixed)
    kernel = np.empty((2 * C, 2, L), dtype=np.float64)
    j = np.arange(L, dtype=np.uint64)
    for c, inc in enumerate(incs_fixed):
        inc62 = np.uint64(device_increment(inc, residuals[c] if residuals else 0))
        phase62 = (inc62 * j) & np.uint64(MASK62)  # uint64 products wrap mod 2**64
        theta_j = phase62.astype(np.float64) * (2.0 * np.pi / (1 << PHASE_BITS))
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


def j_lanes_kernel(kernel_il: np.ndarray, decimation: int, j_lanes: int) -> np.ndarray:
    """Output-channel-augmented interleaved kernel: ``J`` consecutive
    decimated outputs packed into the channel axis (stride ``J*2D``, width
    ``2L + (J-1)*2D``); channel ``o*J + j`` of output block ``r`` is
    plain-filter output ``(o, r*J + j)``.  Feeds the J-conv branch of
    :func:`ddc_apply_il` and :func:`shift_matmul_kernel`."""
    out_ch, in_ch, width = kernel_il.shape
    assert in_ch == 1, kernel_il.shape
    d2 = 2 * decimation
    wj = np.zeros((out_ch * j_lanes, 1, width + (j_lanes - 1) * d2), np.float32)
    for o in range(out_ch):
        for j in range(j_lanes):
            wj[o * j_lanes + j, 0, j * d2 : j * d2 + width] = kernel_il[o, 0, :]
    return wj


def shift_matmul_kernel(kernel_il: np.ndarray, decimation: int, j_lanes: int) -> np.ndarray:
    """Shifted-dense-matmul repack of :func:`j_lanes_kernel`: splitting the
    tap axis at stride boundaries turns the banded product into
    ``n_shift = ceil(width/stride)`` dense products over the contiguous
    reshape ``A = x.reshape(rows, stride)``, ``Y[r] = sum_s A[r + s] @ W_s``.

    Returns float32 ``(n_shift, stride, J*2C)``, columns channel-major
    (``o*J + j``).  Feeds the shifted-matmul branch of :func:`ddc_apply_il`
    (``torch.matmul``); the CUDA channelizer computes the same product with
    ``J = 4`` without building the tensor, and the tests hold its indexer
    (:func:`iq_to_audio_torch.ops.poly_fir.shifted_taps`) against this one.
    """
    wj = j_lanes_kernel(kernel_il, decimation, j_lanes)  # (J*2C, 1, width)
    out_rows, _, width = wj.shape
    stride = j_lanes * 2 * decimation
    n_shift = -(-width // stride)
    w = np.zeros((n_shift, stride, out_rows), np.float32)
    for s in range(n_shift):
        seg = wj[:, 0, s * stride : (s + 1) * stride]  # (J*2C, <=stride)
        w[s, : seg.shape[1], :] = seg.T
    return w


def nco_advance(phase0: torch.Tensor, inc: torch.Tensor, k: int) -> torch.Tensor:
    """``(phase0 + inc * k) mod 2**62``, exact: per-channel int64 ``phase0``
    and ``inc`` in ``[0, 2**62)``, ``0 <= k < 2**30`` steps.  The increment's
    halves are multiplied apart, so no int64 product overflows."""
    hi, lo = inc >> LOW_BITS, inc & ((1 << LOW_BITS) - 1)
    return (phase0 + lo * k + (((hi * k) & MASK32) << LOW_BITS)) & MASK62


def lowrate_osc(phase0_fixed: torch.Tensor, inc_lo_fixed: torch.Tensor, m: int):
    """(cos, sin) of the decimated-rate oscillator, shapes ``(..., m)``.

    ``phase0_fixed``/``inc_lo_fixed`` are per-channel int64 tensors holding
    62-bit values; the angle is ``float32(ph) * float32(2*pi / 2**32)`` of
    the top 32 bits ``ph`` of the phase, exactly as the JAX package rounds
    its uint32 phase.  ``ph`` is summed from the halves of the increment,
    so no product overflows (``m < 2**30``).
    """
    n = torch.arange(m, dtype=torch.int64, device=phase0_fixed.device)
    inc = inc_lo_fixed[..., None]
    hi, lo = inc >> LOW_BITS, inc & ((1 << LOW_BITS) - 1)
    ph = (hi * n + ((phase0_fixed[..., None] + lo * n) >> LOW_BITS)) & MASK32
    # a fill, not a copy from the host: the call stays capturable in a CUDA graph
    rad = ph.new_full((), _RAD_PER_COUNT, dtype=torch.float32)
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
    advance the phase by exactly ``m`` low-rate steps (mod 2**62).

    Returns ``(yr, yi, phase_next)``.
    """
    cos, sin = lowrate_osc(phase0_fixed, inc_lo_fixed, m)
    yr = br * cos - bi * sin
    yi = br * sin + bi * cos
    return yr, yi, nco_advance(phase0_fixed, inc_lo_fixed, m)


def _pad_or_trim(x: torch.Tensor, need: int) -> torch.Tensor:
    pad = need - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad > 0 else x[:need]


def fir_il(
    x: torch.Tensor,
    decimation: int,
    m: int,
    num_taps: int,
    *,
    poly_w: torch.Tensor | None = None,
    kernel_il: torch.Tensor | None = None,
    j_kernel: torch.Tensor | None = None,
    j_lanes: int = 1,
    mm_kernel: torch.Tensor | None = None,
) -> torch.Tensor:
    """The decimating bandpass FIR over the interleaved stream ``x`` (tail
    first, ``2(L-1) + 2N`` floats): ``m`` outputs at stride ``2D`` for each
    of the ``2C`` kernel rows, float32 ``(2C, m)``, in the formulation the
    given kernel selects (see :func:`ddc_apply_il`)."""
    D, L = decimation, num_taps
    if poly_w is not None:
        return poly_fir_il(x, poly_w, D, m)
    if mm_kernel is not None and j_lanes > 1:
        # real outputs (i < m) read exactly x[i*2D : i*2D + 2L] through
        # nonzero weights; only discarded tail lanes can touch the zero pad
        n_shift, stride, rows = mm_kernel.shape
        r_blocks = -(-m // j_lanes)
        a = _pad_or_trim(x, (r_blocks + n_shift) * stride).view(r_blocks + n_shift, stride)
        y = torch.matmul(a[:r_blocks], mm_kernel[0])
        for s in range(1, n_shift):
            y = y + torch.matmul(a[s : s + r_blocks], mm_kernel[s])
        # (R, J*2C) columns channel-major (o*J + j) -> (2C, m)
        cdim = rows // j_lanes
        yt = y.view(r_blocks, cdim, j_lanes).transpose(0, 1).reshape(cdim, r_blocks * j_lanes)
        return yt[:, :m]
    if j_kernel is not None and j_lanes > 1:
        # J consecutive decimated outputs ride the output-channel axis;
        # real outputs never read the zero pad
        d2 = 2 * D
        r_blocks = -(-m // j_lanes)
        xj = _pad_or_trim(x, (r_blocks * j_lanes - 1) * d2 + 2 * L)
        with torch.backends.cudnn.flags(allow_tf32=False):
            yj = torch.nn.functional.conv1d(xj[None, None], j_kernel, stride=j_lanes * d2)[0]
        # (2C*J, R), rows channel-major (o*J + j)
        cdim = yj.shape[0] // j_lanes
        y = yj.view(cdim, j_lanes, r_blocks).transpose(1, 2).reshape(cdim, r_blocks * j_lanes)
        return y[:, :m]
    if kernel_il is None:
        raise ValueError("the FIR needs poly_w, mm_kernel, j_kernel or kernel_il")
    with torch.backends.cudnn.flags(allow_tf32=False):
        return torch.nn.functional.conv1d(x[None, None], kernel_il, stride=2 * D)[0]


def ddc_apply_il(
    plan: DDCPlan,
    poly_w: torch.Tensor | None,
    f: torch.Tensor,
    itail: torch.Tensor,
    phase0_fixed: torch.Tensor,
    inc_lo_fixed: torch.Tensor,
    *,
    kernel_il: torch.Tensor | None = None,
    j_kernel: torch.Tensor | None = None,
    j_lanes: int = 1,
    mm_kernel: torch.Tensor | None = None,
):
    """Interleaved-domain DDC: mix+filter+decimate straight off the scaled
    raw stream, no de-interleave.

    Parameters
    ----------
    poly_w: ``(K, 2D, 2C)`` = ``build_poly_kernel(interleave_kernel(...), 2D)``:
        selects the hand-written polyphase FIR; ``None`` selects one of the
        library formulations below (references: no chunk step passes them).
    f: float32 ``(2N,)`` scaled raw interleaved samples.
    itail: float32 ``(2(L-1),)`` carried raw-domain tail.
    kernel_il: ``(2C, 1, 2L)`` from :func:`interleave_kernel`: the plain
        ``conv1d`` at stride ``2D``.
    j_kernel/j_lanes: the output-channel-augmented kernel from
        :func:`j_lanes_kernel`: ``conv1d`` at stride ``J*2D``.
    mm_kernel: ``(n_shift, stride, J*2C)`` from :func:`shift_matmul_kernel`
        (requires ``j_lanes > 1``): ``n_shift`` dense ``torch.matmul``s over
        the contiguous ``(rows, stride)`` reshape.

    The convolutions run with cuDNN's TF32 off; the matmuls need
    ``torch.backends.cuda.matmul.allow_tf32`` off (torch's default).

    Returns ``(yr, yi, new_itail, phase_next)``; ``yr/yi`` shaped ``(C, m)``.
    """
    L, D, N = plan.num_taps, plan.decimation, plan.chunk_size
    assert f.shape[-1] == 2 * N
    m = plan.out_size
    x = torch.cat([itail, f])  # (2(L-1) + 2N,)
    bb = fir_il(
        x, D, m, L, poly_w=poly_w, kernel_il=kernel_il, j_kernel=j_kernel, j_lanes=j_lanes,
        mm_kernel=mm_kernel,
    ).reshape(-1, 2, m)
    yr, yi, phase_next = mix_and_advance(
        bb[:, 0], bb[:, 1], phase0_fixed, inc_lo_fixed, m
    )
    # clone: a view would keep the whole chunk alive in the carried state
    new_itail = f[2 * N - 2 * (L - 1) :].clone() if L > 1 else itail
    return yr, yi, new_itail, phase_next


def bank_from_kernel(kernel_np: np.ndarray, os_plan) -> np.ndarray:
    """Recover the complex bandpass bank from a pair kernel built by
    :func:`bandpass_kernel` (undo the tap reversal), transformed to
    ``(C, fft_size)`` complex64 for the overlap-save channelizer, or to the
    ``(C, fold, fft_size/fold)`` combine gains when the plan uses the
    polyphase forward.

    ``os_plan`` is the :class:`~.osfir.OverlapSavePlan` the bank feeds (its
    fold shift and scale are baked in); a bare ``int`` FFT size yields the
    plain fold-free responses.
    """
    from .osfir import taps_fft

    C = kernel_np.shape[0] // 2
    rows = []
    for c in range(C):
        g = (
            kernel_np[2 * c, 0][::-1].astype(np.float64)
            + 1j * kernel_np[2 * c + 1, 0][::-1].astype(np.float64)
        )
        rows.append(taps_fft(g, os_plan))
    return np.stack(rows)


def complex_from_interleaved(f: torch.Tensor, iq_order: str) -> torch.Tensor:
    """The ordered complex stream off the scaled interleaved float32 stream.

    A complex64 tensor's memory is ``[re, im]`` pairs, exactly the
    interleaved stream, so ``view_as_complex`` reinterprets in place (``f``
    must be contiguous at an 8-byte-aligned offset) and the four IQ orders
    are unit elementwise transforms:

    ========  ===================  =======================
    order     stream pairs (a,b)   wanted i + 1j*q
    ========  ===================  =======================
    iq        (i, q)               v
    iq_inv    (i, q), q negated    conj(v)
    qi        (q, i)               1j * conj(v)
    qi_inv    (q, i), q negated    -1j * v
    ========  ===================  =======================
    """
    v = torch.view_as_complex(f.view(-1, 2))
    if iq_order == "iq":
        return v
    if iq_order == "iq_inv":
        return torch.conj_physical(v)
    if iq_order == "qi":
        return 1j * torch.conj_physical(v)
    if iq_order == "qi_inv":
        return -1j * v
    raise ValueError(f"Unknown IQ order '{iq_order}'")


def _fft_bank_mix(plan, os_plan, h_bank, x, tail, phase0_fixed, inc_lo_fixed):
    from .osfir import os_fir_bank

    tail_c = torch.complex(tail[0], tail[1])
    dec, _ = os_fir_bank(os_plan, h_bank, x, tail_c)  # (C, m) complex
    return mix_and_advance(dec.real, dec.imag, phase0_fixed, inc_lo_fixed, plan.out_size)


def ddc_apply_fft_il(
    plan: DDCPlan,
    os_plan,
    h_bank: torch.Tensor,
    f: torch.Tensor,
    tail: torch.Tensor,
    phase0_fixed: torch.Tensor,
    inc_lo_fixed: torch.Tensor,
    iq_order: str = "iq",
):
    """:func:`ddc_apply_fft` fed the scaled raw interleaved stream (the
    pipeline's fft-channelizer path): the complex input is the view of
    :func:`complex_from_interleaved`.  The state is that of
    :func:`ddc_apply_fft`, the ``(2, L-1)`` pair tail."""
    L, N = plan.num_taps, plan.chunk_size
    assert f.shape[-1] == 2 * N
    x = complex_from_interleaved(f, iq_order)
    yr, yi, phase_next = _fft_bank_mix(
        plan, os_plan, h_bank, x, tail, phase0_fixed, inc_lo_fixed
    )
    if L > 1:
        tail_x = x[N - (L - 1) :]
        new_tail = torch.stack([tail_x.real, tail_x.imag])
    else:
        new_tail = tail
    return yr, yi, new_tail, phase_next


def ddc_apply_fft(
    plan: DDCPlan,
    os_plan,
    h_bank: torch.Tensor,
    xr: torch.Tensor,
    xi: torch.Tensor,
    tail: torch.Tensor,
    phase0_fixed: torch.Tensor,
    inc_lo_fixed: torch.Tensor,
):
    """FFT-channelizer variant of :func:`ddc_apply` (same inputs, same
    state, same outputs at FFT numerics): batched overlap-save filtering
    with the per-channel bandpass bank, then the identical low-rate mix.
    Selected in the pipeline with ``IQ2A_CHANNELIZER=fft``."""
    L, N = plan.num_taps, plan.chunk_size
    assert xr.shape[-1] == N
    yr, yi, phase_next = _fft_bank_mix(
        plan, os_plan, h_bank, torch.complex(xr, xi), tail, phase0_fixed, inc_lo_fixed
    )
    if L > 1:
        new_tail = torch.stack([xr[N - (L - 1) :], xi[N - (L - 1) :]])
    else:
        new_tail = tail
    return yr, yi, new_tail, phase_next


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
    phase0_fixed, inc_lo_fixed: ``(C,)`` int64 holding 62-bit values.
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


def ddc_fullrate_stages(
    plan: DDCPlan,
    kernel: torch.Tensor,
    xr: torch.Tensor,
    xi: torch.Tensor,
    tail: torch.Tensor,
    phase0_fixed: torch.Tensor,
    inc_fixed: torch.Tensor,
):
    """Full-rate mixed/filtered stages (stride-1 ``conv1d`` of the pair plus
    the full-rate NCO).

    Only used for the first-chunk stage snapshots; costs D times the normal
    step, so it never runs in the hot loop.
    Returns (mixed_r, mixed_i, filtered_r, filtered_i), each ``(C, N)``.
    """
    N = plan.chunk_size
    x_full = torch.stack([torch.cat([tail[0], xr]), torch.cat([tail[1], xi])])[None]
    with torch.backends.cudnn.flags(allow_tf32=False):
        out = torch.nn.functional.conv1d(x_full, kernel)[0].reshape(-1, 2, N)
    br, bi = out[:, 0], out[:, 1]
    cos, sin = lowrate_osc(phase0_fixed, inc_fixed, N)
    filt_r = br * cos - bi * sin
    filt_i = br * sin + bi * cos
    mix_r = xr[None] * cos - xi[None] * sin
    mix_i = xr[None] * sin + xi[None] * cos
    return mix_r, mix_i, filt_r, filt_i
