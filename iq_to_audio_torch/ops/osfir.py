"""Streaming overlap-save FFT FIR filtering fused with decimation, on
``torch.fft`` in complex64 (port of the JAX package's ``ops/osfir.py``).

* All FFT frames of a chunk are batched into a single ``(K, F)`` complex64
  FFT.
* The frame hop ``B`` is the largest multiple of the decimation factor ``D``
  that fits the FFT (``B = D * ((F - L + 1) // D)``), so every chunk
  produces exactly ``N/D`` channel samples with a phase-0 stride and the
  decimator needs no carried offset.
* Decimation is **alias-folded into the inverse FFT** (exact): only every
  D-th filtered sample survives, and for any ``f | gcd(D, F)`` those
  samples are the length-``F/f`` inverse DFT of the product spectrum folded
  modulo ``F/f``.  A circular shift of ``L-1`` samples (baked into the tap
  spectrum as a phase ramp) aligns the kept samples to multiples of ``f``.
* The full ``f = D`` fold needs ``D | F``, which for most decimations makes
  ``F`` mixed-radix, so the **polyphase forward** computes the folded
  product spectrum without a non-power-of-two FFT.  With ``F = D * Fp``
  (``Fp`` a power of two), split each frame into its ``D`` decimation
  phases ``x_p[t] = x[D*t + p]`` and FFT those.  Cooley-Tukey gives
  ``X[q*Fp+s] = sum_p W_D^{pq} * W_F^{ps} * Xp[s]``, so the folded product
  collapses to one precomputed per-branch gain:

      folded[s] = sum_q (X*H)[q*Fp+s] = sum_p Xp[p,s] * Ghat[p,s],
      Ghat[p,s] = W_F^{ps} * sum_q H[q*Fp+s] * W_D^{pq}

  The identity is exact: same product spectrum, same folded samples.

The mixed-radix and polyphase-forward plan families are tuned for a host
CPU's FFT; the planner offers them only when asked (``cpu_tuned=True``, as
the pipeline asks when the run's device is the CPU).  On a CUDA device the
plan stays on contiguous power-of-two framing.

Chunked output is bit-identical to whole-signal filtering because the
(L-1)-sample input tail is carried between chunks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

import torch


def _next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, n))))


@dataclass(frozen=True)
class OverlapSavePlan:
    """Static (hashable) geometry of one streaming filter configuration."""

    num_taps: int  # L
    fft_size: int  # F (power of two, or D * power of two when poly)
    block: int  # B: hop per frame, multiple of decimation
    decimation: int  # D
    num_frames: int  # K frames per chunk
    chunk_size: int  # N = K * B input samples per chunk
    fold: int = 1  # inverse-FFT alias fold factor, divides gcd(D, F)
    poly: bool = False  # polyphase forward (full f=D fold, F = D * 2**k)

    @property
    def overlap(self) -> int:
        return self.num_taps - 1

    @property
    def out_size(self) -> int:
        return self.chunk_size // self.decimation

    @property
    def h_shift(self) -> int:
        """Circular shift baked into the tap spectrum (see module doc)."""
        return self.num_taps - 1 if self.fold > 1 else 0

    @property
    def h_scale(self) -> float:
        """ifft renormalisation baked into the tap spectrum: folding by f
        turns the 1/F of the full inverse DFT into 1/(F/f)."""
        return 1.0 / self.fold

    @staticmethod
    def create(
        num_taps: int,
        decimation: int,
        *,
        target_chunk: int = 1 << 22,
        fft_size: int | None = None,
        max_chunk: int = 1 << 22,
        cpu_tuned: bool = False,
    ) -> "OverlapSavePlan":
        """Pick FFT size / hop / frame count for a filter+decimation pair.

        ``fft_size=None`` auto-selects the F minimising forward + folded
        inverse FFT work per input sample.  Candidates are the powers of two
        in the usual window plus ``odd(D) * 2**k`` sizes (which admit the
        full fold ``f = D``) and the polyphase-forward sizes ``D * 2**k``,
        both only with ``cpu_tuned`` (their cost constants are a host CPU's;
        non-power-of-two sizes carry a mixed-radix penalty).
        ``target_chunk`` requests roughly that many input samples per chunk.
        """
        L = int(num_taps)
        D = max(1, int(decimation))
        odd = D
        while odd % 2 == 0:
            odd //= 2

        def work(n: int, pen: float = 1.0) -> float:
            return n * math.log2(n) * pen if n > 1 else 0.0

        def _cost(cand: tuple[int, bool]) -> float:
            F, poly = cand
            b = D * ((F - L + 1) // D)
            if b < 1:
                return float("inf")
            if poly:
                # polyphase forward: D batched FFTs of Fp = F/D points plus
                # an O(F) gain-combine, then one Fp-point inverse — all
                # power-of-two.  Branch arrays of F complex64 above
                # ~256 KiB spill a host core's cache and are costed double.
                Fp = F // D
                pen = 1.0 if F * 8 <= (256 << 10) else 2.0
                fwd = F * math.log2(Fp) * pen if Fp > 1 else 0.0
                return (fwd + 1.3 * F * pen + work(Fp)) / b
            f = math.gcd(D, F)
            # a host FFT's premium per point for odd(D)*2**k sizes
            def pen_of(n: int) -> float:
                return 1.0 if n & (n - 1) == 0 else 1.45
            return (work(F, pen_of(F)) + work(F // f, pen_of(F // f))) / b

        poly = False
        if fft_size is not None:
            F = int(fft_size)
            if F & (F - 1):  # honor an explicit odd(D)*2**k size verbatim
                if F % odd or (F // odd) & (F // odd - 1):
                    F = _next_pow2(F)
            if F < L - 1 + D:
                F = _next_pow2(L - 1 + D)
        else:
            lo = _next_pow2(max(2 * L, 4096, L - 1 + D))
            hi = max(lo, 1 << 18)
            candidates: list[tuple[int, bool]] = []
            F = lo
            while F <= hi:
                candidates.append((F, False))
                F <<= 1
            if odd > 1 and cpu_tuned:
                F = odd
                while F < lo // 2:
                    F <<= 1
                while F <= hi:
                    if F % D == 0 and F >= L - 1 + D:
                        candidates.append((F, False))
                    F <<= 1
            if D > 1 and cpu_tuned:
                # full-fold candidates F = D * 2**k for the polyphase
                # forward — exact for ANY decimation, no mixed-radix FFT
                Fp = 256
                while D * Fp < L - 1 + D:
                    Fp <<= 1
                while D * Fp <= 2 * hi:
                    candidates.append((D * Fp, True))
                    Fp <<= 1
            F, poly = min(candidates, key=_cost)
        B = D * ((F - L + 1) // D)
        while B < 1:
            F <<= 1
            B = D * ((F - L + 1) // D)
        K = max(1, min(max_chunk // B, int(round(target_chunk / B)) or 1))
        # the carried tail is L-1 samples sliced from the CHUNK, so the
        # chunk must hold at least that many — a small target_chunk with a
        # long filter would otherwise silently corrupt every chunk after
        # the first (the conv planner enforces the same floor, ddc.py)
        K = max(K, -(-(L - 1) // B))
        return OverlapSavePlan(
            num_taps=L,
            fft_size=F,
            block=B,
            decimation=D,
            num_frames=K,
            chunk_size=K * B,
            fold=D if poly else math.gcd(D, F),
            poly=poly,
        )

    @staticmethod
    def for_chunk(
        num_taps: int,
        decimation: int,
        chunk_size: int,
        *,
        fft_size: int | None = None,
        cpu_tuned: bool = False,
    ) -> "OverlapSavePlan":
        """Frame geometry for an EXTERNALLY fixed chunk size (e.g. one shared
        with the conv-DDC planner).  ``chunk_size`` must be a multiple of the
        decimation; the final frame zero-pads past the chunk and the excess
        outputs are sliced away (``K*B >= chunk_size``)."""
        L = int(num_taps)
        D = max(1, int(decimation))
        N = int(chunk_size)
        if N % D:
            raise ValueError(f"chunk {N} must be a multiple of decimation {D}")
        if N < L - 1:
            raise ValueError(
                f"chunk {N} is shorter than the carried tail (num_taps-1 = "
                f"{L - 1}); pick a chunk of at least L-1 samples"
            )
        base = OverlapSavePlan.create(
            L, D, target_chunk=N, fft_size=fft_size, max_chunk=max(N, 1 << 22),
            cpu_tuned=cpu_tuned,
        )
        B = base.block
        K = -(-N // B)
        return OverlapSavePlan(
            num_taps=L,
            fft_size=base.fft_size,
            block=B,
            decimation=D,
            num_frames=K,
            chunk_size=N,
            fold=base.fold,
            poly=base.poly,
        )


def taps_fft(taps: np.ndarray, plan: "OverlapSavePlan | int") -> np.ndarray:
    """Host-side (float64) frequency response of the padded taps.

    Pass the :class:`OverlapSavePlan` so the fold's circular shift and
    renormalisation are baked in; a bare ``int`` FFT size yields the plain
    (fold-free) response.  For a polyphase-forward plan the result is the
    per-branch combine gain ``Ghat`` of shape ``(fold, F/fold)`` (see the
    module doc) rather than the flat ``(F,)`` response.
    """
    if isinstance(plan, OverlapSavePlan):
        fft_size, shift, scale = plan.fft_size, plan.h_shift, plan.h_scale
        poly, fold = plan.poly, plan.fold
    else:
        fft_size, shift, scale = int(plan), 0, 1.0
        poly, fold = False, 1
    taps = np.asarray(taps)
    # complex128 padding: also serves complex bandpass taps (the FFT
    # channelizer bank, ddc.bank_from_kernel)
    padded = np.zeros(fft_size, dtype=np.complex128)
    padded[: len(taps)] = taps.astype(np.complex128)
    spec = np.fft.fft(padded)
    if shift or scale != 1.0:
        k = np.arange(fft_size, dtype=np.float64)
        spec = spec * scale * np.exp(2j * np.pi * k * shift / fft_size)
    if poly:
        # Ghat[p, s] = W_F^{ps} * sum_q H[q*Fp + s] * W_fold^{pq}; the inner
        # sum is a DFT across the alias axis q (np.fft.fft along axis 0)
        fp = fft_size // fold
        g = np.fft.fft(spec.reshape(fold, fp), axis=0)
        p = np.arange(fold, dtype=np.float64)[:, None]
        s = np.arange(fp, dtype=np.float64)[None, :]
        g = g * np.exp(-2j * np.pi * p * s / fft_size)
        return g.astype(np.complex64)
    return spec.astype(np.complex64)


def _extended(plan: OverlapSavePlan, x: torch.Tensor, tail: torch.Tensor):
    """Shared overlap-save framing prefix: tail-concat, end-pad, and the new
    carried tail.  One implementation for every forward path (plain frames
    and polyphase branches) so the padding/tail conventions cannot drift.

    Returns ``(x_ext, new_tail)`` with ``x_ext`` long enough for ``K``
    frames of ``F`` starting every ``B`` samples.
    """
    L, F, B, K, N = (
        plan.num_taps,
        plan.fft_size,
        plan.block,
        plan.num_frames,
        plan.chunk_size,
    )
    assert x.shape[-1] == N, (x.shape, N)
    pad = max(0, (K - 1) * B + F - (tail.shape[-1] + N))
    parts = [tail, x]
    if pad:
        parts.append(x.new_zeros((*x.shape[:-1], pad)))
    x_ext = torch.cat(parts, dim=-1)
    new_tail = x[..., N - (L - 1) :].clone() if L > 1 else x[..., :0]
    return x_ext, new_tail


def _framed(plan: OverlapSavePlan, x: torch.Tensor, tail: torch.Tensor):
    """Frames of the extended stream, ``(..., K, F)``: a strided view (frame
    ``k`` starts at ``k*B``), not a gather."""
    x_ext, new_tail = _extended(plan, x, tail)
    frames = x_ext.unfold(-1, plan.fft_size, plan.block)[..., : plan.num_frames, :]
    return frames, new_tail


def _frame_spectra(plan: OverlapSavePlan, x: torch.Tensor, tail: torch.Tensor):
    """Framing + full-``F`` forward FFT: ``(..., K, F)`` spectra."""
    frames, new_tail = _framed(plan, x, tail)
    return torch.fft.fft(frames, dim=-1), new_tail


def _poly_branch_spectra(plan: OverlapSavePlan, x: torch.Tensor, tail: torch.Tensor):
    """Framing + polyphase-branch forward FFTs for a ``plan.poly`` plan.

    Each frame splits into its ``fold`` decimation phases
    ``x_p[t] = frame[fold*t + p]`` and the branches are FFT'd batched:
    ``fold`` power-of-two FFTs of ``F/fold`` points instead of one
    length-``F`` mixed-radix FFT.  The branch split is a strided view of the
    frames (element ``[k, p, t]`` at ``k*B + t*fold + p``).  Returns
    ``(Xp, new_tail)`` with ``Xp`` shaped ``(..., K, fold, F/fold)``.
    """
    frames, new_tail = _framed(plan, x, tail)
    f, fp = plan.fold, plan.fft_size // plan.fold
    xp = frames.unflatten(-1, (fp, f)).transpose(-1, -2)  # (..., K, f, Fp)
    return torch.fft.fft(xp, dim=-1), new_tail


def os_fir_decimate(
    plan: OverlapSavePlan,
    h_fft: torch.Tensor,
    x: torch.Tensor,
    tail: torch.Tensor,
    *,
    return_filtered: bool = False,
):
    """Filter + decimate one chunk.

    Parameters
    ----------
    h_fft: complex64 ``(F,)`` — FFT of zero-padded taps.
    x: complex64 ``(..., N)`` — chunk (N = plan.chunk_size).
    tail: complex64 ``(..., L-1)`` — carried input tail.

    Returns ``(decimated, new_tail)`` with ``decimated`` of shape
    ``(..., N // D)``; with ``return_filtered=True`` additionally returns the
    full-rate filtered chunk (used for stage snapshots only).
    """
    L, B, D, K, N = (
        plan.num_taps,
        plan.block,
        plan.decimation,
        plan.num_frames,
        plan.chunk_size,
    )
    assert x.shape[-1] == N, (x.shape, N)
    if return_filtered and plan.fold > 1:
        raise ValueError(
            "return_filtered needs the full-rate inverse FFT; use a "
            "fold=1 plan (stage snapshots run on the conv channelizer)"
        )
    if plan.poly:
        xp, new_tail = _poly_branch_spectra(plan, x, tail)
        folded = (xp * h_fft).sum(dim=-2)  # h_fft is Ghat (fold, Fp)
        return _ifft_keep(plan, folded, x.shape[:-1]), new_tail
    spec, new_tail = _frame_spectra(plan, x, tail)
    if plan.fold > 1:
        dec = _folded_ifft_decimate(plan, spec * h_fft, x.shape[:-1])
        return dec, new_tail
    y = torch.fft.ifft(spec * h_fft, dim=-1)[..., L - 1 : L - 1 + B]
    y = y.reshape(*x.shape[:-1], K * B)[..., :N]
    dec = y[..., ::D]
    if return_filtered:
        return dec, new_tail, y
    return dec, new_tail


def _folded_ifft_decimate(plan: OverlapSavePlan, prod: torch.Tensor, lead):
    """Decimated filter output from the product spectrum via the alias fold.

    ``prod`` is ``(..., K, F)`` — the per-frame product spectra with the
    plan's ``L-1`` circular shift and ``1/fold`` scale already baked into
    the tap response, so the kept samples sit at local positions ``j*D``
    and the inverse DFT of the modulo-``F/fold`` folded spectrum yields
    them directly.  Returns ``(..., N // D)`` complex64.
    """
    f = plan.fold
    folded = prod.reshape(*prod.shape[:-1], f, plan.fft_size // f).sum(dim=-2)
    return _ifft_keep(plan, folded, lead)


def _ifft_keep(plan: OverlapSavePlan, folded: torch.Tensor, lead):
    """Inverse DFT of the folded product spectrum and the kept decimated
    samples: ``folded`` is ``(..., K, F/fold)``; returns ``(..., N // D)``."""
    B, D, K, N, f = (
        plan.block,
        plan.decimation,
        plan.num_frames,
        plan.chunk_size,
        plan.fold,
    )
    y = torch.fft.ifft(folded, dim=-1)  # (..., K, Fp): y'[q] = y[L-1 + q*f]
    step = D // f
    keep = B // D
    dec = y[..., : keep * step : step] if step > 1 else y[..., :keep]
    dec = dec.reshape(*lead, K * keep)[..., : N // D]
    return dec


def os_fir_bank(
    plan: OverlapSavePlan,
    h_bank: torch.Tensor,
    x: torch.Tensor,
    tail: torch.Tensor,
):
    """Filter ONE stream through a bank of C frequency responses.

    The input spectrum is computed once (``K`` frames) and multiplied by all
    ``C`` responses — the FFT-channelizer analogue of the polyphase FIR's
    shared input pass.

    Parameters
    ----------
    h_bank: complex64 ``(C, F)`` — FFTs of the per-channel (bandpass) taps
    (``(C, fold, F/fold)`` combine gains for a ``plan.poly`` plan).
    x: complex64 ``(N,)``; tail: complex64 ``(L-1,)``.

    Returns ``(dec, new_tail)`` with ``dec`` of shape ``(C, N // D)``.
    """
    L, B, D, K, N = (
        plan.num_taps,
        plan.block,
        plan.decimation,
        plan.num_frames,
        plan.chunk_size,
    )
    assert x.shape == (N,), (x.shape, N)
    if plan.poly:
        xp, new_tail = _poly_branch_spectra(plan, x, tail)  # (K, f, Fp)
        folded = (xp[None] * h_bank[:, None]).sum(dim=-2)  # (C, K, Fp)
        return _ifft_keep(plan, folded, (h_bank.shape[0],)), new_tail
    spec, new_tail = _frame_spectra(plan, x, tail)  # (K, F)
    prod = spec[None, :, :] * h_bank[:, None, :]  # (C, K, F)
    if plan.fold > 1:
        dec = _folded_ifft_decimate(plan, prod, (h_bank.shape[0],))
        return dec, new_tail
    y = torch.fft.ifft(prod, dim=-1)[..., L - 1 : L - 1 + B]  # (C, K, B)
    y = y.reshape(h_bank.shape[0], K * B)[:, :N]
    dec = y[:, ::D]
    return dec, new_tail
