"""Exact-polyphase rational resampler as one strided product.

Port of the JAX package's ``ops/resample.py`` (the plans and kernel design
are copies; :func:`polyphase_resample` is torch):

* The conversion ratio is reduced to an exact rational ``up/down`` (continued
  -fraction-capped denominator; rates in practice reduce exactly — e.g.
  2.5 MHz/26 -> 48 kHz is exactly 312/625).
* Resampling by ``up/down`` is **block-periodic**: outputs ``[t*up,(t+1)*up)``
  depend on inputs ``[t*down-K+1, (t+1)*down)`` through a FIXED matrix
  ``R (up x (down+K-1))`` of polyphase taps.  That is precisely a strided
  convolution with ``up`` output channels and stride ``down``, here an
  ``unfold`` of the input into ``(blocks, down+K-1)`` frames times the
  ``(down+K-1, up)`` matrix, in full float32, and *exact* polyphase (no
  phase interpolation error).
* Cross-chunk alignment is a host-tracked integer, so the window shift is
  plain slicing.

Output counts per chunk are computed exactly on the host
(:meth:`ResamplePlan.out_count`) — no device syncs.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from fractions import Fraction

import numpy as np
import torch

LOG = logging.getLogger(__name__)

TAPS_PER_PHASE = 32
# Exact ratios are used whenever the (up, down+K-1) conv kernel fits this
# budget; beyond it the ratio is approximated (with a loud ppm warning).
_MAX_KERNEL_BYTES = 16 << 20
#: denominator caps tried in order when the exact ratio's kernel exceeds
#: the budget.  The ladder runs all the way to 1: kernel bytes are
#: up*(down+K-1)*4, so a numerator-dominated (strong-upsampling) ratio only
#: fits once the denominator is small enough that up*K*4 <= budget —
#: stopping the ladder early used to keep a 100+ GB kernel and OOM.
_FALLBACK_DENS = (8192, 4096, 2048, 1024, 512, 128, 32, 8, 2, 1)


@dataclass(frozen=True)
class ResamplePlan:
    """Static geometry for one rational resampling configuration."""

    up: int
    down: int
    in_size: int  # input samples per chunk (static)
    taps_per_phase: int = TAPS_PER_PHASE
    #: diagnostic only (excluded from eq/hash); a real field so
    #: ``dataclasses.replace`` preserves it
    rate_error_ppm: float = field(default=0.0, compare=False)

    @property
    def identity(self) -> bool:
        return self.up == self.down

    @property
    def tail_len(self) -> int:
        """Carried input history: enough for alignment + filter memory."""
        return self.down + self.taps_per_phase

    @property
    def kernel_width(self) -> int:
        return self.down + self.taps_per_phase - 1

    @property
    def blocks_cap(self) -> int:
        """Blocks computed per chunk.  ``+2`` (not ``+1``) guarantees the
        trailing *incomplete* block is always materialised — its outputs read
        zero-padded input, which is exactly what the float64 twin computes at
        EOF, so the pipeline's final flush can always take them from the last
        chunk's buffer (any alignment offset, any in_size % down)."""
        return self.in_size // self.down + 2

    @property
    def out_capacity(self) -> int:
        if self.identity:
            return self.in_size
        return self.blocks_cap * self.up

    @property
    def aligned_len(self) -> int:
        """Static window: covers blocks_cap blocks from any
        alignment offset in [0, down]."""
        return (self.blocks_cap - 1) * self.down + self.kernel_width

    @staticmethod
    def create(input_rate: float, output_rate: float, in_size: int) -> "ResamplePlan":
        """Plan a rational resample.

        Uses the **exact** reduced ``out/in`` fraction whenever the resulting
        polyphase conv kernel fits :data:`_MAX_KERNEL_BYTES`; otherwise falls
        back to the best continued-fraction approximation that fits, and logs
        a WARNING with the resulting output-rate error in ppm (the reference's
        ffmpeg ``aresample`` handles arbitrary ratios exactly,
        reference ``processing.py:399-418`` — here exactness is traded only
        when the ratio is irreducible past the kernel budget).
        """
        # Recover the underlying rational rates: rates like 2.5e6/26 arrive
        # as floats (96153.846...) whose true ratio to 48 kHz is exactly
        # 312/625 — rounding to integers first would lose that.
        in_frac = Fraction(float(input_rate)).limit_denominator(1 << 20)
        out_frac = Fraction(float(output_rate)).limit_denominator(1 << 20)
        exact = out_frac / in_frac

        def kernel_bytes(f: Fraction) -> int:
            return f.numerator * (f.denominator + TAPS_PER_PHASE - 1) * 4

        frac = exact
        if kernel_bytes(exact) > _MAX_KERNEL_BYTES:
            for cap in _FALLBACK_DENS:
                frac = exact.limit_denominator(cap)
                if frac.numerator > 0 and kernel_bytes(frac) <= _MAX_KERNEL_BYTES:
                    break
            else:
                # even up/1 does not fit: the requested upsampling factor
                # alone exceeds the kernel budget — surface it instead of
                # attempting a hundred-GB allocation
                raise ValueError(
                    f"Resample ratio {float(exact):g} "
                    f"({output_rate:g}/{input_rate:g} Hz) cannot be realised "
                    f"within the {_MAX_KERNEL_BYTES >> 20} MiB polyphase "
                    "kernel budget."
                )
        error_ppm = 0.0
        if frac != exact:
            realised = float(input_rate) * frac.numerator / frac.denominator
            error_ppm = (realised - float(output_rate)) / float(output_rate) * 1e6
            LOG.warning(
                "Resample ratio %s approximated as %d/%d: output clock will "
                "run %.2f ppm %s (audio plays at %.3f Hz instead of %.1f "
                "Hz).  Exact ratio exceeds the %d MiB polyphase kernel "
                "budget.",
                exact,
                frac.numerator,
                frac.denominator,
                abs(error_ppm),
                "fast" if error_ppm > 0 else "slow",
                realised,
                float(output_rate),
                _MAX_KERNEL_BYTES >> 20,
            )
        return ResamplePlan(
            up=frac.numerator,
            down=frac.denominator,
            in_size=int(in_size),
            rate_error_ppm=error_ppm,
        )

    # -- exact host-side bookkeeping ----------------------------------------

    def blocks_done(self, total_in: int) -> int:
        """Blocks fully computable after ``total_in`` cumulative inputs."""
        return total_in // self.down

    def out_count(self, total_in_before: int, valid_new: int) -> int:
        """Valid new outputs for a chunk given cumulative input counts."""
        if self.identity:
            return valid_new
        done_after = self.blocks_done(total_in_before + valid_new)
        done_before = self.blocks_done(total_in_before)
        return (done_after - done_before) * self.up

    def final_flush_count(self, total_in: int, already_emitted: int) -> int:
        """At EOF (with the padded final chunk), additionally-valid outputs:
        everything whose input position floor(n*down/up) < total_in."""
        if self.identity:
            return 0
        total_valid = (total_in * self.up + self.down - 1) // self.down
        return max(0, total_valid - already_emitted)

    def chunk_offset(self, total_in_before: int) -> int:
        """Window offset for this chunk (see module docstring).

        x_full[i] = input[total_in_before - tail_len + i]; the first new
        block t0 = total_in_before // down reads inputs starting at
        t0*down - (K-1), i.e. x_full offset:
        """
        k = self.taps_per_phase
        t0 = self.blocks_done(total_in_before)
        off = t0 * self.down - (total_in_before - self.tail_len) - (k - 1)
        # off = down + 1 + (t0*down - total_in_before) in [2, down+1]
        return off


def design_resampler_prototype(
    up: int,
    down: int,
    taps_per_phase: int = TAPS_PER_PHASE,
    *,
    rolloff: float = 0.9125,
    beta: float = 9.5,
) -> np.ndarray:
    """float64 K*up-tap windowed-sinc prototype at the upsampled rate,
    phase-normalised to unity DC gain.  Shared by the device kernel builder
    and the float64 twin (:class:`iq_to_audio_torch.ref.chain.RefResampler`)."""
    K = taps_per_phase
    n = np.arange(K * up, dtype=np.float64)
    center = (K * up - 1) / 2.0
    cutoff = rolloff * min(1.0, up / down)  # relative to input Nyquist
    proto = cutoff * np.sinc(cutoff * (n - center) / up)
    proto *= np.kaiser(K * up, beta)
    for p in range(up):
        idx = p + up * np.arange(K)
        s = proto[idx].sum()
        if abs(s) > 1e-12:
            proto[idx] /= s
    return proto


def design_resampler_kernel(
    up: int,
    down: int,
    taps_per_phase: int = TAPS_PER_PHASE,
    *,
    rolloff: float = 0.9125,
    beta: float = 9.5,
) -> np.ndarray:
    """The block filter-bank matrix as a conv kernel, float32
    ``(up, 1, down+K-1)``.

    Output p of block t sits at input position t*down + p*down/up:
    ``y = sum_j proto[j*up + phi_p] * x[t*down + ip_p - j]`` with
    ``ip_p = (p*down)//up`` and ``phi_p = (p*down) % up``.
    """
    K = taps_per_phase
    proto = design_resampler_prototype(
        up, down, taps_per_phase, rolloff=rolloff, beta=beta
    )
    width = down + K - 1
    kernel = np.zeros((up, 1, width), dtype=np.float64)
    j = np.arange(K)
    for p in range(up):
        ip_p, phi_p = divmod(p * down, up)
        kappa = ip_p - j + (K - 1)  # in [0, width-1]
        kernel[p, 0, kappa] = proto[j * up + phi_p]
    return kernel.astype(np.float32)


def polyphase_resample(
    plan: ResamplePlan,
    kernel: torch.Tensor,
    x: torch.Tensor,
    tail: torch.Tensor,
    offset0: int,
):
    """Resample one chunk.

    Parameters
    ----------
    kernel: ``(up, 1, down+K-1)`` from :func:`design_resampler_kernel`.
    x: float32 ``(..., in_size)`` — chunk of channel-rate audio.
    tail: float32 ``(..., tail_len)`` — carried input history.
    offset0: host int from :meth:`ResamplePlan.chunk_offset`.

    Returns ``(y, new_tail)``; ``y`` has shape ``(..., out_capacity)`` and
    entries past the host-computed valid count are garbage by contract.
    """
    if plan.identity:
        return x, tail
    n_in = plan.in_size
    assert x.shape[-1] == n_in
    batch_shape = x.shape[:-1]
    xb = x.reshape(-1, n_in)
    tb = tail.reshape(-1, plan.tail_len)
    x_full = torch.cat([tb, xb], dim=-1)
    new_tail = x_full[:, -plan.tail_len :].reshape(*batch_shape, plan.tail_len).clone()
    pad = plan.aligned_len + plan.down + 1 - x_full.shape[-1]
    if pad > 0:
        x_full = torch.nn.functional.pad(x_full, (0, pad))
    start = int(offset0)
    aligned = x_full[:, start : start + plan.aligned_len]
    frames = aligned.unfold(-1, plan.kernel_width, plan.down)  # (B, blocks, width)
    y = frames @ kernel[:, 0, :].T  # (B, blocks_cap, up)
    return y.reshape(*batch_shape, plan.out_capacity), new_tail
