"""Sequence-parallel pipeline step over a mesh of ranks (port of the JAX
package's ``parallel/sharded.py``).

Each rank runs :func:`build_sharded_step`'s ``local_step`` on its slice of
the chunk: ``seq`` ranks split the chunk into equal decimation-aligned
slices, ``dp`` ranks split the channels (or, with several captures, the
captures).  Within a chunk,

* the decimated-rate NCO needs **no communication**: each shard derives its
  starting phase from the carried phase plus ``inc_lo * offset`` (exact
  modular arithmetic on the 62-bit phase of :mod:`iq_to_audio_torch.ops.nco`);
* the decimating bandpass FIR needs a ``2(L-1)``-float **halo** of raw
  interleaved input from the left neighbour, and the discriminator a
  1-sample one.  The JAX package moves them with ``lax.ppermute``; here one
  ``all_gather`` of every shard's tail over the ``seq`` group gives each
  shard its left neighbour's tail and every shard the last shard's, which
  is the carried state of the next chunk (the JAX package all-gathers that
  too);
* the de-emphasis, DC-blocker and AGC recurrences run as **distributed
  scans**: a local scan from zero, an all-gather of each shard's
  ``(a_tot, b_tot)`` summary, a replicated prefix fold, then a local
  correction;
* the 48 kHz resampler runs replicated on the all-gathered channel-rate
  audio: at 1/decimation of the input rate it is too small to shard.

Each shard's channelizer is :func:`~iq_to_audio_torch.ops.ddc.ddc_apply_il`
with the polyphase taps of its ``dp`` row's channels: on the card the hand
kernel ``poly_fir_il``, on the CPU its plain version.  The collectives are
the list form of ``dist.all_gather`` (one tensor per rank), which gloo and
NCCL both take.
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from ..demod.nfm import polar_discriminant
from ..demod.ssb import AGC_DECAY, AGC_TARGET_DBFS, DC_RADIUS
from ..ops.ddc import DDCPlan, ddc_apply_il, nco_advance
from ..ops.iir import agc_coefficients, first_order_prefix, first_order_scan_const
from ..ops.nco import device_increment
from ..ops.poly_fir import build_poly_kernel
from ..ops.resample import ResamplePlan, polyphase_resample
from ..pipeline.step import _device_scale


class _Axis:
    """One mesh dimension as a rank sees it: its group, its index on the
    axis and the axis's size."""

    def __init__(self, mesh, name: str):
        self.group = mesh.get_group(name)
        self.index = mesh.get_local_rank(name)
        self.size = mesh.shape[mesh.mesh_dim_names.index(name)]

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return parts


def _left_halo(x: torch.Tensor, width: int, fallback: torch.Tensor, seq: _Axis):
    """Every shard receives the last ``width`` samples of its left
    neighbour, shard 0 ``fallback`` (the carried cross-chunk state).
    Returns ``(halo, last)``: ``last`` is the last shard's tail, the carried
    state of the next chunk."""
    if width == 0:
        return fallback, fallback
    tails = seq.all_gather(x[..., x.shape[-1] - width :])
    halo = fallback if seq.index == 0 else tails[seq.index - 1]
    return halo, tails[-1]


def _prefix_fold(a_tot, b_tot, y0, seq: _Axis):
    """Replicated O(n_shards) stitch of a distributed first-order scan:
    fold the per-shard ``(a_tot, b_tot)`` summaries into each shard's
    incoming state ``y_in`` and the global last value."""
    carry = y0
    after = []
    for ab in seq.all_gather(torch.stack([a_tot, b_tot])):
        carry = ab[0] * carry + ab[1]
        after.append(carry)
    y_in = y0 if seq.index == 0 else after[seq.index - 1]
    return y_in, after[-1]


def distributed_first_order_scan(a, b, y0, seq: _Axis):
    """``y[n] = a[n]*y[n-1] + b[n]`` across the shards of the last axis.

    ``y0`` is the global initial state (replicated).  Returns
    ``(y_local, y_global_last)`` with ``y_global_last`` replicated.  The
    local part is :func:`~iq_to_audio_torch.ops.iir.first_order_prefix`,
    the scan the serial AGC runs.
    """
    cum_a, cum_b = first_order_prefix(a, b)
    y_in, y_last = _prefix_fold(cum_a[..., -1], cum_b[..., -1], y0, seq)
    return cum_a * y_in[..., None] + cum_b, y_last


def distributed_first_order_scan_const(alpha: float, b, y0, seq: _Axis):
    """Constant-coefficient distributed scan: the local segment runs
    :func:`~iq_to_audio_torch.ops.iir.first_order_scan_const` from zero,
    and ``cum_a`` has the closed form ``alpha**(k+1)``, so no coefficient
    array is materialised."""
    n_loc = b.shape[-1]
    alpha_t = b.new_full((), alpha)
    y_local, b_tot = first_order_scan_const(alpha, b, torch.zeros_like(b[..., 0]))
    ramp = alpha_t ** torch.arange(1, n_loc + 1, dtype=b.dtype, device=b.device)
    a_tot = (alpha_t**n_loc).expand(b_tot.shape)
    y_in, y_last = _prefix_fold(a_tot, b_tot, y0, seq)
    return y_local + ramp * y_in[..., None], y_last


def _dist_deemph(x, alpha: float, y0, seq: _Axis):
    beta = float(np.float32(1.0) - np.float32(alpha))
    return distributed_first_order_scan_const(alpha, x * beta, y0, seq)


def _dist_dc_blocker(x, radius: float, x_prev, y_prev, seq: _Axis):
    prev, last = _left_halo(x, 1, x_prev[..., None], seq)
    u = x - torch.cat([prev[..., -1:], x[..., :-1]], dim=-1)
    y, y_last = distributed_first_order_scan_const(radius, u, y_prev, seq)
    return y, (last[..., -1], y_last)


def _dist_agc(x, target: float, decay: float, gain0, seq: _Axis, eps=1e-6):
    # the coefficients of the serial feedback_agc (ops/iir.py)
    a, b = agc_coefficients(x, target, decay, eps)
    g, g_last = distributed_first_order_scan(a, b, gain0, seq)
    return x * g, g_last


def check_geometry(dp: int, seq: int, num_channels: int, ddc_plan: DDCPlan, captures: int) -> None:
    """The JAX package's checks of a sharded geometry, raised as
    ``ValueError`` before any rank starts."""
    C, N, D = num_channels, ddc_plan.chunk_size, ddc_plan.decimation
    if captures > 1 and captures != dp:
        raise ValueError(f"multi-capture DP needs captures ({captures}) == dp ({dp})")
    if C % dp != 0:
        raise ValueError(f"channels {C} must divide over dp={dp}")
    if N % seq != 0 or (N // seq) % D != 0:
        raise ValueError(f"chunk {N} must split into decimation-aligned seq={seq} shards")
    if ddc_plan.num_taps - 1 > N // seq:
        raise ValueError("shard length must cover the filter halo (L-1).")


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_operands(
    mesh, incs_fixed: list[int], kernel_il: np.ndarray, decimation: int,
    nco_res: list[int] | None = None,
):
    """This rank's share of the channel operands: the NCO's 62-bit
    increments per output sample of its ``dp`` row's channels, as int64
    (:func:`~iq_to_audio_torch.ops.nco.device_increment` of the uint32
    ``incs_fixed`` and their residuals ``nco_res``, zero when not given),
    and the polyphase taps
    ``build_poly_kernel(kernel_il, 2D)`` cut along the output axis to the
    row's ``2C/dp`` outputs (channel ``c`` owns outputs ``2c, 2c+1``)."""
    dp = _Axis(mesh, "dp")
    c_local = len(incs_fixed) // dp.size
    lo = dp.index * c_local
    device = mesh_device(mesh)
    poly = build_poly_kernel(kernel_il, 2 * decimation)[:, :, 2 * lo : 2 * (lo + c_local)]
    inc_lo = [
        device_increment(incs_fixed[c], nco_res[c] if nco_res else 0, decimation)
        for c in range(lo, lo + c_local)
    ]
    return (
        torch.tensor(inc_lo, dtype=torch.int64, device=device),
        torch.from_numpy(np.ascontiguousarray(poly)).to(device),
    )


def gather_rows(mesh, audio_local: torch.Tensor) -> torch.Tensor:
    """The ``dp`` rows' channel blocks, stacked to ``(C, cap)`` on every
    rank of this rank's ``dp`` group."""
    return torch.cat(_Axis(mesh, "dp").all_gather(audio_local), dim=0)


def build_sharded_step(
    mesh,
    *,
    ddc_plan: DDCPlan,
    rs_plan: ResamplePlan | None,
    num_channels: int,
    codec: str = "pcm_f32le",
    iq_order: str = "iq",
    mode: str = "nfm",
    deemph_alpha: float = 0.9659,
    agc_enabled: bool = True,
    # defaults imported from the serial SSB decoder so the two paths
    # share one source of truth (demod/ssb.py)
    dc_radius: float = DC_RADIUS,
    agc_target: float = 10.0 ** (AGC_TARGET_DBFS / 20.0),
    agc_decay: float = AGC_DECAY,
    captures: int = 1,
):
    """Build this rank's share of the full pipeline step over ``mesh``.

    Returns ``(fn, init_state)`` where ``fn(state, raw, rs_offset, inc_lo,
    poly_w, rs_kernel) -> (state, audio)`` runs ``local_step`` on this
    rank's operands:

    * ``raw``: its ``seq`` slice (``2N/seq`` raw interleaved samples) of the
      chunk, of its ``dp`` row's capture when ``captures > 1``;
    * ``inc_lo`` and ``poly_w``: its ``dp`` row's channels, from
      :func:`local_operands` (the polyphase repack of the INTERLEAVED-domain
      kernel ``interleave_kernel(bandpass_kernel(...), iq_order)``: the
      ``iq_order`` argument here only documents the convention the caller
      folded into those taps; ``codec`` alone drives the scaling);
    * ``rs_kernel``: the resampler's kernel, replicated (``None`` with an
      identity or absent ``rs_plan``).

    ``audio`` is the row's ``(C/dp, cap)`` float audio, the same on every
    ``seq`` rank; :func:`gather_rows` stacks the rows.  ``state`` holds the
    JAX package's flat keys, for this rank's channels; the FIR tail is the
    raw-domain ``(2(L-1),)`` tail of the rank's capture
    (:mod:`iq_to_audio_torch.convert` maps it to and from the JAX layout).

    ``captures > 1`` runs **data-parallel multi-capture** mode: each ``dp``
    row processes its own recording, the ``num_channels`` total packs
    capture-major so channel block ``g`` rides dp row ``g``, and
    ``captures == dp``.
    """
    dp, seq = mesh.shape
    check_geometry(dp, seq, num_channels, ddc_plan, captures)
    C, N, D = num_channels, ddc_plan.chunk_size, ddc_plan.decimation
    local_plan = replace(ddc_plan, chunk_size=N // seq)
    L = ddc_plan.num_taps
    m_local = local_plan.out_size
    mode = mode.lower()
    if mode not in {"nfm", "fm", "am", "usb", "lsb", "ssb"}:
        raise ValueError(f"Unsupported demod mode '{mode}'")
    seq_axis = _Axis(mesh, "seq")
    c_local = C // dp
    device = mesh_device(mesh)
    resample = rs_plan is not None and not rs_plan.identity

    def local_step(state, raw, rs_offset, inc_lo, poly_w, rs_kernel):
        # the halo and the carried tail stay in the RAW interleaved domain
        # (ops/ddc.py::ddc_apply_il)
        f = _device_scale(raw, codec)
        # the shard's first output sits seq_index * m_local low-rate steps in
        phase0 = nco_advance(state["phase"], inc_lo, seq_axis.index * m_local)
        halo, fir_tail_next = _left_halo(f, 2 * (L - 1), state["fir_tail"], seq_axis)
        yr, yi, _, _ = ddc_apply_il(local_plan, poly_w, f, halo, phase0, inc_lo)
        new_state = {
            "phase": nco_advance(state["phase"], inc_lo, N // D),
            "fir_tail": fir_tail_next,
        }

        if mode in {"nfm", "fm"}:
            prev, last = _left_halo(
                torch.stack([yr, yi]), 1,
                torch.stack([state["demod_prev_r"], state["demod_prev_i"]])[..., None],
                seq_axis,
            )
            sr = torch.cat([prev[0][..., -1:], yr[..., :-1]], dim=-1)
            si = torch.cat([prev[1][..., -1:], yi[..., :-1]], dim=-1)
            demod = polar_discriminant(yr, yi, sr, si)
            audio_ch, y_last = _dist_deemph(demod, deemph_alpha, state["deemph_y"], seq_axis)
            new_state["demod_prev_r"] = last[0][..., -1]
            new_state["demod_prev_i"] = last[1][..., -1]
            new_state["deemph_y"] = y_last
        elif mode == "am":
            env = torch.sqrt(yr * yr + yi * yi)
            audio_ch, (x_last, y_last) = _dist_dc_blocker(
                env, dc_radius, state["dc_x"], state["dc_y"], seq_axis
            )
            new_state["dc_x"] = x_last
            new_state["dc_y"] = y_last
        else:  # usb, lsb, ssb: both sidebands take the real part
            audio_ch, (x_last, y_last) = _dist_dc_blocker(
                yr, dc_radius, state["dc_x"], state["dc_y"], seq_axis
            )
            new_state["dc_x"] = x_last
            new_state["dc_y"] = y_last
            if agc_enabled:
                audio_ch, g_last = _dist_agc(
                    audio_ch, agc_target, agc_decay, state["agc_gain"], seq_axis
                )
                new_state["agc_gain"] = g_last

        # audio-rate tail: gather the channel-rate audio and resample
        # replicated (1/decimation of the input rate: not worth sharding)
        full_audio = torch.cat(seq_axis.all_gather(audio_ch), dim=-1)
        if resample:
            audio48, new_state["rs_tail"] = polyphase_resample(
                rs_plan, rs_kernel, full_audio, state["rs_tail"], rs_offset
            )
        else:
            audio48 = full_audio
        return new_state, audio48

    def init_state() -> dict:
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        state = {
            "phase": torch.zeros(c_local, dtype=torch.int64, device=device),
            "fir_tail": zeros(2 * (L - 1)),
        }
        if mode in {"nfm", "fm"}:
            state["demod_prev_r"] = torch.ones(c_local, dtype=torch.float32, device=device)
            state["demod_prev_i"] = zeros(c_local)
            state["deemph_y"] = zeros(c_local)
        else:
            state["dc_x"] = zeros(c_local)
            state["dc_y"] = zeros(c_local)
            if mode in {"usb", "lsb", "ssb"} and agc_enabled:
                state["agc_gain"] = torch.ones(c_local, dtype=torch.float32, device=device)
        if resample:
            state["rs_tail"] = zeros(c_local, rs_plan.tail_len)
        return state

    return local_step, init_state


def plan_for_mesh(
    *,
    num_taps: int,
    decimation: int,
    seq: int,
    target_chunk: int = 1 << 20,
) -> DDCPlan:
    """A DDCPlan whose chunk splits into decimation-aligned seq shards."""
    unit = decimation * seq
    n = max(unit, int(math.ceil(target_chunk / unit)) * unit)
    # each shard must cover the filter halo
    while (n // seq) < num_taps - 1:
        n += unit
    return DDCPlan(num_taps=num_taps, decimation=decimation, chunk_size=n)
