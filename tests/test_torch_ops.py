"""Per-op parity of the torch port against the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through both packages.  Host
plans and tap arrays must be bit-identical; device ops agree within -100 dB
(float32 rounding order differs between XLA and torch); the NCO phase is
exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import error_db

from iq_to_audio_tpu.ops import ddc as jddc
from iq_to_audio_tpu.ops import iir as jiir
from iq_to_audio_tpu.ops import nco as jnco
from iq_to_audio_tpu.ops import pallas_ddc as jpallas
from iq_to_audio_tpu.ops import resample as jres
from iq_to_audio_tpu.ops.trig import atan2_fast as j_atan2
from iq_to_audio_tpu.pipeline import filters as jfilters
from iq_to_audio_tpu.pipeline import step as jstep

from iq_to_audio_torch.ops import ddc as tddc
from iq_to_audio_torch.ops import iir as tiir
from iq_to_audio_torch.ops import nco as tnco
from iq_to_audio_torch.ops import poly_fir as tpoly
from iq_to_audio_torch.ops import resample as tres
from iq_to_audio_torch.ops.trig import atan2_fast as t_atan2
from iq_to_audio_torch.pipeline import filters as tfilters
from iq_to_audio_torch.pipeline import step as tstep

torch.set_num_threads(1)

GEOMETRIES = [
    # (sample rate, bandwidth, offsets)
    (250_000.0, 12_500.0, (25_000.0,)),
    (2_500_000.0, 12_500.0, (100_000.0,)),
    (2_500_000.0, 2_000.0, (-310_000.0, 55_000.0)),
    (1_000_000.0, 25_000.0, (0.0,)),
]


@pytest.mark.parametrize("fs,bw,offsets", GEOMETRIES)
def test_host_plans_bit_identical(fs, bw, offsets):
    decim_j = jfilters.compute_decimation(fs, 96_000.0)
    decim_t = tfilters.compute_decimation(fs, 96_000.0)
    assert decim_j == decim_t
    d, fs_ch = decim_t
    taps_j = jfilters.design_channel_filter(fs, bw, d)
    taps_t = tfilters.design_channel_filter(fs, bw, d)
    np.testing.assert_array_equal(taps_j, taps_t)
    assert jfilters.tune_chunk_size(fs, 1 << 20) == tfilters.tune_chunk_size(fs, 1 << 20)

    for sign in (1, -1):
        incs_j = [jnco.nco_increment_fixed(o, fs, sign=sign) for o in offsets]
        incs_t = [tnco.nco_increment_fixed(o, fs, sign=sign) for o in offsets]
        assert incs_j == incs_t
    assert jnco.nco_phase_advance(123, incs_t[0], 10**7) == tnco.nco_phase_advance(
        123, incs_t[0], 10**7
    )

    rp_j = jres.ResamplePlan.create(fs_ch, 48_000.0, 1)
    rp_t = tres.ResamplePlan.create(fs_ch, 48_000.0, 1)
    assert (rp_j.up, rp_j.down) == (rp_t.up, rp_t.down)
    align = 1 if rp_t.identity else rp_t.down
    plan_j = jddc.DDCPlan.create(len(taps_t), d, target_chunk=1 << 20, out_align=align)
    plan_t = tddc.DDCPlan.create(len(taps_t), d, target_chunk=1 << 20, out_align=align)
    assert (plan_j.num_taps, plan_j.decimation, plan_j.chunk_size) == (
        plan_t.num_taps, plan_t.decimation, plan_t.chunk_size
    )
    rj = jres.ResamplePlan.create(fs_ch, 48_000.0, plan_t.out_size)
    rt = tres.ResamplePlan.create(fs_ch, 48_000.0, plan_t.out_size)
    assert (rj.up, rj.down, rj.in_size, rj.out_capacity, rj.aligned_len) == (
        rt.up, rt.down, rt.in_size, rt.out_capacity, rt.aligned_len
    )
    if not rt.identity:
        np.testing.assert_array_equal(
            jres.design_resampler_kernel(rt.up, rt.down),
            tres.design_resampler_kernel(rt.up, rt.down),
        )
        np.testing.assert_array_equal(
            jres.design_resampler_prototype(rt.up, rt.down),
            tres.design_resampler_prototype(rt.up, rt.down),
        )

    bp_j = jddc.bandpass_kernel(taps_t, incs_t)
    bp_t = tddc.bandpass_kernel(taps_t, incs_t)
    np.testing.assert_array_equal(bp_j, bp_t)
    for order in ("iq", "qi", "iq_inv", "qi_inv"):
        il_j = jddc.interleave_kernel(bp_j, order)
        il_t = tddc.interleave_kernel(bp_t, order)
        np.testing.assert_array_equal(il_j, il_t)
    np.testing.assert_array_equal(
        jpallas.build_poly_kernel(il_j, 2 * d), tpoly.build_poly_kernel(il_t, 2 * d)
    )


@pytest.mark.parametrize(
    "codec,dtype",
    [("pcm_u8", np.uint8), ("pcm_s16le", np.int16), ("pcm_f32le", np.float32)],
)
def test_device_scale_exact(codec, dtype):
    rng = np.random.default_rng(5)
    if dtype is np.float32:
        raw = rng.uniform(-1, 1, 4096).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        raw = rng.integers(info.min, info.max, 4096, endpoint=True).astype(dtype)
    want = np.asarray(jstep._device_scale(jnp.asarray(raw), codec))
    got = tstep._device_scale(torch.from_numpy(raw), codec).numpy()
    np.testing.assert_array_equal(got, want)


def test_atan2_fast_matches_jax():
    rng = np.random.default_rng(21)
    y = (rng.standard_normal(100_001) * 3).astype(np.float32)
    x = (rng.standard_normal(100_001) * 3).astype(np.float32)
    inf = np.float32(np.inf)
    edges = [
        (0.0, 0.0), (0.0, 1.0), (0.0, -1.0), (1.0, 0.0), (-1.0, 0.0),
        (1.0, 1.0), (-1.0, -1.0), (inf, inf), (-inf, inf), (inf, -inf),
        (-inf, -inf), (inf, 1.0), (1.0, inf), (2.5, -2.5), (-3.0, 3.0),
    ]
    y = np.concatenate([y, np.asarray([e[0] for e in edges], np.float32)])
    x = np.concatenate([x, np.asarray([e[1] for e in edges], np.float32)])
    got = t_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert np.all(np.isfinite(got))
    # op by op, JAX evaluates the same float32 operations in the same order
    want = np.asarray(j_atan2(jnp.asarray(y), jnp.asarray(x)))
    assert np.abs(got.astype(np.float64) - want).max() <= 2e-7
    # under jit XLA fuses the polynomial and may round the last step once
    # differently: at most one float32 ulp of pi
    want_jit = np.asarray(jax.jit(j_atan2)(jnp.asarray(y), jnp.asarray(x)))
    assert np.abs(got.astype(np.float64) - want_jit).max() <= float(np.spacing(np.float32(np.pi)))


@pytest.mark.parametrize("alpha", [0.9659, 0.99, 0.5])
@pytest.mark.parametrize("shape", [(1, 9_000), (2, 5_003)])
def test_first_order_scan_const_and_deemphasis(alpha, shape):
    rng = np.random.default_rng(8)
    b = rng.standard_normal(shape).astype(np.float32)
    y0 = rng.standard_normal(shape[:-1]).astype(np.float32)
    yj, lj = jiir.first_order_scan_const(alpha, jnp.asarray(b), jnp.asarray(y0))
    yt, lt = tiir.first_order_scan_const(alpha, torch.from_numpy(b), torch.from_numpy(y0))
    assert error_db(yt.numpy(), np.asarray(yj)) < -100.0
    assert error_db(lt.numpy(), np.asarray(lj)) < -100.0
    dj, dlj = jiir.deemphasis(jnp.asarray(b), alpha, jnp.asarray(y0))
    dt, dlt = tiir.deemphasis(torch.from_numpy(b), alpha, torch.from_numpy(y0))
    assert error_db(dt.numpy(), np.asarray(dj)) < -100.0
    assert error_db(dlt.numpy(), np.asarray(dlj)) < -100.0


@pytest.mark.parametrize("channels", [1, 2])
def test_polyphase_resample_matches_jax(channels):
    fs_ch = 2_500_000.0 / 26
    n_in = 625 * 4
    plan = tres.ResamplePlan.create(fs_ch, 48_000.0, n_in)
    jplan = jres.ResamplePlan.create(fs_ch, 48_000.0, n_in)
    kernel = tres.design_resampler_kernel(plan.up, plan.down)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((channels, n_in)).astype(np.float32)
    tail = rng.standard_normal((channels, plan.tail_len)).astype(np.float32)
    for total_before in (0, 1, 624, 625 * 7 + 311):
        off = plan.chunk_offset(total_before)
        yj, tj = jres.polyphase_resample(
            jplan, jnp.asarray(kernel), jnp.asarray(x), jnp.asarray(tail), jnp.int32(off)
        )
        yt, tt = tres.polyphase_resample(
            plan, torch.from_numpy(kernel), torch.from_numpy(x), torch.from_numpy(tail), off
        )
        assert yt.shape == yj.shape
        assert error_db(yt.numpy(), np.asarray(yj)) < -100.0, off
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_mix_and_advance_phase_exact():
    rng = np.random.default_rng(17)
    m = 6_250
    incs = np.asarray([3_000_000_001, 12_345, 4_294_967_295], np.uint64)
    inc_lo = ((incs * np.uint64(26)) % np.uint64(1 << 32)).astype(np.uint32)
    phase_j = jnp.asarray(np.asarray([0, 4_000_000_000, 17], np.uint32))
    # the port's phase is 62-bit: the uint32 one shifted up 30 bits (ops/nco.py)
    phase_t = torch.from_numpy(np.asarray(phase_j).astype(np.int64) << 30)
    inc_t = torch.from_numpy(inc_lo.astype(np.int64) << 30)
    for _ in range(5):
        br = rng.standard_normal((3, m)).astype(np.float32)
        bi = rng.standard_normal((3, m)).astype(np.float32)
        yrj, yij, phase_j = jddc.mix_and_advance(
            jnp.asarray(br), jnp.asarray(bi), phase_j, jnp.asarray(inc_lo), m
        )
        yrt, yit, phase_t = tddc.mix_and_advance(
            torch.from_numpy(br), torch.from_numpy(bi), phase_t, inc_t, m
        )
        np.testing.assert_array_equal(phase_t.numpy(), np.asarray(phase_j).astype(np.int64) << 30)
        assert error_db(yrt.numpy(), np.asarray(yrj)) < -100.0
        assert error_db(yit.numpy(), np.asarray(yij)) < -100.0


def _pair_inputs(decim, offsets, n_chunks, seed):
    """A pair-input DDC geometry at 250 kHz and ``n_chunks`` chunks of a
    seeded (re, im) pair."""
    fs = 250_000.0
    taps = tfilters.design_channel_filter(fs, 12_500.0, decim)
    plan = tddc.DDCPlan.create(len(taps), decim, target_chunk=decim * 1_500)
    incs = [tnco.nco_increment_fixed(o, fs) for o in offsets]
    kernel = tddc.bandpass_kernel(taps, incs)
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.3, size=(2, n_chunks * plan.chunk_size)).astype(np.float32)
    tail = rng.normal(scale=0.3, size=(2, plan.overlap)).astype(np.float32)
    inc_lo = np.asarray([(i * decim) % (1 << 32) for i in incs], np.uint32)
    phase = np.asarray([(i * 977) % (1 << 32) for i in incs], np.uint32)
    return plan, kernel, x, tail, phase, inc_lo


@pytest.mark.parametrize("decim", [4, 26])
@pytest.mark.parametrize("offsets", [(25_000.0,), (25_000.0, -40_000.0)])
@pytest.mark.parametrize("poly", [False, True])
def test_ddc_apply_matches_jax_conv(decim, offsets, poly):
    """The pair-input channelizer entry point, through conv1d or through
    the polyphase FIR, against the JAX package's conv branch: baseband
    within -100 dB, carried tail exact, phase exact."""
    plan, kernel, x, tail, phase, inc_lo = _pair_inputs(decim, offsets, 1, seed=decim)
    yrj, yij, tailj, phj = jddc.ddc_apply(
        plan, jnp.asarray(kernel), jnp.asarray(x[0]), jnp.asarray(x[1]),
        jnp.asarray(tail), jnp.asarray(phase), jnp.asarray(inc_lo),
    )
    poly_w = torch.from_numpy(tpoly.build_poly_kernel(kernel, decim)) if poly else None
    yrt, yit, tailt, pht = tddc.ddc_apply(
        plan, torch.from_numpy(kernel), torch.from_numpy(x[0]), torch.from_numpy(x[1]),
        torch.from_numpy(tail), torch.from_numpy(phase.astype(np.int64) << 30),
        torch.from_numpy(inc_lo.astype(np.int64) << 30), poly_w=poly_w,
    )
    assert yrt.shape == (len(offsets), plan.out_size)
    assert error_db(yrt.numpy(), np.asarray(yrj)) < -100.0
    assert error_db(yit.numpy(), np.asarray(yij)) < -100.0
    np.testing.assert_array_equal(tailt.numpy(), np.asarray(tailj))
    np.testing.assert_array_equal(pht.numpy(), np.asarray(phj).astype(np.int64) << 30)


@pytest.mark.parametrize("poly", [False, True])
def test_ddc_apply_chunked_equals_whole(poly):
    """Three chunks carrying the tail and phase equal one call over the
    three chunks (-100 dB)."""
    decim = 26
    plan, kernel, x, tail, phase, inc_lo = _pair_inputs(decim, (25_000.0, -40_000.0), 3, 5)
    k = torch.from_numpy(kernel)
    poly_w = torch.from_numpy(tpoly.build_poly_kernel(kernel, decim)) if poly else None
    inc_t = torch.from_numpy(inc_lo.astype(np.int64))
    tail_t, ph_t = torch.from_numpy(tail), torch.from_numpy(phase.astype(np.int64))
    parts_r, parts_i = [], []
    n = plan.chunk_size
    for c in range(3):
        xr, xi = (torch.from_numpy(x[i, c * n : (c + 1) * n]) for i in range(2))
        yr, yi, tail_t, ph_t = tddc.ddc_apply(plan, k, xr, xi, tail_t, ph_t, inc_t, poly_w=poly_w)
        parts_r.append(yr)
        parts_i.append(yi)
    whole_plan = tddc.DDCPlan(plan.num_taps, decim, 3 * n)
    wr, wi, wtail, wph = tddc.ddc_apply(
        whole_plan, k, torch.from_numpy(x[0]), torch.from_numpy(x[1]), torch.from_numpy(tail),
        torch.from_numpy(phase.astype(np.int64)), inc_t, poly_w=poly_w,
    )
    assert error_db(torch.cat(parts_r, -1).numpy(), wr.numpy()) < -100.0
    assert error_db(torch.cat(parts_i, -1).numpy(), wi.numpy()) < -100.0
    assert torch.equal(tail_t, wtail) and torch.equal(ph_t, wph)


@pytest.mark.parametrize(
    "out_ch,in_ch,taps,decim",
    [(10, 2, 7_143, 52), (2, 2, 1_601, 52), (10, 2, 7_150, 260), (6, 1, 27, 26), (4, 2, 1, 3)],
)
def test_build_poly_kernel_bit_identical_to_jax(out_ch, in_ch, taps, decim):
    """The repack is pure data movement: every tap lands where the JAX
    package's per-tap loop puts it, at the SSB channelizer's K = 275 too."""
    rng = np.random.default_rng(taps)
    conv = rng.normal(size=(out_ch, in_ch, taps))
    w = tpoly.build_poly_kernel(conv, decim)
    assert w.dtype == np.float32 and w.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(w, jpallas.build_poly_kernel(conv, decim))
