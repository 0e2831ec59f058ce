"""Every ``ddc_apply_il`` formulation of the port (plain conv, J-conv,
shifted matmul) and the full-rate stages against the JAX package's, on the
CPU at a small size: outputs < -100 dB, NCO phase and carried tail bit for
bit, chunked equal to whole."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import error_db

from iq_to_audio_tpu.ops import ddc as jddc
from iq_to_audio_torch.ops import ddc as tddc

torch.set_num_threads(1)

FS = 250_000.0
L = 257
FORMS = ["conv1d", "jconv", "mm"]


def _setup(decim, offsets, order="iq", target_chunk=12_288):
    taps = np.kaiser(L, 8.0) * np.sinc((1.0 / decim) * (np.arange(L) - L // 2))
    taps /= taps.sum()
    incs = [int(round(o / FS * 2**32)) % (1 << 32) for o in offsets]
    plan = tddc.DDCPlan.create(L, decim, target_chunk=target_chunk)
    kernel_np = tddc.bandpass_kernel(taps, incs)
    kil = tddc.interleave_kernel(kernel_np, order)
    return plan, incs, kernel_np, kil


def _kernels(form, kil, decim, m):
    j = min(max(1, 128 // kil.shape[0]), m)
    if form == "conv1d":
        return {}, 1
    if form == "jconv":
        return {"j_kernel": tddc.j_lanes_kernel(kil, decim, j)}, j
    return {"mm_kernel": tddc.shift_matmul_kernel(kil, decim, j)}, j


def _both(form, plan, incs, kil, f, itail, phase):
    decim = plan.decimation
    kw, j = _kernels(form, kil, decim, plan.out_size)
    inc_lo = np.asarray([(i * decim) % (1 << 32) for i in incs], np.uint32)
    jplan = jddc.DDCPlan(plan.num_taps, decim, plan.chunk_size)
    want = jddc.ddc_apply_il(
        jplan, jnp.asarray(kil), jnp.asarray(f), jnp.asarray(itail),
        jnp.asarray(phase.astype(np.uint32)), jnp.asarray(inc_lo),
        j_lanes=j, **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    # the port's phase is 62-bit: the uint32 one shifted up 30 bits (ops/nco.py)
    got = tddc.ddc_apply_il(
        plan, None, torch.from_numpy(f), torch.from_numpy(itail),
        torch.from_numpy(phase.astype(np.int64) << 30),
        torch.from_numpy(inc_lo.astype(np.int64) << 30),
        kernel_il=torch.from_numpy(kil), j_lanes=j,
        **{k: torch.from_numpy(v) for k, v in kw.items()},
    )
    return got, want


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize(
    "decim,offsets,order",
    [(3, (25_000.0,), "iq"), (26, (25_000.0, -40_000.0), "qi_inv"), (7, (1_000.0,) * 5, "qi")],
)
def test_formulation_matches_jax(form, decim, offsets, order):
    plan, incs, _, kil = _setup(decim, offsets, order)
    rng = np.random.default_rng(decim)
    f = (rng.standard_normal(2 * plan.chunk_size) * 0.3).astype(np.float32)
    itail = (rng.standard_normal(2 * (L - 1)) * 0.3).astype(np.float32)
    phase = rng.integers(0, 1 << 32, len(incs), dtype=np.uint64)
    got, want = _both(form, plan, incs, kil, f, itail, phase)
    assert got[0].shape == (len(incs), plan.out_size)
    assert error_db(got[0].numpy(), np.asarray(want[0])) < -100.0
    assert error_db(got[1].numpy(), np.asarray(want[1])) < -100.0
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]).astype(np.int64) << 30)


@pytest.mark.parametrize("form", FORMS + ["poly"])
def test_formulations_agree_and_chunked_equals_whole(form):
    """Three chunks with the carried tail equal one chunk of three times the
    length, and every formulation agrees with the plain conv."""
    decim = 3
    plan, incs, _, kil = _setup(decim, (25_000.0, -40_000.0))
    n = plan.chunk_size
    whole = tddc.DDCPlan.create(L, decim, target_chunk=3 * n)
    assert whole.chunk_size == 3 * n
    rng = np.random.default_rng(11)
    f = torch.from_numpy((rng.standard_normal(6 * n) * 0.3).astype(np.float32))
    inc_lo = torch.tensor([(i * decim) % (1 << 32) << 30 for i in incs], dtype=torch.int64)
    phase0 = torch.tensor([123456 << 30, 7], dtype=torch.int64)

    def run(p, x, tail, phase, which):
        from iq_to_audio_torch.ops.poly_fir import build_poly_kernel

        kw, j = _kernels(which, kil, decim, p.out_size)
        poly = torch.from_numpy(build_poly_kernel(kil, 2 * decim)) if which == "poly" else None
        return tddc.ddc_apply_il(
            p, poly, x, tail, phase, inc_lo, kernel_il=torch.from_numpy(kil), j_lanes=j,
            **{k: torch.from_numpy(v) for k, v in kw.items()},
        )

    tail0 = torch.zeros(2 * (L - 1))
    yr_w, yi_w, tail_w, ph_w = run(whole, f, tail0, phase0, form)
    tail, ph, parts = tail0, phase0, []
    for i in range(3):
        yr, yi, tail, ph = run(plan, f[2 * i * n : 2 * (i + 1) * n], tail, ph, form)
        parts.append((yr, yi))
    yr_c = torch.cat([p[0] for p in parts], dim=-1)
    yi_c = torch.cat([p[1] for p in parts], dim=-1)
    assert error_db(yr_c.numpy(), yr_w.numpy()) < -100.0
    assert error_db(yi_c.numpy(), yi_w.numpy()) < -100.0
    assert torch.equal(tail, tail_w) and torch.equal(ph, ph_w)
    ref = run(whole, f, tail0, phase0, "conv1d")
    assert error_db(yr_w.numpy(), ref[0].numpy()) < -100.0
    assert error_db(yi_w.numpy(), ref[1].numpy()) < -100.0


def test_ddc_apply_il_needs_a_kernel():
    plan, incs, _, _ = _setup(3, (25_000.0,))
    z = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="kernel_il"):
        tddc.ddc_apply_il(
            plan, None, torch.zeros(2 * plan.chunk_size), torch.zeros(2 * (L - 1)), z, z
        )


@pytest.mark.parametrize("decim,offsets", [(3, (25_000.0,)), (5, (25_000.0, -40_000.0))])
def test_fullrate_stages_match_jax(decim, offsets):
    plan, incs, kernel_np, _ = _setup(decim, offsets, target_chunk=6_000)
    n = plan.chunk_size
    rng = np.random.default_rng(3)
    xr, xi = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    tail = (rng.standard_normal((2, L - 1)) * 0.3).astype(np.float32)
    phase = rng.integers(0, 1 << 32, len(incs), dtype=np.uint64)
    incs_np = np.asarray(incs, np.uint32)
    want = jddc.ddc_fullrate_stages(
        jddc.DDCPlan(L, decim, n), jnp.asarray(kernel_np), jnp.asarray(xr), jnp.asarray(xi),
        jnp.asarray(tail), jnp.asarray(phase.astype(np.uint32)), jnp.asarray(incs_np),
    )
    got = tddc.ddc_fullrate_stages(
        plan, torch.from_numpy(kernel_np), torch.from_numpy(xr), torch.from_numpy(xi),
        torch.from_numpy(tail), torch.from_numpy(phase.astype(np.int64) << 30),
        torch.from_numpy(incs_np.astype(np.int64) << 30),
    )
    for g, w, name in zip(got, want, ("mixed_r", "mixed_i", "filtered_r", "filtered_i")):
        assert g.shape == (len(incs), n), name
        assert error_db(g.numpy(), np.asarray(w)) < -100.0, name
    # the decimated hot path is every D-th filtered sample
    kil = tddc.interleave_kernel(kernel_np, "iq")
    f = np.empty(2 * n, np.float32)
    f[0::2], f[1::2] = xr, xi
    itail = np.empty(2 * (L - 1), np.float32)
    itail[0::2], itail[1::2] = tail
    inc_lo = torch.tensor([(i * decim) % (1 << 32) << 30 for i in incs], dtype=torch.int64)
    yr, yi, _, _ = tddc.ddc_apply_il(
        plan, None, torch.from_numpy(f), torch.from_numpy(itail),
        torch.from_numpy(phase.astype(np.int64) << 30), inc_lo, kernel_il=torch.from_numpy(kil),
    )
    assert error_db(got[2][:, ::decim].numpy(), yr.numpy()) < -100.0
    assert error_db(got[3][:, ::decim].numpy(), yi.numpy()) < -100.0
