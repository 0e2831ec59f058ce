"""The port's overlap-save FFT channelizer (``ops/osfir.py`` and the fft
entry points of ``ops/ddc.py``) against the JAX package's, on the CPU:
plans field for field, tap spectra and banks bit for bit, filtered output
< -100 dB against the JAX functions and < -60 dB against the conv branch,
chunked equal to whole."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from conftest import error_db

from iq_to_audio_tpu.ops import ddc as jddc
from iq_to_audio_tpu.ops import osfir as josfir
from iq_to_audio_torch.ops import ddc as tddc
from iq_to_audio_torch.ops import osfir as tosfir

torch.set_num_threads(1)

FS = 250_000.0


def _fields(plan):
    return dataclasses.asdict(plan)


def _taps(L, decim):
    taps = np.kaiser(L, 8.0) * np.sinc((1.0 / decim) * (np.arange(L) - L // 2))
    return taps / taps.sum()


@settings(max_examples=60, deadline=None, derandomize=True)
@given(
    L=st.integers(2, 2000),
    D=st.integers(1, 64),
    chunk=st.integers(1, 1 << 20),
    fft_size=st.one_of(st.none(), st.integers(64, 1 << 17)),
)
def test_plan_create_equals_jax(L, D, chunk, fft_size):
    """The JAX package's planner on its CPU backend offers the CPU-tuned
    families: the port's with ``cpu_tuned=True`` must agree field for field."""
    want = josfir.OverlapSavePlan.create(L, D, target_chunk=chunk, fft_size=fft_size)
    got = tosfir.OverlapSavePlan.create(
        L, D, target_chunk=chunk, fft_size=fft_size, cpu_tuned=True
    )
    assert _fields(got) == _fields(want)
    assert (got.h_shift, got.h_scale, got.out_size) == (want.h_shift, want.h_scale, want.out_size)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(L=st.integers(2, 1700), D=st.integers(1, 40), units=st.integers(1, 3000))
def test_plan_for_chunk_equals_jax(L, D, units):
    N = max(units * D, -(-(L - 1) // D) * D)
    want = josfir.OverlapSavePlan.for_chunk(L, D, N)
    got = tosfir.OverlapSavePlan.for_chunk(L, D, N, cpu_tuned=True)
    assert _fields(got) == _fields(want)
    plain = tosfir.OverlapSavePlan.for_chunk(L, D, N)
    # without the CPU families: contiguous power-of-two framing only
    assert not plain.poly and plain.fft_size & (plain.fft_size - 1) == 0
    assert plain.num_frames * plain.block >= N and plain.chunk_size == N


def test_plan_for_chunk_rejects_bad_chunks():
    for fn in (josfir.OverlapSavePlan.for_chunk, tosfir.OverlapSavePlan.for_chunk):
        with pytest.raises(ValueError, match="multiple of decimation"):
            fn(257, 3, 1000)
        with pytest.raises(ValueError, match="carried tail"):
            fn(257, 3, 99)


PLANS = [
    # (L, D, chunk, cpu_tuned): power-of-two fold, polyphase forward, mixed radix, no fold
    (257, 4, 12_288, False),
    (257, 3, 12_288, True),
    (257, 26, 26 * 500, True),
    (257, 3, 12_288, False),
    (1601, 26, 26 * 2500, True),
]


@pytest.mark.parametrize("L,D,chunk,cpu_tuned", PLANS)
def test_taps_fft_and_bank_bit_identical(L, D, chunk, cpu_tuned):
    tplan = tosfir.OverlapSavePlan.for_chunk(L, D, chunk, cpu_tuned=cpu_tuned)
    jplan = josfir.OverlapSavePlan(**_fields(tplan))
    taps = _taps(L, D)
    np.testing.assert_array_equal(tosfir.taps_fft(taps, tplan), josfir.taps_fft(taps, jplan))
    np.testing.assert_array_equal(
        tosfir.taps_fft(taps, tplan.fft_size), josfir.taps_fft(taps, jplan.fft_size)
    )
    incs = [int(round(o / FS * 2**32)) % (1 << 32) for o in (25_000.0, -40_000.0)]
    kernel_np = tddc.bandpass_kernel(taps, incs)
    got = tddc.bank_from_kernel(kernel_np, tplan)
    want = jddc.bank_from_kernel(kernel_np, jplan)
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("L,D,chunk,cpu_tuned", PLANS)
def test_os_fir_decimate_and_bank_match_jax(L, D, chunk, cpu_tuned):
    tplan = tosfir.OverlapSavePlan.for_chunk(L, D, chunk, cpu_tuned=cpu_tuned)
    jplan = josfir.OverlapSavePlan(**_fields(tplan))
    taps = _taps(L, D)
    rng = np.random.default_rng(L + D)
    x = ((rng.standard_normal((2, chunk)) + 1j * rng.standard_normal((2, chunk))) * 0.3).astype(
        np.complex64
    )
    tail = ((rng.standard_normal((2, L - 1)) + 1j * rng.standard_normal((2, L - 1))) * 0.3).astype(
        np.complex64
    )
    h = tosfir.taps_fft(taps, tplan)
    want, want_tail = josfir.os_fir_decimate(jplan, jnp.asarray(h), jnp.asarray(x), jnp.asarray(tail))
    got, got_tail = tosfir.os_fir_decimate(
        tplan, torch.from_numpy(h), torch.from_numpy(x), torch.from_numpy(tail)
    )
    assert got.shape == (2, chunk // D) and got.dtype == torch.complex64
    assert error_db(got.numpy(), np.asarray(want)) < -100.0
    np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))
    # against direct convolution in float64
    full = np.convolve(np.concatenate([tail[0], x[0]]).astype(np.complex128), taps)
    direct = full[L - 1 : L - 1 + chunk : D]
    assert error_db(got[0].numpy(), direct) < -100.0

    incs = [int(round(o / FS * 2**32)) % (1 << 32) for o in (25_000.0, -40_000.0, 3_000.0)]
    bank = tddc.bank_from_kernel(tddc.bandpass_kernel(taps, incs), tplan)
    wantb, _ = josfir.os_fir_bank(jplan, jnp.asarray(bank), jnp.asarray(x[0]), jnp.asarray(tail[0]))
    gotb, _ = tosfir.os_fir_bank(
        tplan, torch.from_numpy(bank), torch.from_numpy(x[0]), torch.from_numpy(tail[0])
    )
    assert gotb.shape == (3, chunk // D)
    assert error_db(gotb.numpy(), np.asarray(wantb)) < -100.0


def test_return_filtered_and_its_guard():
    L, D, chunk = 257, 3, 12_288
    tplan = tosfir.OverlapSavePlan.for_chunk(L, D, chunk)  # power of two, fold 1
    assert tplan.fold == 1
    taps = _taps(L, D)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(chunk) + 1j * rng.standard_normal(chunk)).astype(np.complex64)
    tail = np.zeros(L - 1, np.complex64)
    h = tosfir.taps_fft(taps, tplan)
    dec, _, y = tosfir.os_fir_decimate(
        tplan, torch.from_numpy(h), torch.from_numpy(x), torch.from_numpy(tail),
        return_filtered=True,
    )
    jplan = josfir.OverlapSavePlan(**_fields(tplan))
    _, _, want = josfir.os_fir_decimate(
        jplan, jnp.asarray(h), jnp.asarray(x), jnp.asarray(tail), return_filtered=True
    )
    assert error_db(y.numpy(), np.asarray(want)) < -100.0
    assert torch.equal(dec, y[::D])
    folded = tosfir.OverlapSavePlan.for_chunk(L, 4, chunk)
    assert folded.fold > 1
    with pytest.raises(ValueError, match="return_filtered"):
        tosfir.os_fir_decimate(
            folded, torch.from_numpy(tosfir.taps_fft(taps, folded)), torch.from_numpy(x),
            torch.from_numpy(tail), return_filtered=True,
        )


def test_poly_branch_view_equals_frame_spectra_at_fold_one():
    """The polyphase-forward gather is a strided view; at a fold of 1 it is
    the plain frame spectra."""
    L, D, chunk = 129, 1, 4096
    plan = tosfir.OverlapSavePlan.for_chunk(L, D, chunk)
    poly = dataclasses.replace(plan, poly=True)
    assert poly.fold == 1
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal(chunk) + 1j * rng.standard_normal(chunk)).astype(np.complex64))
    tail = torch.from_numpy((rng.standard_normal(L - 1) + 0j).astype(np.complex64))
    a, tail_a = tosfir._frame_spectra(plan, x, tail)
    b, tail_b = tosfir._poly_branch_spectra(poly, x, tail)
    assert b.shape == (plan.num_frames, 1, plan.fft_size)
    assert torch.equal(a, b[:, 0]) and torch.equal(tail_a, tail_b)


def _ddc_setup(D, cpu_tuned, offsets=(25_000.0, -40_000.0), L=257, target=12_288):
    taps = _taps(L, D)
    incs = [int(round(o / FS * 2**32)) % (1 << 32) for o in offsets]
    plan = tddc.DDCPlan.create(L, D, target_chunk=target)
    os_plan = tosfir.OverlapSavePlan.for_chunk(L, D, plan.chunk_size, cpu_tuned=cpu_tuned)
    kernel_np = tddc.bandpass_kernel(taps, incs)
    bank = tddc.bank_from_kernel(kernel_np, os_plan)
    inc_lo = np.asarray([(i * D) % (1 << 32) for i in incs], np.uint32)
    return plan, os_plan, kernel_np, bank, inc_lo


@pytest.mark.parametrize("order", ["iq", "qi", "iq_inv", "qi_inv"])
@pytest.mark.parametrize("D,cpu_tuned", [(3, True), (4, False)])
def test_ddc_apply_fft_il_matches_jax_and_conv(order, D, cpu_tuned):
    plan, os_plan, kernel_np, bank, inc_lo = _ddc_setup(D, cpu_tuned)
    n, L = plan.chunk_size, plan.num_taps
    rng = np.random.default_rng(5)
    f = (rng.standard_normal(2 * n) * 0.3).astype(np.float32)
    tail = (rng.standard_normal((2, L - 1)) * 0.3).astype(np.float32)
    phase = rng.integers(0, 1 << 32, 2, dtype=np.uint64)
    jplan = jddc.DDCPlan(L, D, n)
    jos = josfir.OverlapSavePlan(**_fields(os_plan))
    want = jddc.ddc_apply_fft_il(
        jplan, jos, jnp.asarray(bank), jnp.asarray(f), jnp.asarray(tail),
        jnp.asarray(phase.astype(np.uint32)), jnp.asarray(inc_lo), order,
    )
    # the port's phase is 62-bit: the uint32 one shifted up 30 bits (ops/nco.py)
    phase62, inc_lo62 = phase.astype(np.int64) << 30, inc_lo.astype(np.int64) << 30
    got = tddc.ddc_apply_fft_il(
        plan, os_plan, torch.from_numpy(bank), torch.from_numpy(f), torch.from_numpy(tail),
        torch.from_numpy(phase62), torch.from_numpy(inc_lo62), order,
    )
    assert error_db(got[0].numpy(), np.asarray(want[0])) < -100.0
    assert error_db(got[1].numpy(), np.asarray(want[1])) < -100.0
    assert got[2].shape == (2, L - 1)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]).astype(np.int64) << 30)
    # the conv branch on the same stream: the interleaved form of the pair tail
    tr, ti = tail
    if order.endswith("_inv"):
        ti = -ti
    pair = (tr, ti) if order.startswith("iq") else (ti, tr)
    itail = np.empty(2 * (L - 1), np.float32)
    itail[0::2], itail[1::2] = pair
    conv = tddc.ddc_apply_il(
        plan, None, torch.from_numpy(f), torch.from_numpy(itail),
        torch.from_numpy(phase62), torch.from_numpy(inc_lo62),
        kernel_il=torch.from_numpy(tddc.interleave_kernel(kernel_np, order)),
    )
    assert error_db(got[0].numpy(), conv[0].numpy()) < -60.0
    assert error_db(got[1].numpy(), conv[1].numpy()) < -60.0
    assert torch.equal(got[3], conv[3])


@pytest.mark.parametrize("D,cpu_tuned", [(3, True), (3, False), (26, True)])
def test_ddc_apply_fft_matches_jax_chunked_equals_whole(D, cpu_tuned):
    plan, os_plan, kernel_np, bank, inc_lo = _ddc_setup(D, cpu_tuned, target=26 * 450)
    n, L = plan.chunk_size, plan.num_taps
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 3 * n)) * 0.3).astype(np.float32)
    jplan = jddc.DDCPlan(L, D, n)
    jos = josfir.OverlapSavePlan(**_fields(os_plan))
    tail_j = jnp.zeros((2, L - 1), jnp.float32)
    ph_j = jnp.asarray(np.asarray([123456, 99], np.uint32))
    tail_t = torch.zeros((2, L - 1))
    ph_t = torch.tensor([123456 << 30, 99 << 30], dtype=torch.int64)
    inc_t = torch.from_numpy(inc_lo.astype(np.int64) << 30)
    bank_t = torch.from_numpy(bank)
    parts = []
    for i in range(3):
        sl = slice(i * n, (i + 1) * n)
        yr_j, yi_j, tail_j, ph_j = jddc.ddc_apply_fft(
            jplan, jos, jnp.asarray(bank), jnp.asarray(x[0, sl]), jnp.asarray(x[1, sl]),
            tail_j, ph_j, jnp.asarray(inc_lo),
        )
        yr, yi, tail_t, ph_t = tddc.ddc_apply_fft(
            plan, os_plan, bank_t, torch.from_numpy(x[0, sl]), torch.from_numpy(x[1, sl]),
            tail_t, ph_t, inc_t,
        )
        assert error_db(yr.numpy(), np.asarray(yr_j)) < -100.0
        assert error_db(yi.numpy(), np.asarray(yi_j)) < -100.0
        np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))
        np.testing.assert_array_equal(ph_t.numpy(), np.asarray(ph_j).astype(np.int64) << 30)
        parts.append((yr, yi))
    whole_plan = tddc.DDCPlan.create(L, D, target_chunk=3 * n)
    assert whole_plan.chunk_size == 3 * n
    whole_os = tosfir.OverlapSavePlan.for_chunk(L, D, 3 * n, cpu_tuned=cpu_tuned)
    bank_w = torch.from_numpy(tddc.bank_from_kernel(kernel_np, whole_os))
    yr_w, yi_w, _, ph_w = tddc.ddc_apply_fft(
        whole_plan, whole_os, bank_w, torch.from_numpy(x[0]), torch.from_numpy(x[1]),
        torch.zeros((2, L - 1)), torch.tensor([123456 << 30, 99 << 30], dtype=torch.int64), inc_t,
    )
    assert error_db(torch.cat([p[0] for p in parts], -1).numpy(), yr_w.numpy()) < -100.0
    assert error_db(torch.cat([p[1] for p in parts], -1).numpy(), yi_w.numpy()) < -100.0
    assert torch.equal(ph_t, ph_w)


def test_complex_from_interleaved_orders():
    rng = np.random.default_rng(1)
    f = rng.standard_normal(64).astype(np.float32)
    for order in ("iq", "qi", "iq_inv", "qi_inv"):
        got = tddc.complex_from_interleaved(torch.from_numpy(f), order).numpy()
        want = np.asarray(jddc.complex_from_interleaved(jnp.asarray(f), order))
        np.testing.assert_array_equal(got, want)
    assert tddc.complex_from_interleaved(torch.from_numpy(f), "iq").data_ptr() == torch.from_numpy(f).data_ptr()
    with pytest.raises(ValueError, match="Unknown IQ order"):
        tddc.complex_from_interleaved(torch.from_numpy(f), "ii")
