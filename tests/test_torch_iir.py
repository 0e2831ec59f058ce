"""The port's first-order recurrences with per-sample coefficients (the
scan behind the SSB feedback AGC) and the DC blocker, against the JAX
package and against the literal per-sample loops, on the CPU.

Thresholds are those of the JAX package's own op tests: -90 dB for the
scan, -70 dB for the DC blocker against the float64 twin, -60 dB for the
AGC against its loop, -90 dB for chunked against whole AGC.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import error_db

from iq_to_audio_tpu.ops import iir as jiir
from iq_to_audio_tpu.ref.chain import RefDCBlocker

from iq_to_audio_torch.ops import iir as tiir

torch.set_num_threads(1)

TARGET = 10.0 ** (-12.0 / 20.0)


def _loop(a, b, y0):
    out = np.empty(b.shape[-1])
    prev = float(y0)
    for i in range(b.shape[-1]):
        prev = float(a[i]) * prev + float(b[i])
        out[i] = prev
    return out


@pytest.mark.parametrize("n", [1, 2, 1_000, 1_025, 20_001])
def test_first_order_scan_matches_loop_and_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 0.999, n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    y, y_last = tiir.first_order_scan(torch.from_numpy(a), torch.from_numpy(b), 0.3)
    expected = _loop(a, b, 0.3)
    assert error_db(y.numpy(), expected) < -90.0
    assert abs(float(y_last) - expected[-1]) < 1e-4
    yj, _ = jiir.first_order_scan(jnp.asarray(a), jnp.asarray(b), jnp.float32(0.3))
    assert error_db(y.numpy(), np.asarray(yj)) < -90.0


def test_first_order_scan_batched_carry():
    """A (C, n) batch with a per-channel carry; near-unit coefficients over a
    long run, where a cumulative product would underflow in float32."""
    rng = np.random.default_rng(9)
    a = np.full((3, 30_000), 0.999, np.float32)
    a[:, ::7] = 1.0
    b = rng.normal(scale=0.01, size=(3, 30_000)).astype(np.float32)
    y0 = np.asarray([1.0, -0.5, 0.25], np.float32)
    y, y_last = tiir.first_order_scan(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(y0))
    assert y.shape == (3, 30_000) and torch.all(torch.isfinite(y))
    for c in range(3):
        assert error_db(y[c].numpy(), _loop(a[c], b[c], y0[c])) < -90.0
    np.testing.assert_array_equal(y_last.numpy(), y[:, -1].numpy())


def test_dc_blocker_matches_twin_and_jax():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=30_000) + 0.5).astype(np.float32)
    ref = RefDCBlocker()
    expected = np.concatenate([ref.process(x[:13_000]), ref.process(x[13_000:])])
    xs, ys = torch.tensor(0.0), torch.tensor(0.0)
    out1, (xs, ys) = tiir.dc_blocker(torch.from_numpy(x[:13_000]), 0.995, xs, ys)
    out2, _ = tiir.dc_blocker(torch.from_numpy(x[13_000:]), 0.995, xs, ys)
    got = np.concatenate([out1.numpy(), out2.numpy()])
    assert error_db(got, expected) < -70.0
    yj, (xj, ylj) = jiir.dc_blocker(jnp.asarray(x), 0.995, jnp.float32(0.0), jnp.float32(0.0))
    whole, (xl, yl) = tiir.dc_blocker(torch.from_numpy(x), 0.995, 0.0, 0.0)
    assert error_db(whole.numpy(), np.asarray(yj)) < -100.0
    assert float(xl) == float(xj)
    assert abs(float(yl) - float(ylj)) <= 1e-5 * max(1.0, abs(float(ylj)))


def test_agc_coefficients_bit_identical():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=20_000) * 0.05).astype(np.float32)
    x[::97] = 0.0
    x[1::89] = 1e-6  # on the eps boundary: holds the gain
    x[2::83] = np.float32(1.0000001e-6)
    aj, bj = jiir.agc_coefficients(jnp.asarray(x), TARGET, 0.001)
    at, bt = tiir.agc_coefficients(torch.from_numpy(x), TARGET, 0.001)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


def test_feedback_agc_matches_reference_loop():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=20_000) * 0.05).astype(np.float32)
    x[::97] = 0.0  # exercise the |x| <= eps hold path
    gain = 1.0
    expected = np.empty_like(x, dtype=np.float64)
    for i, s in enumerate(x.astype(np.float64)):
        m = abs(s)
        if m > 1e-6:
            gain += 0.001 * (TARGET / m - gain)
        expected[i] = s * gain
    out, g_last = tiir.feedback_agc(torch.from_numpy(x), TARGET, 0.001, 1.0)
    assert error_db(out.numpy(), expected) < -60.0
    assert abs(float(g_last) / gain - 1.0) < 1e-3
    outj, _ = jiir.feedback_agc(jnp.asarray(x), TARGET, 0.001, jnp.float32(1.0))
    assert error_db(out.numpy(), np.asarray(outj)) < -90.0


def test_feedback_agc_chunked_equals_whole():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 8_192)) * 0.1).astype(np.float32)
    g0 = torch.ones(2)
    whole, _ = tiir.feedback_agc(torch.from_numpy(x), TARGET, 0.001, g0)
    g, parts = g0, []
    for s in range(0, x.shape[-1], 1_024):
        y, g = tiir.feedback_agc(torch.from_numpy(x[:, s : s + 1_024]), TARGET, 0.001, g)
        parts.append(y.numpy())
    assert error_db(np.concatenate(parts, axis=-1), whole.numpy()) < -90.0


def _agc_loop(x, gain, decay, eps=1e-6):
    """The upstream's AGC, one sample at a time, in float64."""
    out = np.empty_like(x, dtype=np.float64)
    for i, s in enumerate(np.asarray(x, np.float64)):
        m = abs(s)
        if m > eps:
            gain += decay * (TARGET / m - gain)
        out[i] = s * gain
    return out, gain


@pytest.mark.parametrize(
    "n,decay",
    [(2, 0.001), (4_095, 0.001), (4_097, 0.001), (20_001, 0.001), (20_001, 0.3), (9_000, 0.0)],
)
def test_float64_agc_closed_form_matches_loop(n, decay):
    """The float64 AGC (closed form in blocks: 4,096 samples at decay 0.001,
    256 at 0.3) against the per-sample loop, silent samples holding the gain."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=n) * 0.05
    x[::97] = 0.0
    x[1::89] = 1e-6
    x[n // 3 : n // 3 + 700] = 0.0
    expected, g_end = _agc_loop(x, 1.0, decay)
    out, g_last = tiir.feedback_agc(torch.from_numpy(x), TARGET, decay, 1.0)
    assert out.dtype == torch.float64
    assert error_db(out.numpy(), expected) < -250.0
    assert abs(float(g_last) / g_end - 1.0) < 1e-12


def test_float64_agc_batched_chunked_equals_whole():
    """Five channels with their own carried gains, whole against chunks of
    sizes that cut the blocks anywhere, and against the doubling scan."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(5, 161_250)) * 0.05)
    g0 = torch.tensor([1.0, 0.5, 2.0, 1.0, 0.1])
    whole, g_whole = tiir.feedback_agc(x, TARGET, 0.001, g0)
    g, parts = g0, []
    for s in range(0, x.shape[-1], 40_000):
        y, g = tiir.feedback_agc(x[:, s : s + 40_000], TARGET, 0.001, g)
        parts.append(y)
    assert error_db(torch.cat(parts, -1).numpy(), whole.numpy()) < -250.0
    assert torch.allclose(g, g_whole, rtol=1e-12, atol=0.0)
    a, b = tiir.agc_coefficients(x, TARGET, 0.001)
    gd, _ = tiir.first_order_scan(a, b, g0.double())
    assert error_db(whole.numpy(), (x * gd).numpy()) < -250.0
    expected, _ = _agc_loop(x[2].numpy(), 2.0, 0.001)
    assert error_db(whole[2].numpy(), expected) < -250.0


def test_float64_agc_fast_decay_takes_the_doubling_scan():
    """A decay whose keep**64 would leave the closed form's range falls back
    to the doubling scan, which still matches the loop."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=3_000) * 0.05
    assert tiir._agc_gain_f64(torch.from_numpy(x), TARGET, 0.995, 1.0, 1e-6) is None
    out, _ = tiir.feedback_agc(torch.from_numpy(x), TARGET, 0.995, 1.0)
    expected, _ = _agc_loop(x, 1.0, 0.995)
    assert error_db(out.numpy(), expected) < -250.0
