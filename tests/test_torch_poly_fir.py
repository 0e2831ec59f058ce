"""The port's polyphase-FIR channelizer against the JAX package's Pallas
kernels (``pallas_poly_fir_il`` over the interleaved stream and
``pallas_poly_fir`` over an (re, im) pair, run in interpret mode on the CPU).

On the CPU the wrapper takes the plain torch version; the CUDA kernel is
held against that plain version on the card in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import error_db, make_tone_iq

from iq_to_audio_tpu.ops import pallas_ddc as jpallas
from iq_to_audio_tpu.ops.ddc import bandpass_kernel, interleave_kernel
from iq_to_audio_tpu.ops.nco import nco_increment_fixed
from iq_to_audio_tpu.pipeline.filters import design_channel_filter

from iq_to_audio_torch.ops import poly_fir as tpoly

torch.set_num_threads(1)

FS = 250_000.0


class _Interpret:
    """Force pallas_call into interpreter mode (no TPU needed)."""

    def __enter__(self):
        import jax.experimental.pallas as pl_mod

        self._orig = pl_mod.pallas_call

        def patched(*args, **kwargs):
            kwargs["interpret"] = True
            return self._orig(*args, **kwargs)

        pl_mod.pallas_call = patched
        jpallas.pl.pallas_call = patched
        return self

    def __exit__(self, *exc):
        import jax.experimental.pallas as pl_mod

        pl_mod.pallas_call = self._orig
        jpallas.pl.pallas_call = self._orig
        return False


def _stream(taps, offsets, decim, out_size, seed=0):
    """Interleaved stream with a random carried tail, and the polyphase
    tensor of its interleaved bandpass kernel."""
    incs = [nco_increment_fixed(o, FS) for o in offsets]
    kernel_il = interleave_kernel(bandpass_kernel(taps, incs), "iq")
    poly = tpoly.build_poly_kernel(kernel_il, 2 * decim)
    n = out_size * decim
    L = len(taps)
    x = make_tone_iq(FS, (n + 10) / FS, 10_000.0, seed=seed)[:n]
    x_il = np.empty(2 * n, np.float32)
    x_il[0::2] = x.real
    x_il[1::2] = x.imag
    tail = np.random.default_rng(seed).normal(scale=0.3, size=2 * (L - 1))
    return np.concatenate([tail.astype(np.float32), x_il]), poly


@pytest.mark.parametrize("decim", [4, 26])
@pytest.mark.parametrize("offsets", [(25_000.0,), (25_000.0, -40_000.0)])
def test_poly_fir_plain_matches_pallas(decim, offsets):
    taps = design_channel_filter(FS, 12_500.0, decim)
    out_size = 300
    full, poly = _stream(taps, offsets, decim, out_size)
    with _Interpret():
        want = jpallas.pallas_poly_fir_il(jnp.asarray(full), jnp.asarray(poly), decim, out_size)
    got = tpoly.poly_fir_il(torch.from_numpy(full), torch.from_numpy(poly), decim, out_size)
    assert got.shape == (2 * len(offsets), out_size)
    assert error_db(got.numpy(), np.asarray(want)) < -100.0


def test_poly_fir_tap_tiled_matches_pallas():
    """An 8193-tap filter: both sides walk the tap axis in blocks (JAX as
    grid_k steps of 8 taps, the port as its tap-block loop)."""
    decim = 26
    rng = np.random.default_rng(3)
    taps = rng.normal(size=8193) / 8193
    out_size = 96
    full, poly = _stream(taps, (25_000.0,), decim, out_size, seed=1)
    K, F, O = poly.shape
    assert K > 256
    assert tpoly.choose_k_block(K, F, O) < K  # the default block tiles too
    with _Interpret():
        want = jpallas.pallas_poly_fir_il(
            jnp.asarray(full), jnp.asarray(poly), decim, out_size, k_block=8
        )
    got = tpoly.poly_fir_il(
        torch.from_numpy(full), torch.from_numpy(poly), decim, out_size, k_block=16
    )
    assert error_db(got.numpy(), np.asarray(want)) < -100.0


@pytest.mark.parametrize(
    "k_taps,feat,out_ch,whole",
    [(62, 52, 2, True), (62, 52, 4, False), (385, 52, 2, False), (10, 400, 10, False)],
)
def test_choose_k_block_fits_shared_memory(k_taps, feat, out_ch, whole):
    kb = tpoly.choose_k_block(k_taps, feat, out_ch)
    assert (kb == k_taps) == whole
    assert tpoly.smem_bytes(kb, feat, out_ch) <= 227 * 1024
    if not whole and kb >= 8:
        assert kb % 8 == 0


def test_choose_k_block_rejects_too_wide():
    with pytest.raises(ValueError, match="shared memory"):
        tpoly.choose_k_block(10, 2000, 10)


@pytest.mark.parametrize("fn", ["poly_fir_il", "poly_fir_pair"])
def test_poly_fir_rejects_unsupported_device(fn):
    x = torch.zeros((8,) if fn == "poly_fir_il" else (2, 4), device="meta")
    w = torch.zeros((1, 2, 2), device="meta")
    with pytest.raises(ValueError, match="device"):
        getattr(tpoly, fn)(x, w, 1, 4)


def _pair(taps, channels, decim, out_size, seed=0):
    """An (re, im) pair with a random carried tail, and the polyphase tensor
    of its pair bandpass kernel for ``channels`` offsets."""
    offsets = [25_000.0 - 17_000.0 * c for c in range(channels)]
    incs = [nco_increment_fixed(o, FS) for o in offsets]
    poly = tpoly.build_poly_kernel(bandpass_kernel(taps, incs), decim)
    n = out_size * decim
    x = make_tone_iq(FS, (n + 10) / FS, 10_000.0, seed=seed)[:n]
    tail = np.random.default_rng(seed).normal(scale=0.3, size=(2, len(taps) - 1))
    x_pair = np.concatenate([tail, np.stack([x.real, x.imag])], axis=1).astype(np.float32)
    return x_pair, poly


@pytest.mark.parametrize("decim", [4, 26])
@pytest.mark.parametrize("channels", [1, 2, 5])
def test_poly_fir_pair_plain_matches_pallas(decim, channels):
    """The pair wrapper on the CPU (its plain version: relay with torch ops,
    then the plain tap loop) against ``pallas_poly_fir``: < -100 dB."""
    taps = design_channel_filter(FS, 12_500.0, decim)
    out_size = 300
    x_pair, poly = _pair(taps, channels, decim, out_size, seed=decim + channels)
    with _Interpret():
        want = jpallas.pallas_poly_fir(jnp.asarray(x_pair), jnp.asarray(poly), decim, out_size)
    got = tpoly.poly_fir_pair(torch.from_numpy(x_pair), torch.from_numpy(poly), decim, out_size)
    assert got.shape == (2 * channels, out_size)
    assert error_db(got.numpy(), np.asarray(want)) < -100.0


def test_poly_fir_pair_plain_equals_relayed_il():
    """The pair layout is the interleaved layout of the relayed stream:
    feeding ``X[t, i*D + p] = x_pair[i, D*t + p]`` flattened to the
    interleaved wrapper gives the same rows, at any tap block."""
    decim = 26
    taps = design_channel_filter(FS, 12_500.0, decim)
    out_size = 200
    x_pair, poly = _pair(taps, 2, decim, out_size, seed=4)
    K = poly.shape[0]
    t_need = out_size + K - 1
    relayed = np.ascontiguousarray(
        x_pair[:, : t_need * decim].reshape(2, t_need, decim).transpose(1, 0, 2).reshape(-1)
    )
    want = tpoly.poly_fir_il(torch.from_numpy(relayed), torch.from_numpy(poly), decim, out_size)
    for kb in (None, 1, 5):
        got = tpoly.poly_fir_pair_plain(
            torch.from_numpy(x_pair), torch.from_numpy(poly), decim, out_size, k_block=kb
        )
        assert error_db(got.numpy(), want.numpy()) < -120.0
