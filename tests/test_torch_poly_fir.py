"""The port's polyphase-FIR channelizer against the JAX package's Pallas
kernels (``pallas_poly_fir_il`` over the interleaved stream and
``pallas_poly_fir`` over an (re, im) pair, run in interpret mode on the CPU).

On the CPU the wrapper takes the plain torch version; the CUDA kernel is
held against that plain version on the card in ``test_torch_cuda.py``.  The
kernel's own arithmetic (the shifted GEMM in blocks, three TF32 products per
term) is ``poly_fir_shifted_plain``, held here against the same Pallas
kernels.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import error_db, make_tone_iq

from iq_to_audio_tpu.ops import pallas_ddc as jpallas
from iq_to_audio_tpu.ops.ddc import bandpass_kernel, interleave_kernel
from iq_to_audio_tpu.ops.nco import nco_increment_fixed
from iq_to_audio_tpu.pipeline.filters import design_channel_filter

from iq_to_audio_torch.ops import ddc as tddc
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
    [(62, 52, 2, True), (62, 52, 10, True), (385, 52, 2, False), (10, 400, 10, True)],
)
def test_choose_k_block_fits_shared_memory(k_taps, feat, out_ch, whole):
    """Blocks are whole super-taps (4 taps); all taps in one block when two
    CTAs then fit an SM, else balanced shorter blocks."""
    for out_size in (None, 161_250, 1_000):
        kb = tpoly.choose_k_block(k_taps, feat, out_ch, out_size, 132)
        assert kb % 4 == 0
        assert tpoly.smem_bytes(kb, feat, out_ch) <= 227 * 1024
    assert (tpoly.choose_k_block(k_taps, feat, out_ch) >= k_taps + 3) == whole


def test_choose_k_block_accepts_any_width():
    """The feature axis is walked in blocks of 8, so a decimation of 1000
    (2000 features), which one tap of the former kernel could not hold,
    gets the same blocks as any other."""
    kb = tpoly.choose_k_block(10, 2000, 10)
    assert kb == tpoly.choose_k_block(10, 52, 10) == 16
    assert tpoly.smem_bytes(kb, 2000, 10) == tpoly.smem_bytes(kb, 52, 10) <= 75 * 1024


@settings(max_examples=200, deadline=None)
@given(
    decim=st.integers(1, 1000),
    out_ch=st.sampled_from((2, 4, 6, 8, 10)),
    k_taps=st.integers(1, 4000),
    out_size=st.one_of(st.none(), st.integers(1, 1 << 22)),
)
def test_choose_blocks_fit_every_geometry(decim, out_ch, k_taps, out_size):
    kb = tpoly.choose_k_block(k_taps, 2 * decim, out_ch, out_size, 132)
    assert 4 <= kb <= 4 * tpoly.super_taps(k_taps) and kb % 4 == 0
    assert tpoly.smem_bytes(kb, 2 * decim, out_ch) <= 227 * 1024


def test_choose_k_block_by_waves():
    """The flagship chunk is 630 CTAs of 256 rows: all 68 taps in one block
    (41 KB) let five CTAs share an SM, one wave over 132 SMs.  At ten
    outputs per row the whole tap tensor would leave two CTAs per SM and a
    second, part-filled wave; two blocks of 36 taps keep three.  A short
    stream (one wave whatever the block) takes the fewest blocks."""
    assert tpoly.choose_k_block(62, 52, 2, 161_250, 132) == 68
    assert tpoly.smem_bytes(68, 52, 2) <= (228 * 1024) // 5 - 1024
    assert tpoly.choose_k_block(62, 52, 10, 161_250, 132) == 36
    assert (228 * 1024) // (tpoly.smem_bytes(36, 52, 10) + 1024) >= 3
    assert tpoly.choose_k_block(62, 520, 2, 16_125, 132) == 68


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


def _shifted_case(layout, decim, channels, out_size=150):
    """Inputs of one layout on the s16 grid, and the Pallas kernel's result
    in interpret mode."""
    taps = design_channel_filter(FS, 12_500.0, decim)
    seed = 7 * decim + channels
    if layout == "il":
        offsets = [25_000.0 - 17_000.0 * c for c in range(channels)]
        x, poly = _stream(taps, offsets, decim, out_size, seed=seed)
    else:
        x, poly = _pair(taps, channels, decim, out_size, seed=seed)
    x = (np.round(x * 8192.0).clip(-32768, 32767) / 32768.0).astype(np.float32)
    fn = jpallas.pallas_poly_fir_il if layout == "il" else jpallas.pallas_poly_fir
    with _Interpret():
        want = np.asarray(fn(jnp.asarray(x), jnp.asarray(poly), decim, out_size))
    return torch.from_numpy(x), torch.from_numpy(poly), want


@pytest.mark.parametrize("layout", ["il", "pair"])
@pytest.mark.parametrize("decim", [4, 26])
@pytest.mark.parametrize("channels", [1, 2, 5])
def test_shifted_gemm_matches_pallas(layout, decim, channels):
    """The kernel's form (4 rows per super-row, feature blocks of 8, tap
    blocks, 3xTF32) against the Pallas kernel: < -100 dB, the same gate the
    card holds the CUDA kernel to; and against the plain version, which
    rounds every float32 product: < -110 dB."""
    x, poly, want = _shifted_case(layout, decim, channels)
    out_size = want.shape[1]
    got = tpoly.poly_fir_shifted_plain(x, poly, decim, out_size, pair=layout == "pair")
    assert got.shape == (2 * channels, out_size)
    assert error_db(got.numpy(), want) < -100.0
    plain = tpoly.poly_fir_il_plain if layout == "il" else tpoly.poly_fir_pair_plain
    assert error_db(got.numpy(), plain(x, poly, decim, out_size).numpy()) < -110.0


@pytest.mark.parametrize("layout", ["il", "pair"])
@pytest.mark.parametrize("k_block", [1, 7, 16])
def test_shifted_gemm_blocks_and_ragged_rows(layout, k_block):
    """Forced tap blocks and an output count that is no multiple of 4."""
    x, poly, want = _shifted_case(layout, 26, 2, out_size=149)
    got = tpoly.poly_fir_shifted_plain(
        x, poly, 26, 149, pair=layout == "pair", k_block=k_block
    )
    assert error_db(got.numpy(), want) < -100.0


@pytest.mark.parametrize("layout", ["il", "pair"])
def test_one_tf32_product_misses_the_gate(layout):
    """With the ``lo`` terms dropped (one TF32 product per term) the same
    form is worse than -80 dB: the -100 dB gate catches a lost term."""
    x, poly, want = _shifted_case(layout, 26, 1)
    got = tpoly.poly_fir_shifted_plain(
        x, poly, 26, want.shape[1], pair=layout == "pair", products=1
    )
    assert -80.0 < error_db(got.numpy(), want) < -40.0


@pytest.mark.parametrize("grid", ["s16", "u8", "f32"])
def test_split_tf32(grid):
    """``hi + lo`` is exact on the s16 and u8 sample grids (at most 16
    significant bits, 11 + 11 kept); a general float32 keeps 2**-21."""
    rng = np.random.default_rng(11)
    if grid == "s16":
        v = np.arange(-32768, 32768, dtype=np.float32) / 32768.0
    elif grid == "u8":
        v = (np.arange(256, dtype=np.float32) - 127.5) / 127.5
        v = np.concatenate([v, (np.arange(256, dtype=np.float32) - 128.0) / 128.0])
    else:
        v = rng.normal(size=50_000).astype(np.float32)
    t = torch.from_numpy(v)
    hi, lo = tpoly.split_tf32(t)
    for part in (hi, lo):  # both halves are TF32: low 13 mantissa bits clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    if grid == "f32":
        rel = ((hi.double() + lo.double() - t.double()).abs() / t.double().abs()).max()
        assert float(rel) <= 2.0**-21
        assert not torch.equal(hi + lo, t)
    elif grid == "s16":
        assert torch.equal(hi + lo, t)
    else:
        # u8 scaled by 1/127.5 is no power of two: 24 significant bits
        assert torch.equal((hi + lo)[256:], t[256:])
        assert float(((hi + lo - t).abs() / t.abs())[:256].max()) <= 2.0**-21


@pytest.mark.parametrize("decim", [4, 26])
@pytest.mark.parametrize("channels", [1, 3])
def test_shifted_taps_equal_shift_matmul_kernel(decim, channels):
    """The indexer of the shifted B (column ``i*O + o`` of flat row ``j`` is
    ``Wflat[j - F*i, o]``) against the port's copy of ``shift_matmul_kernel``
    at J = 4 (columns ``o*J + j``), which itself equals the JAX package's."""
    from iq_to_audio_tpu.ops.ddc import shift_matmul_kernel as jshift

    taps = design_channel_filter(FS, 12_500.0, decim)
    incs = [nco_increment_fixed(25_000.0 - 17_000.0 * c, FS) for c in range(channels)]
    kernel_il = tddc.interleave_kernel(tddc.bandpass_kernel(taps, incs), "iq")
    mm = tddc.shift_matmul_kernel(kernel_il, decim, 4)
    np.testing.assert_array_equal(mm, jshift(kernel_il, decim, 4))
    poly = tpoly.build_poly_kernel(kernel_il, 2 * decim)
    K, F, O = poly.shape
    b = tpoly.shifted_taps(poly).reshape(-1, 4, O)
    flat = mm.reshape(-1, O, 4).transpose(0, 2, 1)  # (rows, i, o)
    rows = max(len(b), len(flat))
    b = np.pad(b, ((0, rows - len(b)), (0, 0), (0, 0)))
    flat = np.pad(flat, ((0, rows - len(flat)), (0, 0), (0, 0)))
    assert b.shape == flat.shape and np.count_nonzero(b) > 0
    np.testing.assert_array_equal(b, flat)
