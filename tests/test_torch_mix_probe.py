"""The mixer-sign probe's plain form (``ops/mix_probe.py``) against the
host twin (``ref/chain.py``) on the CPU.

The twin filters the whole snippet with overlap-save FFTs and keeps one
output in ``D``; ``mix_sign_powers_plain`` computes only the kept outputs,
directly.  Both are float64, so the powers agree to rounding (1e-10
relative) and the signs match.  The CUDA kernel is held to the twin on the
card in ``test_torch_cuda.py``; here the kernel's tiling, output tiles and
tap passes over a span of mixed samples in shared memory, is walked in
numpy and held to the plain form.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from mix_probe_cases import CODECS, DECIMATION, FS, OFFSET, taps, warm_block
from mix_probe_cases import WIDE_DECIMATION, WIDE_FS, WIDE_OFFSET, wide_taps, wide_warm_block

from iq_to_audio_tpu.ref.chain import choose_mix_sign as jax_choose_mix_sign

from iq_to_audio_torch.ops import mix_probe
from iq_to_audio_torch.ops.mix_probe import (
    choose_mix_sign_on,
    choose_tile,
    mix_sign_powers,
    mix_sign_powers_plain,
    phase_coefficient,
    probe_geometry,
    smem_bytes,
)
from iq_to_audio_torch.ref.chain import choose_mix_sign, mix_sign_powers as twin_powers
from iq_to_audio_torch.ref.chain import pick_mix_sign

torch.set_num_threads(1)

RTOL = 1e-10


def _agree(got, want) -> None:
    assert np.allclose(got, want, rtol=RTOL, atol=0.0), (got, want)


@pytest.mark.parametrize("carrier", [1, -1, 0], ids=["plus", "minus", "noise"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("mode", ["nfm", "usb"])
def test_plain_matches_twin(mode, codec, carrier):
    """1,601 (NFM) and 7,143 (USB) taps at D = 26, each codec through
    ``convert_to_complex``, a carrier at the target's offset, at its mirror,
    or none: the powers agree, and so do the signs, the JAX package's
    included; a carrier decides for its side."""
    h = taps(mode)
    warm = warm_block(codec, carrier, seed=len(h) + carrier)
    want = twin_powers(warm, FS, OFFSET, h, DECIMATION)
    got = mix_sign_powers_plain(warm, FS, OFFSET, h, DECIMATION)
    _agree(got, want)
    sign = choose_mix_sign(warm, FS, OFFSET, h, DECIMATION)
    assert pick_mix_sign(got) == sign == jax_choose_mix_sign(warm, FS, OFFSET, h, DECIMATION)
    if carrier:
        assert sign == carrier


@pytest.mark.parametrize("carrier", [1, -1, 0], ids=["plus", "minus", "noise"])
def test_plain_matches_twin_at_20_msps(carrier):
    """The airband geometry: 12,801 taps at D = 208 over the first
    1,000,000 samples; the powers agree, and so do the signs, the JAX
    package's included."""
    h = wide_taps()
    assert h.size == 12_801
    warm = wide_warm_block(carrier, seed=208 + carrier)
    n, d, k, first = probe_geometry(warm.size, WIDE_FS, h.size, WIDE_DECIMATION)
    assert (n, d, k, first) == (1_000_000, 208, 4_808, 1_202)
    want = twin_powers(warm, WIDE_FS, WIDE_OFFSET, h, WIDE_DECIMATION)
    _agree(mix_sign_powers_plain(warm, WIDE_FS, WIDE_OFFSET, h, WIDE_DECIMATION), want)
    sign = choose_mix_sign(warm, WIDE_FS, WIDE_OFFSET, h, WIDE_DECIMATION)
    assert pick_mix_sign(want) == sign
    assert sign == jax_choose_mix_sign(warm, WIDE_FS, WIDE_OFFSET, h, WIDE_DECIMATION)
    if carrier:
        assert sign == carrier


EDGES = {
    # the snippet_len < len(taps) branch: the whole block, shorter than the filter
    "shorter_than_taps": (1_000, 1),
    "empty": (0, 0),
    # fewer samples than one decimation step: one output, y[0] = h[0] x[0]
    "under_one_step": (DECIMATION - 3, 1),
    # every power 0: +1 wins the tie
    "all_zero": (20_000, 0),
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_plain_matches_twin_at_the_edges(case):
    samples, carrier = EDGES[case]
    h = taps("nfm")
    warm = warm_block("pcm_s16le", carrier, seed=3, samples=max(samples, 1))[:samples]
    if case == "all_zero":
        warm = np.zeros_like(warm)
    want = twin_powers(warm, FS, OFFSET, h, DECIMATION)
    got = mix_sign_powers_plain(warm, FS, OFFSET, h, DECIMATION)
    _agree(got, want)
    assert pick_mix_sign(got) == choose_mix_sign(warm, FS, OFFSET, h, DECIMATION)
    if case in ("empty", "all_zero"):
        assert got[0] == got[1] and pick_mix_sign(got) == 1
        assert got[0] == (-math.inf if case == "empty" else 0.0)


def _tile_walk(warm, sample_rate, freq_offset, h, decimation, m, tc):
    """The kernel's loops in numpy: CTA (b, s) takes outputs ``first + bM``
    on, each pass over taps ``t0 .. t1 - 1`` mixes its span of samples
    from ``k_lo D - (t1 - 1)`` on, and each output reads
    ``span[i D + t1 - 1 - t]``; partials summed in tile order."""
    n, d, k, first = probe_geometry(warm.size, sample_rate, h.size, decimation)
    x = warm[:n].astype(np.complex128)
    n_out = k - first
    powers = []
    for sign in (1, -1):
        c = phase_coefficient(sign, freq_offset)
        partials = []
        for k_lo in range(first, k, m):
            cnt = min(m, k - k_lo)
            acc = np.zeros(cnt, np.complex128)
            for t0 in range(0, h.size, tc):
                t1 = min(h.size, t0 + tc)
                idx = k_lo * d - (t1 - 1) + np.arange((cnt - 1) * d + (t1 - t0))
                ok = (idx >= 0) & (idx < n)
                theta = (c * idx[ok].astype(np.float64)) * (1.0 / sample_rate)
                span = np.zeros(idx.size, np.complex128)
                span[ok] = x[idx[ok]] * (np.cos(theta) + 1j * np.sin(theta))
                ts = np.arange(t0, t1)
                for i in range(cnt):
                    acc[i] += np.dot(h[t0:t1], span[i * d + t1 - 1 - ts])
            partials.append(float(np.sum(acc.real**2 + acc.imag**2)))
        powers.append(sum(partials) / n_out)
    return tuple(powers)


@pytest.mark.parametrize("m,tc", [(1, 101), (5, 17), (8, 1), (64, 101), (13, 40)])
def test_the_kernels_tiling_matches_plain(m, tc):
    """Ragged last tiles and several tap passes per tile (a small filter
    and snippet, so the walk stays short)."""
    h = taps("nfm")[::16].copy()  # 101 taps
    warm = warm_block("pcm_f32le", 1, seed=5, samples=3_000)
    _agree(_tile_walk(warm, FS, OFFSET, h, 7, m, tc), mix_sign_powers_plain(warm, FS, OFFSET, h, 7))


@pytest.mark.parametrize("sm_count", [132, 114, 1])
@pytest.mark.parametrize(
    "n_out,n_taps,decimation",
    [(3_782, 1_601, 26), (3_782, 7_143, 26), (1, 1, 1), (3_782, 30_000, 26),
     (100, 1_601, 5_000), (1_000_000, 64, 2), (48_076, 1_601, 260), (3_606, 12_801, 208)],
)
def test_tile_fits_shared_memory(n_out, n_taps, decimation, sm_count):
    """Every tile fits 227 KB; a tile that did not shrink puts both signs
    in one wave; the benchmark's filters take one tap pass."""
    m, tc = choose_tile(n_out, n_taps, decimation, sm_count)
    assert m >= 1 and 1 <= tc <= n_taps
    assert smem_bytes(m, tc, decimation) <= mix_probe._SMEM_MAX
    if m == -(-2 * n_out // sm_count):
        assert 2 * -(-n_out // m) <= sm_count + 1
    if (n_taps, decimation) in ((1_601, 26), (7_143, 26), (12_801, 208)):
        assert tc == n_taps


def test_cpu_dispatch_runs_the_twin_and_counts_nothing(monkeypatch):
    """Off the card the sign is the twin's own: no kernel wrapper runs."""

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper ran on the CPU")

    monkeypatch.setattr(mix_probe, "mix_sign_powers", refuse)
    h = taps("nfm")
    warm = warm_block("pcm_s16le", -1, seed=9)
    counted = []
    monkeypatch.setattr(mix_probe.spans, "count", lambda *a: counted.append(a))
    got = choose_mix_sign_on(torch.device("cpu"), warm, FS, OFFSET, h, DECIMATION)
    assert got == choose_mix_sign(warm, FS, OFFSET, h, DECIMATION) == -1
    assert counted == []


def test_wrapper_on_the_cpu_is_the_plain_form():
    h = taps("nfm")
    warm = warm_block("pcm_u8", 1, seed=11)
    got = mix_sign_powers(warm, FS, OFFSET, h, DECIMATION, torch.device("cpu"))
    assert got == mix_sign_powers_plain(warm, FS, OFFSET, h, DECIMATION)
    with pytest.raises(ValueError):
        mix_sign_powers(warm, FS, OFFSET, h, DECIMATION, torch.device("meta"))
    with pytest.raises(ValueError):
        mix_sign_powers_plain(warm, FS, OFFSET, h + 0j, DECIMATION)
