"""The port's bindings of the host C++ helpers: the native channelizer
(``native/ddc.cpp`` through ctypes) against the port's conv branch, and the
native IO kernels (``native/iqio.cpp``) against the numpy paths bit for bit.
Skipped without ``g++``."""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import error_db

from iq_to_audio_torch.io import native as tio
from iq_to_audio_torch.io import reader as treader
from iq_to_audio_torch.io import writer as twriter
from iq_to_audio_torch.ops import ddc as tddc
from iq_to_audio_torch.ops import native_ddc as tnative
from iq_to_audio_torch.ops.nco import device_increment, nco_increment_residual
from iq_to_audio_torch.pipeline.filters import design_channel_filter
from iq_to_audio_torch.pipeline.step import _device_scale
from iq_to_audio_torch.utils import native_build

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")

torch.set_num_threads(1)

FS = 250_000.0
L = 257


def _raw(rng, codec, count):
    if codec == "pcm_u8":
        return rng.integers(0, 256, count, dtype=np.uint8)
    if codec == "pcm_s16le":
        return rng.integers(-20000, 20000, count, dtype=np.int16)
    return (rng.standard_normal(count) * 0.3).astype(np.float32)


def _setup(decim, offsets, rate=FS, taps=None, target_chunk=12_288):
    if taps is None:
        taps = np.kaiser(L, 8.0) * np.sinc((1.0 / decim) * (np.arange(L) - L // 2))
        taps /= taps.sum()
    incs = [int(round(o / rate * 2**32)) % (1 << 32) for o in offsets]
    plan = tddc.DDCPlan.create(len(taps), decim, target_chunk=target_chunk)
    return np.asarray(taps), plan, incs


def _incs62(plan, incs, res):
    """The 62-bit increments per input and per output sample (``ops/nco.py``)
    of uint32 ``incs`` with residuals ``res`` (zero when None)."""
    pairs = list(zip(incs, res or [0] * len(incs)))
    full = [device_increment(*p) for p in pairs]
    lo = [device_increment(*p, plan.decimation) for p in pairs]
    return torch.tensor(full, dtype=torch.int64), torch.tensor(lo, dtype=torch.int64)


def _native(plan, taps, incs, raw, itail, phase, codec, order, res=None):
    """``phase`` is the 62-bit phase (int64)."""
    full, inc_lo = _incs62(plan, incs, res)
    h_rev = torch.from_numpy(np.ascontiguousarray(taps.astype(np.float32)[::-1]))
    return tnative.ddc_apply_native(
        plan, h_rev, full, torch.from_numpy(raw),
        torch.from_numpy(itail), torch.from_numpy(phase), inc_lo, codec, order,
    )


def _conv(plan, taps, incs, raw, itail, phase, codec, order, res=None):
    _, inc_lo = _incs62(plan, incs, res)
    kil = tddc.interleave_kernel(tddc.bandpass_kernel(taps, incs, res), order)
    return tddc.ddc_apply_il(
        plan, None, _device_scale(torch.from_numpy(raw), codec), torch.from_numpy(itail),
        torch.from_numpy(phase), inc_lo, kernel_il=torch.from_numpy(kil),
    )


def test_library_builds_outside_native_dir():
    assert tnative.available()
    assert tio.get_lib() is not None
    built = sorted(p.name for p in native_build.BUILD_DIR.glob("lib*.so"))
    assert any(n.startswith("libddc_") for n in built)
    assert any(n.startswith("libiqio_") for n in built)
    assert native_build.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    assert native_build.BUILD_DIR.parent.parent == Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("order", ["iq", "qi", "iq_inv", "qi_inv"])
@pytest.mark.parametrize("codec", ["pcm_u8", "pcm_s16le", "pcm_f32le"])
def test_native_matches_conv(codec, order):
    taps, plan, incs = _setup(3, (25_000.0, -40_000.0))
    rng = np.random.default_rng(5)
    raw = _raw(rng, codec, 2 * plan.chunk_size)
    itail = (rng.standard_normal(2 * (L - 1)) * 0.2).astype(np.float32)
    phase = np.asarray([123456, 4_000_000_000], np.int64) << 30
    got = _native(plan, taps, incs, raw, itail, phase, codec, order)
    want = _conv(plan, taps, incs, raw, itail, phase, codec, order)
    assert got[0].shape == (2, plan.out_size)
    # u8 input is coarse but both sides see the same scaled samples
    assert error_db(got[0].numpy(), want[0].numpy()) < -100.0
    assert error_db(got[1].numpy(), want[1].numpy()) < -100.0
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


@pytest.mark.parametrize("decim", [17, 26, 32])
@pytest.mark.parametrize("order", ["iq", "qi_inv"])
def test_native_transpose_fill_decims(decim, order):
    """The decimations of the JAX package's native test (D >= 16 engages the
    kernel's transpose fill), on a chunk that straddles its tiles."""
    rate = 2_500_000.0
    taps = np.asarray(design_channel_filter(rate, 12_500.0, decim))
    taps, plan, incs = _setup(decim, (25_000.0,), rate=rate, taps=taps, target_chunk=40_000)
    rng = np.random.default_rng(decim)
    raw = _raw(rng, "pcm_s16le", 2 * plan.chunk_size)
    itail = (rng.standard_normal(2 * (len(taps) - 1)) * 0.2).astype(np.float32)
    phase = np.asarray([456789], np.int64) << 30
    got = _native(plan, taps, incs, raw, itail, phase, "pcm_s16le", order)
    want = _conv(plan, taps, incs, raw, itail, phase, "pcm_s16le", order)
    assert error_db(got[0].numpy(), want[0].numpy()) < -100.0
    assert error_db(got[1].numpy(), want[1].numpy()) < -100.0
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("decim", [3, 26])
def test_native_chunked_equals_whole(decim):
    taps, plan, incs = _setup(decim, (25_000.0,), target_chunk=26 * 450)
    n = plan.chunk_size
    whole = tddc.DDCPlan.create(L, decim, target_chunk=3 * n)
    assert whole.chunk_size == 3 * n
    rng = np.random.default_rng(26)
    raw = _raw(rng, "pcm_s16le", 6 * n)
    itail0 = np.zeros(2 * (L - 1), np.float32)
    phase0 = np.asarray([31337], np.int64) << 30
    yr_w, yi_w, tail_w, ph_w = _native(whole, taps, incs, raw, itail0, phase0, "pcm_s16le", "iq")
    tail, ph, parts = itail0, phase0, []
    for i in range(3):
        yr, yi, tail_t, ph_t = _native(
            plan, taps, incs, raw[2 * i * n : 2 * (i + 1) * n], tail, ph, "pcm_s16le", "iq"
        )
        tail, ph = tail_t.numpy(), ph_t.numpy()
        parts.append((yr, yi))
    assert error_db(torch.cat([p[0] for p in parts], -1).numpy(), yr_w.numpy()) < -100.0
    assert error_db(torch.cat([p[1] for p in parts], -1).numpy(), yi_w.numpy()) < -100.0
    np.testing.assert_array_equal(tail, tail_w.numpy())
    np.testing.assert_array_equal(ph, ph_w.numpy())


@pytest.mark.parametrize("order", ["iq", "qi_inv"])
def test_native_turns_onto_the_exact_nco(order):
    """Off the uint32 grid the kernel mixes at the nearest uint32 increment
    and the output is turned the rest of the way: over chunks it stays with
    the conv branch, whose taps turn at the exact frequency."""
    rate = 250_000.0
    offsets = (25_000.0, -61_037.3)
    # 2 s chunks: the uint32 increments alone turn the channels 0.29 and 0.25
    # mrad off the exact mix by a chunk's end (-75.5 and -76.6 dB over it)
    taps, plan, incs = _setup(26, offsets, rate=rate, target_chunk=500_000)
    res = [nco_increment_residual(-o, rate) for o in offsets]  # _setup's sign
    assert all(res)
    rng = np.random.default_rng(8)
    n = plan.chunk_size
    raw = _raw(rng, "pcm_s16le", 6 * n)
    tails = [np.zeros(2 * (L - 1), np.float32)] * 2
    phases = [np.asarray([5 << 40, (1 << 62) - 7], np.int64)] * 2
    for i in range(3):
        chunk = raw[2 * i * n : 2 * (i + 1) * n]
        got = _native(plan, taps, incs, chunk, tails[0], phases[0], "pcm_s16le", order, res)
        want = _conv(plan, taps, incs, chunk, tails[1], phases[1], "pcm_s16le", order, res)
        assert error_db(got[0].numpy(), want[0].numpy()) < -100.0
        assert error_db(got[1].numpy(), want[1].numpy()) < -100.0
        assert torch.equal(got[3], want[3])
        tails = [got[2].numpy(), want[2].numpy()]
        phases = [got[3].numpy(), want[3].numpy()]


def test_native_refuses_wrong_dtype():
    taps, plan, incs = _setup(3, (25_000.0,))
    raw = np.zeros(2 * plan.chunk_size, np.float32)
    with pytest.raises(TypeError, match="pcm_s16le"):
        _native(
            plan, taps, incs, raw, np.zeros(2 * (L - 1), np.float32),
            np.zeros(1, np.int64), "pcm_s16le", "iq",
        )


@pytest.mark.parametrize("order", ["iq", "qi", "iq_inv", "qi_inv"])
@pytest.mark.parametrize("codec", ["pcm_u8", "pcm_s16le", "pcm_f32le"])
def test_io_convert_deinterleave_bit_identical(monkeypatch, codec, order):
    rng = np.random.default_rng(3)
    raw = _raw(rng, codec, 2 * 4099)
    fast = treader.convert_to_complex(raw, codec, order)
    monkeypatch.setattr(tio, "convert_deinterleave", lambda *a, **k: None)
    slow = treader.convert_to_complex(raw, codec, order)
    assert fast.dtype == slow.dtype == np.complex64
    np.testing.assert_array_equal(fast, slow)


@pytest.mark.parametrize("codec", ["pcm_u8", "pcm_s16le", "pcm_f32le"])
def test_io_interleave_encode_bit_identical(monkeypatch, codec):
    rng = np.random.default_rng(4)
    iq = ((rng.standard_normal(5001) + 1j * rng.standard_normal(5001)) * 0.5).astype(np.complex64)
    fast = twriter._encode_iq_raw(iq, codec)
    monkeypatch.setattr(tio, "interleave_encode", lambda *a, **k: None)
    slow = twriter._encode_iq_raw(iq, codec)
    assert fast == slow


def test_io_encode_s16_bit_identical(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    audio = np.clip(rng.standard_normal(48_000) * 0.4, -0.99, 0.99).astype(np.float32)
    paths = []
    for name, patched in (("fast.wav", False), ("slow.wav", True)):
        if patched:
            monkeypatch.setattr(tio, "encode_s16", lambda *a, **k: None)
        w = twriter.AudioWriter(tmp_path / name)
        w.write(audio)
        w.close()
        paths.append(tmp_path / name)
    assert paths[0].read_bytes() == paths[1].read_bytes()
