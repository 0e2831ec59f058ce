"""The port's segmented (burst-mode) processing, held against the JAX
package: the segment plans and lead-ins field for field, the splicers byte
for byte, and segment-vs-serial audio on the CPU at the JAX tests' limits.

Runs on the CPU (``device="cpu"``); JAX runs on its CPU backend.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from conftest import error_db, make_nfm_iq, make_tone_iq

from iq_to_audio_torch import ProcessingConfig, ProcessingPipeline
from iq_to_audio_torch.io.formats import get_format
from iq_to_audio_torch.io.riff import WavStreamWriter
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.ops.resample import ResamplePlan
from iq_to_audio_torch.pipeline import segmented as tseg
from iq_to_audio_torch.pipeline.filters import compute_decimation, design_channel_filter
from iq_to_audio_tpu.io.formats import get_format as jget_format
from iq_to_audio_tpu.pipeline import segmented as jseg

torch.set_num_threads(2)

FS = 250_000.0
CENTER = 145_000_000.0
OFFSET = 25_000.0


def _ratio(sample_rate: float, pass_through: bool = False) -> tuple[int, int, int]:
    decim, fs_ch = compute_decimation(sample_rate, 96_000.0)
    if pass_through:
        return decim, 1, 1
    plan = ResamplePlan.create(fs_ch, 48_000.0, 1)
    return decim, plan.up, plan.down


def _fields(segs) -> list[tuple]:
    return [dataclasses.astuple(s) for s in segs]


# (total samples, sample rate, workers, lead seconds, front split, pass-through):
# the JAX tests' geometries, the clamps, the flagship, pass-through framing
PLANS = [
    (1_234_567, FS, 4, 0.1, 1, False),  # tiles the capture
    (int(0.6 * FS), FS, 8, 0.1, 1, False),  # worker count clamped
    (int(4.0 * FS), FS, 3, 0.25, 1, False),  # segmented-vs-serial plan
    (int(4.0 * FS), FS, 4, 0.05, 1, False),
    (int(4.0 * FS), FS, 4, 0.05, 4, False),  # front split
    (int(1.2 * FS), FS, 4, 0.1, 8, False),  # front split clamped
    (int(4.0 * FS), FS, 4, 0.25, 4, False),  # the executor tests' plan
    (25_000_000, 2_500_000.0, 8, 0.0426, 4, False),  # flagship, burst defaults
    (25_000_000 + 777, 2_500_000.0, 8, 0.5, 4, False),  # ragged tail
    (1_000_003, FS, 5, 0.01, 3, True),  # pass-through: frame = D
    (int(4.0 * FS), FS, 1, 0.25, 4, False),  # one worker: no split
    (100, FS, 4, 0.5, 4, False),  # shorter than one frame
]


@pytest.mark.parametrize("total,rate,workers,warm,front,pt", PLANS)
def test_plan_segments_matches_jax(total, rate, workers, warm, front, pt):
    decim, up, down = _ratio(rate, pt)
    got = tseg.plan_segments(total, rate, decim, up, down, workers, warm_seconds=warm,
                             front_split=front)
    want = jseg.plan_segments(total, rate, decim, up, down, workers, warm_seconds=warm,
                              front_split=front)
    assert _fields(got) == _fields(want)
    assert [(s.read_start, s.read_samples) for s in got] == [
        (s.read_start, s.read_samples) for s in want
    ]
    assert got[-1].start + got[-1].length == total


def test_plan_segments_rejects_empty_capture():
    for mod in (tseg, jseg):
        with pytest.raises(ValueError, match="positive"):
            mod.plan_segments(0, FS, 3, 72, 125, 4)


@pytest.mark.parametrize(
    "mode,agc,fs_ch,taps,rate,deemph",
    [
        ("none", False, 96_153.8, 1601, 2_500_000.0, None),
        ("iq", True, 83_333.3, 101, FS, 300.0),
        ("nfm", True, 96_153.8, 1601, 2_500_000.0, 300.0),
        ("nfm", True, 96_153.8, 1601, 2_500_000.0, 50_000.0),  # ceiling
        ("am", False, 96_153.8, 1601, 2_500_000.0, None),
        ("usb", True, 96_153.8, 1601, 2_500_000.0, None),
        ("lsb", False, 96_153.8, 1601, 2_500_000.0, None),
        ("ssb", True, 83_333.3, 0, FS, 300.0),
        (None, True, 10.0, 10_000, 1_000.0, None),  # the filter-history floor
    ],
)
def test_warm_seconds_for_matches_jax(mode, agc, fs_ch, taps, rate, deemph):
    got = tseg.warm_seconds_for(mode, agc, fs_ch, taps, rate, deemph_us=deemph)
    assert got == jseg.warm_seconds_for(mode, agc, fs_ch, taps, rate, deemph_us=deemph)
    assert 0.0 < got <= tseg.WARM_SECONDS == jseg.WARM_SECONDS


def test_mode_aware_lead_ordering_and_ceiling():
    fs_ch, taps, fs = 96_153.8, 1601, 2_500_000.0
    w_pt = tseg.warm_seconds_for("none", False, fs_ch, taps, fs)
    w_nfm = tseg.warm_seconds_for("nfm", True, fs_ch, taps, fs, deemph_us=300.0)
    w_am = tseg.warm_seconds_for("am", False, fs_ch, taps, fs)
    w_ssb = tseg.warm_seconds_for("usb", True, fs_ch, taps, fs)
    w_ssb_noagc = tseg.warm_seconds_for("lsb", False, fs_ch, taps, fs)
    assert w_pt <= w_nfm <= w_ssb <= tseg.WARM_SECONDS
    assert w_am == w_nfm
    assert w_ssb_noagc < w_ssb
    assert w_pt >= 2 * taps / fs
    w_slow = tseg.warm_seconds_for("nfm", True, fs_ch, taps, fs, deemph_us=50_000.0)
    assert w_nfm < w_slow <= tseg.WARM_SECONDS


def test_plan_segments_front_split_tiles_and_reindexes():
    decim, up, down = _ratio(FS)
    total = int(4.0 * FS)
    base = tseg.plan_segments(total, FS, decim, up, down, 4, warm_seconds=0.05)
    segs = tseg.plan_segments(total, FS, decim, up, down, 4, warm_seconds=0.05, front_split=4)
    assert len(segs) == len(base) + 3
    frame = decim * down
    assert segs[0].start == 0 and segs[0].lead == 0
    for i, s in enumerate(segs):
        assert s.index == i and s.start % frame == 0
        assert s.audio_skip == (s.lead // frame) * up
    for a, b in zip(segs, segs[1:]):
        assert a.start + a.length == b.start
    assert segs[0].length < base[0].length


def _segment_wavs(tmp_path, n_audio, skips, codec="pcm_s16le", channels=1, rate=48_000,
                  raw=False):
    """Seeded segment files of ``n_audio`` frames each (WAV or raw)."""
    rng = np.random.default_rng(11)
    paths = []
    for i, n in enumerate(n_audio):
        if codec == "pcm_s16le":
            data = rng.integers(-32768, 32767, n * channels, endpoint=True, dtype="<i2")
        else:
            data = rng.uniform(-1.2, 1.2, n * channels).astype("<f4")
        p = tmp_path / f"seg{i}.{'raw' if raw else 'wav'}"
        if raw:
            p.write_bytes(data.tobytes())
        else:
            w = WavStreamWriter(p, rate, channels, codec)
            w.write_raw(data.tobytes())
            w.close()
        paths.append(p)
    return paths


def test_splice_audio_matches_jax_bytes(tmp_path):
    skips = [0, 1_234, 5_000, 17]
    paths = _segment_wavs(tmp_path, [9_000, 8_000, 20_000, 17], skips)
    got = tseg.splice_audio(paths, skips, tmp_path / "t.wav")
    want = jseg.splice_audio(paths, skips, tmp_path / "j.wav")
    assert got == want
    assert got[1] == 9_000 + 6_766 + 15_000
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    # nothing but lead-ins: an empty splice and the RMS sentinel
    empty = tseg.splice_audio(paths[3:], [17], tmp_path / "e.wav")
    assert empty == jseg.splice_audio(paths[3:], [17], tmp_path / "je.wav") == (0.0, 0, -200.0)


@pytest.mark.parametrize(
    "container,codec", [("wav", "pcm_f32le"), ("wav", "pcm_s16le"), ("raw", "pcm_s16le")]
)
def test_splice_iq_slices_matches_jax_bytes(tmp_path, container, codec):
    skips = [0, 300, 1_000]
    paths = _segment_wavs(tmp_path, [4_000, 2_000, 1_000], skips, codec=codec, channels=2,
                          rate=83_333, raw=container == "raw")
    rate = 83_333.3
    got = tseg.splice_iq_slices(paths, skips, tmp_path / "t.out", rate, get_format(container, codec))
    want = jseg.splice_iq_slices(paths, skips, tmp_path / "j.out", rate,
                                 jget_format(container, codec))
    assert got == want and got[1] == 4_000 + 1_700
    assert (tmp_path / "t.out").read_bytes() == (tmp_path / "j.out").read_bytes()


def test_splicers_refuse_a_truncated_segment(tmp_path):
    paths = _segment_wavs(tmp_path, [100, 50], [0, 0])
    with pytest.raises(ValueError, match="lead-in"):
        tseg.splice_audio(paths, [0, 51], tmp_path / "a.wav")
    spec = get_format("wav", "pcm_s16le")
    with pytest.raises(ValueError, match="lead-in"):
        tseg.splice_iq_slices(paths, [0, 26], tmp_path / "b.wav", FS, spec)


def _capture(tmp_path, mode, name="cap"):
    seconds = 4.0
    if mode == "nfm":
        iq = make_nfm_iq(FS, seconds, OFFSET)
    else:
        iq = make_tone_iq(FS, seconds, OFFSET + 1_000.0)
    cap = tmp_path / f"baseband_{int(CENTER)}Hz_{name}.wav"
    write_stereo_wav(cap, np.column_stack([iq.real, iq.imag]), int(FS))
    return cap, iq.size


def _config(cls, cap, mode, agc, out, **kw):
    extra = {"device": "cpu"} if cls is ProcessingConfig else {}
    return cls(
        in_path=cap, target_freq=CENTER + OFFSET, demod_mode=mode, agc_enabled=agc,
        output_path=out, mix_sign_override=1, chunk_size=65_536, **extra, **kw,
    )


def _run_segments(pipeline_cls, config_cls, cap, mode, agc, segs, tmp_path, tag):
    paths = []
    for s in segs:
        out = tmp_path / f"{tag}_{s.index}.wav"
        pipeline_cls(
            _config(config_cls, cap, mode, agc, out, input_start_sample=s.read_start,
                    input_num_samples=s.read_samples)
        ).run(None)
        paths.append(out)
    return paths


@pytest.mark.parametrize(
    "mode,agc,lead,limit_db",
    [
        ("nfm", True, 0.25, -70.0),
        # the feedback AGC amplifies float32 summation ulps at its
        # zero-crossing gain spikes: the JAX test's limit
        ("usb", True, 0.25, -60.0),
        ("nfm", True, "auto", -60.0),
        ("usb", True, "auto", -60.0),
    ],
)
def test_segmented_matches_serial(tmp_path, mode, agc, lead, limit_db):
    """The port's segment runs spliced together against the port's serial
    run of the same capture, at the fixed 0.25 s lead and at the
    mode-aware one (the JAX tests' limits)."""
    cap, total = _capture(tmp_path, mode)
    serial_out = tmp_path / "serial.wav"
    ProcessingPipeline(_config(ProcessingConfig, cap, mode, agc, serial_out)).run(None)

    decim, up, down = _ratio(FS)
    if lead == "auto":
        _, fs_ch = compute_decimation(FS, 96_000.0)
        lead = tseg.warm_seconds_for(mode, agc, fs_ch, 0, FS, deemph_us=300.0)
        assert lead < 0.5
    segs = tseg.plan_segments(total, FS, decim, up, down, 3, warm_seconds=lead)
    assert len(segs) == 3
    paths = _run_segments(ProcessingPipeline, ProcessingConfig, cap, mode, agc, segs,
                          tmp_path, "seg")
    spliced = tmp_path / "spliced.wav"
    peak, n, rms_dbfs = tseg.splice_audio(paths, [s.audio_skip for s in segs], spliced)
    assert -60.0 < rms_dbfs < 0.0
    a, sr_a = read_wav(serial_out)
    b, sr_b = read_wav(spliced)
    assert sr_a == sr_b == 48_000 and a.shape == b.shape and n == len(b)
    err = error_db(b[:, 0], a[:, 0])
    assert err < limit_db, f"segmented-vs-serial error {err:.1f} dB"
    assert peak == pytest.approx(float(np.max(np.abs(b))), abs=1.0 / 32000)


def test_spliced_nfm_matches_jax_splice(tmp_path):
    """The same capture and plan through both packages' segment runs and
    splicers: the port's spliced NFM WAV within -70 dB of the JAX one."""
    from iq_to_audio_tpu import ProcessingConfig as JConfig
    from iq_to_audio_tpu import ProcessingPipeline as JPipeline

    cap, total = _capture(tmp_path, "nfm")
    decim, up, down = _ratio(FS)
    segs = tseg.plan_segments(total, FS, decim, up, down, 3, warm_seconds=0.25)
    assert _fields(segs) == _fields(
        jseg.plan_segments(total, FS, decim, up, down, 3, warm_seconds=0.25)
    )
    skips = [s.audio_skip for s in segs]
    t_paths = _run_segments(ProcessingPipeline, ProcessingConfig, cap, "nfm", True, segs,
                            tmp_path, "t")
    j_paths = _run_segments(JPipeline, JConfig, cap, "nfm", True, segs, tmp_path, "j")
    t_peak, t_n, _ = tseg.splice_audio(t_paths, skips, tmp_path / "t.wav")
    j_peak, j_n, _ = jseg.splice_audio(j_paths, skips, tmp_path / "j.wav")
    a, _ = read_wav(tmp_path / "j.wav")
    b, _ = read_wav(tmp_path / "t.wav")
    assert t_n == j_n == a.shape[0] == b.shape[0]
    err = error_db(b[:, 0], a[:, 0])
    assert err < -70.0, f"port-vs-JAX spliced NFM error {err:.1f} dB"
    assert t_peak == pytest.approx(j_peak, abs=2.0 / 32767)


def test_segment_read_window_is_exact(tmp_path):
    """``input_start_sample``/``input_num_samples`` consume exactly the
    requested window: a windowed pass-through run equals the matching slice
    of a full-capture run once the FIR tail has converged."""
    iq = make_tone_iq(FS, 0.4, OFFSET)
    cap = tmp_path / f"baseband_{int(CENTER)}Hz_win.wav"
    write_stereo_wav(cap, np.column_stack([iq.real, iq.imag]), int(FS), codec="pcm_f32le")

    def config(out, **kw):
        return ProcessingConfig(
            in_path=cap, target_freq=CENTER + OFFSET, demod_mode="none", output_path=out,
            mix_sign_override=1, chunk_size=8_192, fs_ch_target=FS, device="cpu", **kw,
        )

    full_out = tmp_path / "full.wav"
    ProcessingPipeline(config(full_out)).run(None)
    lead = len(design_channel_filter(FS, 12_500.0, 1))
    start, num = 40_000, 30_000
    win_out = tmp_path / "win.wav"
    result = ProcessingPipeline(
        config(win_out, input_start_sample=start - lead, input_num_samples=num + lead)
    ).run(None)
    assert result.input_samples == num + lead
    full, _ = read_wav(full_out)
    win, _ = read_wav(win_out)
    assert len(win) == num + lead
    err = error_db(
        win[lead:, 0] + 1j * win[lead:, 1],
        full[start : start + num, 0] + 1j * full[start : start + num, 1],
    )
    assert err < -80.0, f"windowed-vs-full slice error {err:.1f} dB"
