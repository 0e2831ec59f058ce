"""The per-capture set-up seam (``pipeline/capture.py``): every entry of the
port resolves one capture alike.

The serial pipeline (probe only), burst mode (``HeteroExecutor``, whose
plan is ``hetero._plan``), the multi-capture runner (``plan_captures``)
and the preview take the same sample rate, centre, decimation, taps and
mixer sign from the seam, and name their outputs by its rule; the JAX
package's probe-only run agrees on the fields its result carries.  The
error paths (a raw capture with no rate, no centre, six targets) fail alike
in every entry.
"""

from __future__ import annotations

import sys
from dataclasses import replace

import numpy as np
import pytest

from conftest import write_wav_iq

import iq_to_audio_torch as tpkg
import iq_to_audio_tpu as jpkg
from iq_to_audio_torch.parallel.dp_runner import CaptureJob, plan_captures
from iq_to_audio_torch.pipeline import capture
from iq_to_audio_torch.pipeline.hetero import HeteroExecutor
from iq_to_audio_torch.pipeline.preview import run_preview

CENTER = 145_000_000.0
TARGETS = [CENTER + 25_000.0, CENTER - 40_000.0]
SEAM = ("resolve_capture", "channel_geometry", "decide_mix_sign", "channel_paths")


@pytest.fixture
def seen(monkeypatch):
    """The first result of each seam function, in whichever module called it
    (each entry imports the functions by name)."""
    first: dict = {}
    for name in SEAM:
        real = getattr(capture, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            out = _real(*args, **kwargs)
            first.setdefault(_name, out)
            return out

        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("iq_to_audio_torch") and (
                getattr(mod, name, None) is real
            ):
                monkeypatch.setattr(mod, name, spy)
    return first


@pytest.fixture
def cap_path(tmp_path, nfm_iq):
    return write_wav_iq(tmp_path / f"baseband_{int(CENTER)}Hz_cap.wav", nfm_iq, 250_000)


def _config(path, out, targets=TARGETS, **kw):
    return tpkg.ProcessingConfig(
        in_path=path, target_freq=targets[0], extra_target_freqs=list(targets[1:]),
        output_path=out, device="cpu", chunk_size=32_768, **kw,
    )


def _pipeline(cfg):
    tpkg.ProcessingPipeline(replace(cfg, probe_only=True)).run()


def _hetero(cfg):
    with HeteroExecutor(cpu_workers=0, n_segments=2) as ex:
        ex.run(cfg)


def _dp(cfg):
    job = CaptureJob(
        in_path=cfg.in_path, target_freqs=cfg.all_target_freqs(),
        output_paths=[cfg.output_path], center_freq=cfg.center_freq,
        input_sample_rate=cfg.input_sample_rate,
    )
    return plan_captures([job], dp=1, seq=1, device="cpu").outputs[0]


def _preview(cfg):
    run_preview(cfg, 0.2)


ENTRIES = {"pipeline": _pipeline, "hetero": _hetero, "dp": _dp, "preview": _preview}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_every_entry_resolves_the_capture_alike(cap_path, tmp_path, seen, entry):
    out = tmp_path / "out.wav"
    cfg = _config(cap_path, out)
    names = ENTRIES[entry](cfg) or seen["channel_paths"]
    cap, geo = seen["resolve_capture"], seen["channel_geometry"]

    want = capture.channel_geometry(250_000.0, cfg.bandwidth, cfg.fs_ch_target)
    assert cap.sample_rate == 250_000.0 and cap.center_freq == CENTER
    assert cap.freqs == TARGETS and cap.offsets == [f - CENTER for f in TARGETS]
    assert (geo.decimation, geo.fs_channel) == (want.decimation, want.fs_channel)
    np.testing.assert_array_equal(geo.taps, want.taps)
    # the carrier sits at +25 kHz: the probe's sign is the one that mixes it down
    assert seen["decide_mix_sign"] == 1
    base = tmp_path / ("out_preview.wav" if entry == "preview" else "out.wav")
    assert [str(p) for p in names] == [str(capture.annotate(base, f)) for f in TARGETS]

    jax = jpkg.ProcessingPipeline(
        jpkg.ProcessingConfig(
            in_path=cap_path, target_freq=TARGETS[0], extra_target_freqs=TARGETS[1:],
            probe_only=True,
        )
    ).run()
    assert jax.sample_rate_probe.value == cap.sample_rate
    assert jax.center_freq == cap.center_freq
    assert (jax.decimation, jax.fs_channel) == (geo.decimation, geo.fs_channel)
    assert (jax.target_freq, jax.freq_offset) == (cap.freqs[0], cap.offsets[0])
    assert jax.mix_sign == seen["decide_mix_sign"]


def _raw_capture(tmp_path, nfm_iq):
    path = tmp_path / f"baseband_{int(CENTER)}Hz_cap.cs16"
    pairs = np.column_stack([nfm_iq.real, nfm_iq.imag]) * 32767.0
    np.round(pairs).astype("<i2").tofile(path)
    return path


def _no_center(tmp_path, nfm_iq):
    return write_wav_iq(tmp_path / "capture.wav", nfm_iq, 250_000)


ERRORS = {
    "raw_without_rate": (_raw_capture, TARGETS, "Raw IQ inputs require"),
    "no_center": (_no_center, TARGETS, "Center frequency not supplied"),
    "six_targets": (
        lambda tmp_path, iq: write_wav_iq(tmp_path / f"baseband_{int(CENTER)}Hz_cap.wav", iq, 250_000),
        [CENTER + 10_000.0 * k for k in range(1, 7)],
        "At most five",
    ),
}


@pytest.mark.parametrize("error", list(ERRORS))
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_every_entry_refuses_alike(tmp_path, nfm_iq, entry, error):
    make, targets, match = ERRORS[error]
    cfg = _config(make(tmp_path, nfm_iq), tmp_path / "out.wav", targets=targets)
    with pytest.raises(ValueError, match=match):
        ENTRIES[entry](cfg)
    assert not list(tmp_path.glob("out*.wav"))
