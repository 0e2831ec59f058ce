"""The port's interactive session (``iq_to_audio_torch.interactive``) on the
first-party headless toolkit, against the JAX package's.

``IQ2A_QT=headless`` is set before either package's ``_qt`` is imported, as
``tests/test_interactive_qt.py`` sets it.  Captures come from numpy seeds
(``make_tone_iq``).  Tolerances:

* snapshot, full-capture PSD and the re-render from retained samples on
  ``device="cpu"`` (``torch.fft`` in float32) against the JAX package's host
  numpy (float64): within ``PSD_ATOL_DB`` = 0.2 dB in every bin, the bound
  ``tests/test_torch_analysis.py::test_torch_backend_matches_numpy_and_jax``
  holds ``backend="torch"`` to; frame counts, bin frequencies, waterfall
  times and retained samples exactly;
* configs field by field, plus the port's ``device``;
* the preview, the audio-post page and the confirmed run: identical bytes.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path

import numpy as np
import pytest

os.environ["IQ2A_QT"] = "headless"

from matplotlib.backend_bases import MouseEvent  # noqa: E402

from conftest import make_tone_iq, write_wav_iq  # noqa: E402
from test_docker import make_client  # noqa: E402
from test_squelch import make_burst_audio  # noqa: E402

import iq_to_audio_tpu.interactive.state as jstate  # noqa: E402
import iq_to_audio_tpu.interactive.workers as jworkers  # noqa: E402
from iq_to_audio_torch import cli as tcli  # noqa: E402
from iq_to_audio_torch.interactive import headless_qt  # noqa: E402
from iq_to_audio_torch.interactive import state as tstate  # noqa: E402
from iq_to_audio_torch.interactive import workers as tworkers  # noqa: E402
from iq_to_audio_torch.interactive._qt import HEADLESS, QApplication  # noqa: E402
from iq_to_audio_torch.interactive.app import InteractiveWindow  # noqa: E402
from iq_to_audio_torch.io.formats import resolve_input_format  # noqa: E402
from iq_to_audio_torch.io.riff import WavStreamWriter  # noqa: E402
from iq_to_audio_torch.pipeline.pipeline import ProcessingPipeline  # noqa: E402
from iq_to_audio_torch.pipeline.preview import run_preview  # noqa: E402
from iq_to_audio_torch.post.squelch import gather_audio_targets, process_audio_batch  # noqa: E402
from iq_to_audio_tpu.io.formats import resolve_input_format as jresolve  # noqa: E402

PSD_ATOL_DB = 0.2
FS = 96_000.0
CENTER = 145_000_000.0
TARGET = CENTER + 10_000.0
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def qapp():
    assert HEADLESS
    return QApplication.instance() or QApplication([])


def _capture(tmp_path, tag, seconds=0.3, fs=FS):
    iq = make_tone_iq(fs, seconds, 10_000.0)
    return write_wav_iq(tmp_path / f"baseband_{int(CENTER)}Hz_{tag}.wav", iq, int(fs))


def _loaded(tmp_path, tag, seconds=0.3, base_kwargs=None):
    """A window on the CPU with a capture loaded (the headless pool runs
    the snapshot synchronously)."""
    path = _capture(tmp_path, tag, seconds)
    win = InteractiveWindow(base_kwargs={**CPU, **(base_kwargs or {})})
    win.state.snapshot_seconds = seconds
    win._load_file(path)
    assert win._snapshot is not None
    return win, path


# -- worker functions against the JAX package ---------------------------------


def _assert_snapshots_close(got, want):
    assert got.frames == want.frames
    np.testing.assert_array_equal(got.freqs, want.freqs)
    np.testing.assert_allclose(got.psd_db, want.psd_db, rtol=0, atol=PSD_ATOL_DB)
    np.testing.assert_array_equal(got.waterfall.times, want.waterfall.times)
    np.testing.assert_allclose(got.waterfall.matrix, want.waterfall.matrix, rtol=0, atol=PSD_ATOL_DB)
    np.testing.assert_array_equal(got.retained, want.retained)
    assert got.seconds == want.seconds and got.sample_rate == want.sample_rate


@pytest.mark.parametrize("nfft,max_slices,order", [(4096, 400, "iq"), (8192, 8, "qi")])
def test_gather_snapshot_matches_jax(tmp_path, nfft, max_slices, order):
    path = _capture(tmp_path, "g", seconds=0.5)
    kw = dict(iq_order=order, nfft=nfft, max_slices=max_slices)
    got = tworkers.gather_snapshot(path, resolve_input_format(path, requested=None)[0], FS, 0.4, device="cpu", **kw)
    want = jworkers.gather_snapshot(path, jresolve(path, requested=None)[0], FS, 0.4, **kw)
    _assert_snapshots_close(got, want)
    assert got.waterfall.matrix.shape[0] <= max_slices


def test_compute_full_psd_matches_jax(tmp_path):
    path = _capture(tmp_path, "f", seconds=0.5)
    got = tworkers.compute_full_psd(path, resolve_input_format(path, requested=None)[0], FS, nfft=8192, device="cpu")
    want = jworkers.compute_full_psd(path, jresolve(path, requested=None)[0], FS, nfft=8192)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=PSD_ATOL_DB)


def test_snapshot_from_retained_matches_jax(tmp_path):
    path = _capture(tmp_path, "r", seconds=0.5)
    tsnap = tworkers.gather_snapshot(path, resolve_input_format(path, requested=None)[0], FS, 0.5,
                                     nfft=4096, device="cpu")
    jsnap = jworkers.gather_snapshot(path, jresolve(path, requested=None)[0], FS, 0.5, nfft=4096)
    got = tworkers.snapshot_from_retained(tsnap, nfft=16384, max_slices=50, device="cpu")
    want = jworkers.snapshot_from_retained(jsnap, nfft=16384, max_slices=50)
    _assert_snapshots_close(got, want)
    short = dataclasses.replace(tsnap, retained=tsnap.retained[:100])
    assert tworkers.snapshot_from_retained(short, device="cpu") is None


def test_snapshot_without_device_needs_the_card(tmp_path, monkeypatch):
    """No ``device`` means the card, as everywhere in the port: on a machine
    without one the snapshot raises instead of running on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _capture(tmp_path, "n")
    with pytest.raises(RuntimeError, match="No CUDA device"):
        tworkers.gather_snapshot(path, resolve_input_format(path, requested=None)[0], FS, 0.2, nfft=4096)


# -- session state -----------------------------------------------------------------


BASE = {
    "bandwidth": 25_000.0, "center_freq": None, "deemph_us": 75.0, "agc_enabled": True,
    "chunk_size": 65_536, "filter_block": 8192, "auto_filter_block": False, "iq_order": "qi",
    "probe_only": False, "fft_workers": None, "input_sample_rate": None, "profile_dir": None,
    "checkpoint_secs": 2.0, "resume": False, "center_freq_source": None, "demod_mode": "usb",
    "fs_ch_target": 48_000.0, "mix_sign_override": -1, "input_format": None,
    "input_container": None, "input_format_source": None, "target_freq": 1.0,
    "output_path": Path("ignored.wav"), "dump_iq_path": None, "plot_stages_path": None,
}


@pytest.mark.parametrize("device", ["cpu", None, "cuda:1"])
@pytest.mark.parametrize("override", [None, "raw-cs16"])
def test_build_configs_matches_jax_plus_device(device, override, tmp_path):
    built = []
    for mod, extra in ((jstate, {}), (tstate, {"device": device})):
        st = mod.InteractiveState(base_kwargs={**BASE, **extra})
        st.input_path = tmp_path / "cap.wav"
        st.center_freq, st.center_freq_source = CENTER, "filename"
        st.output_dir = tmp_path / "out"
        st.input_format_override = override
        st.sample_rate_override = 250_000.0
        st.set_demod("lsb")
        for f in (TARGET, TARGET + 20_000.0, TARGET + 0.2):  # the last is a duplicate
            st.add_target(f)
        (cfg,) = st.build_configs()
        built.append(dataclasses.asdict(cfg))
    want, got = built
    assert got.pop("device") == device
    assert want.pop("device") is None
    assert got == want
    assert got["extra_target_freqs"] == [TARGET + 20_000.0]


# -- the window ----------------------------------------------------------------------


def test_window_file_flow(qapp, tmp_path):
    win, path = _loaded(tmp_path, "w")
    try:
        assert win.pages.count() == 3
        assert win.state.sample_rate == FS
        assert win.state.center_freq == CENTER
        assert win.state.center_freq_source == "filename:sdrpp"
        assert win._snapshot_worker._kw["device"] == "cpu"
        assert len(win.ax.lines) >= 1
        lo, hi = win.ax.get_xlim()
        assert lo < CENTER < hi
        assert win.audio_post_page._recent_output_dir == path.parent
        win._show_waterfall()
        assert win.waterfall_window._image is not None
        win.waterfall_window.close()
    finally:
        win.close()


def test_window_snapshot_matches_jax_snapshot(qapp, tmp_path):
    win, path = _loaded(tmp_path, "s", seconds=0.3)
    try:
        nfft = min(win.state.spectrum_nfft, int(0.3 * FS))
        want = jworkers.gather_snapshot(path, jresolve(path, requested=None)[0], FS, 0.3,
                                        nfft=nfft, max_slices=win.state.waterfall_slices)
        _assert_snapshots_close(win._snapshot, want)
    finally:
        win.close()


def _click(win, freq_hz, dx=0.0):
    x, _ = win.ax.transData.transform((freq_hz, -80.0))
    press = MouseEvent("button_press_event", win.canvas, x, 300.0, button=1)
    win.canvas.callbacks.process("button_press_event", press)
    release = MouseEvent("button_release_event", win.canvas, x + dx, 300.0, button=1)
    win.canvas.callbacks.process("button_release_event", release)


@pytest.mark.parametrize("dx,added", [(0.0, True), (40.0, False)], ids=["click", "drag"])
def test_click_to_tune(qapp, tmp_path, dx, added):
    win, _ = _loaded(tmp_path, "k")
    try:
        win.canvas.draw()
        _click(win, TARGET, dx)
        if added:
            assert len(win.state.targets) == 1
            assert abs(win.state.targets[0] - TARGET) < 5_000.0
            assert win.status_panel.run_btn.isEnabled()
        else:
            assert win.state.targets == []
    finally:
        win.close()


def test_span_selection_sets_bandwidth_and_target(qapp, tmp_path):
    win, _ = _loaded(tmp_path, "b")
    try:
        win._span_selected(TARGET, 25_000.0)
        assert win.state.bandwidth == 25_000.0
        assert win.state.targets == [TARGET]
        assert win.channel_panel.bw_spin.value() == 25_000.0
        (cfg,) = win.state.build_configs()
        assert cfg.bandwidth == 25_000.0 and cfg.device == "cpu"
    finally:
        win.close()


def test_fft_size_change_rerenders_on_the_session_device(qapp, tmp_path, monkeypatch):
    win, path = _loaded(tmp_path, "x", seconds=0.5)
    try:
        seen = []
        orig = tworkers.snapshot_from_retained

        def spy(snap, **kw):
            seen.append(kw.get("device"))
            return orig(snap, **kw)

        monkeypatch.setattr(tworkers, "snapshot_from_retained", spy)
        path.unlink()  # the re-render reads the retained samples, not the file
        win.state.spectrum_nfft = 8192
        win._spectrum_settings_changed()
        assert seen == ["cpu"]
        assert win._snapshot.freqs.size == 8192
    finally:
        win.close()


def test_analyze_full_runs_on_the_session_device(qapp, tmp_path, monkeypatch):
    win, path = _loaded(tmp_path, "a", seconds=0.5)
    try:
        seen = []
        orig = tworkers.compute_full_psd

        def spy(*args, **kw):
            seen.append(kw.get("device"))
            return orig(*args, **kw)

        monkeypatch.setattr(tworkers, "compute_full_psd", spy)
        win._analyze_full()
        assert seen == ["cpu"]
        want = jworkers.compute_full_psd(path, jresolve(path, requested=None)[0], FS,
                                         nfft=min(win.state.spectrum_nfft, 1 << 19))
        np.testing.assert_allclose(win._snapshot.psd_db, want[1], rtol=0, atol=PSD_ATOL_DB)
    finally:
        win.close()


@pytest.mark.parametrize("targets", [1, 3])
def test_preview_worker_bytes_match_run_preview(qapp, tmp_path, targets):
    """The window's preview (``PreviewWorker`` on ``device="cpu"``) writes
    the same bytes as the port's ``run_preview`` of the same config."""
    win, path = _loaded(tmp_path, "p", base_kwargs={"chunk_size": 32_768})
    try:
        for k in range(targets):
            win.state.add_target(TARGET + 15_000.0 * k)
        win.targets_panel.refresh()
        win._start_preview()
        assert not win.status_panel.stop_btn.isEnabled()  # back to idle
        previews = sorted(path.parent.glob("*_preview*.wav"))
        assert len(previews) == targets
        (cfg,) = win.state.build_configs()
        assert cfg.device == "cpu"
        direct = tmp_path / "direct"
        run_preview(
            dataclasses.replace(cfg, output_path=direct / f"audio_{int(TARGET)}_48k.wav"),
            max(win.state.snapshot_seconds, 2.0),
        )
        assert [p.name for p in sorted(direct.iterdir())] == [p.name for p in previews]
        for p in previews:
            assert (direct / p.name).read_bytes() == p.read_bytes()
    finally:
        win.close()


def test_audio_post_page_bytes_match_batch(qapp, tmp_path):
    fs = 48_000
    dirs = {}
    for tag in ("page", "api"):
        d = tmp_path / tag
        d.mkdir()
        for seed, name in ((3, "one.wav"), (4, "two.wav")):
            with WavStreamWriter(d / name, fs, 1, "pcm_s16le") as w:
                w.write_float(make_burst_audio(sample_rate=fs, seconds=1.0, seed=seed))
        dirs[tag] = d
    win = InteractiveWindow(base_kwargs=CPU)
    try:
        page = win.audio_post_page
        page._set_path(dirs["page"])
        statuses: list[str] = []
        page.status.connect(statuses.append)
        page._run()
        assert page.table.rowCount() == 2
        assert any("complete" in s for s in statuses)
        opts = page._options()
        summary = process_audio_batch(gather_audio_targets(dirs["api"], opts), opts)
        assert summary.processed == 2
        for name in ("one-cleaned.wav", "two-cleaned.wav"):
            assert (dirs["page"] / name).read_bytes() == (dirs["api"] / name).read_bytes()
    finally:
        win.close()


def test_digital_page_launches_with_mock_backend(qapp, tmp_path, monkeypatch):
    from iq_to_audio_torch.post import docker_backend as db

    client, _ = make_client(logs=(b"decoding\n",))
    win = InteractiveWindow(base_kwargs=CPU)
    try:
        page = win.digital_post_page
        page._dir = tmp_path
        monkeypatch.setattr(page, "_backend", lambda: db.DockerBackend(client=client))
        page._launch()
        log = page._console.log_view.toPlainText()
        assert "decoding" in log and "exited with status 0" in log
        _, kwargs = client.containers.run.call_args
        assert kwargs["command"][0] == "dsd-fme"
    finally:
        win.close()


# -- Docker stop and cancel (the cases of TestDockerStop) ------------------------------


class _FakeBackend:
    def __init__(self, script):
        self.script = script
        self.killed: list[str] = []
        self.launched = 0

    def run_and_stream(self, request, log_callback=None, on_container=None):
        self.launched += 1
        return self.script(on_container, log_callback)

    def kill_container(self, cid):
        self.killed.append(cid)


def _handoff(on_container, log_callback):
    on_container("cid-123")
    log_callback("line")
    return 0


@pytest.mark.parametrize("case", ["handoff", "before-start", "racing", "factory"])
def test_docker_stop(case):
    failures: list[str] = []
    if case == "factory":
        def bad_factory():
            raise RuntimeError("engine unreachable")

        worker = tworkers.DockerLaunchWorker(bad_factory, request=None)
        worker.signals.failed.connect(failures.append)
        worker.run()
        assert failures and "engine unreachable" in failures[0]
        return
    if case == "racing":
        def script(on_container, log_callback):
            worker.cancel()  # Stop lands while the engine is starting
            on_container("cid-9")
            raise RuntimeError("killed mid-stream")

        backend = _FakeBackend(script)
    else:
        backend = _FakeBackend(_handoff)
    worker = tworkers.DockerLaunchWorker(backend, request=None)
    worker.signals.failed.connect(failures.append)
    if case == "before-start":
        worker.cancel()
    worker.run()
    assert failures == []
    if case == "handoff":
        assert worker._container_id == "cid-123"
        worker.cancel()
        assert backend.killed == ["cid-123"]
    elif case == "before-start":
        assert backend.launched == 0
    else:
        assert backend.killed == ["cid-9"]


# -- the command line's GUI --------------------------------------------------------------


def _confirming_exec(freqs, seen):
    """A headless ``QApplication.exec`` that drives the shown window: load
    the capture (the window's single-shot timer), set the targets through
    the targets panel, then Confirm & Run."""

    def _exec(self, max_seconds: float = 60.0):
        QApplication.processEvents()
        win = [w for w in QApplication._shown if isinstance(w, InteractiveWindow)][-1]
        seen["snapshot"] = win._snapshot
        seen["device"] = win._device
        win.targets_panel._clear()
        for f in freqs:
            win.state.add_target(f)
        win.targets_panel.refresh()
        win.targets_panel.changed.emit()
        win._confirm_run()
        return 0

    return _exec


def test_interactive_cli_runs_confirmed_config(tmp_path, monkeypatch, capsys):
    path = _capture(tmp_path, "cli", seconds=0.3)
    seen: dict = {}
    monkeypatch.setattr(headless_qt.QApplication, "exec", _confirming_exec([TARGET], seen))
    rc = tcli.main(["--interactive", "--device", "cpu", "--in", str(path), "--chunk", "32768",
                    "--interactive-seconds", "0.25", "--preview", "1"])
    assert rc == 0
    assert seen["device"] == "cpu" and seen["snapshot"] is not None
    assert "Audio peak level" in capsys.readouterr().out
    out = path.with_name(f"audio_{int(TARGET)}_48k.wav")
    assert not list(tmp_path.glob("*_preview.wav"))  # --preview is ignored in GUI mode
    api = tmp_path / "api" / out.name
    from iq_to_audio_torch.pipeline.config import ProcessingConfig

    ProcessingPipeline(ProcessingConfig(
        in_path=path, target_freq=TARGET, center_freq=CENTER, center_freq_source="filename:sdrpp",
        output_path=api, chunk_size=32_768, device="cpu",
    )).run()
    assert out.read_bytes() == api.read_bytes()


@pytest.mark.parametrize(
    "argv,device",
    [(["--device", "cpu"], "cpu"), ([], None), (["--device", "cuda"], "cuda")],
    ids=["cpu", "default", "cuda"],
)
def test_gui_session_configs_carry_the_device(argv, device, tmp_path, monkeypatch):
    """``--device cpu`` builds cpu configs; without ``--device`` (no
    ``--cli``: the GUI is the default) the configs are the card's."""
    path = _capture(tmp_path, "dev")
    seen: dict = {}
    ran = []
    monkeypatch.setattr(headless_qt.QApplication, "exec", _confirming_exec([TARGET, TARGET + 20_000.0], seen))
    monkeypatch.setattr(tcli, "_run_configs", lambda args, configs, sink: ran.extend(configs) or 0)
    assert tcli.main(["--in", str(path), "--interactive-seconds", "0.25", *argv]) == 0
    (cfg,) = ran
    assert cfg.device == (device or "cuda")
    assert cfg.all_target_freqs() == [TARGET, TARGET + 20_000.0]


def test_gui_refused_without_headless_request_matches_jax(tmp_path, monkeypatch, caplog):
    """No ``--cli`` and ``IQ2A_QT`` not ``headless``: the JAX command line's
    exit status and message."""
    from iq_to_audio_tpu import cli as jcli

    path = _capture(tmp_path, "no")
    monkeypatch.delenv("IQ2A_QT", raising=False)
    seen = []
    for cli in (jcli, tcli):
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            rc = cli.main(["--in", str(path), "--ft", str(TARGET), "--device", "cpu"]
                          if cli is tcli else ["--in", str(path), "--ft", str(TARGET)])
        seen.append((rc, [r.getMessage() for r in caplog.records if r.levelno >= logging.ERROR]))
    assert seen[0] == seen[1]
    assert seen[1][0] == 1 and "IQ2A_QT=headless" in seen[1][1][0]
    assert not list(tmp_path.glob("audio_*"))
