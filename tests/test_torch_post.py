"""The port's audio post-processing (``iq_to_audio_torch.post``) against the
JAX package's: the same inputs (``make_burst_audio`` of
``tests/test_squelch.py``, numpy seeds) through both, with identical output
bytes as the tolerance, in memory and through the streaming engine; the
digital-decoder registry and the Docker backend with the mocked client of
``tests/test_docker.py``; and the port's ``--audio-post`` and ``digital``
command line against the JAX command line's files and exit codes."""

from __future__ import annotations

import logging
from dataclasses import asdict

import numpy as np
import pytest

from test_docker import make_client
from test_squelch import make_burst_audio

import iq_to_audio_torch.post.squelch as tsq
import iq_to_audio_tpu.post.squelch as jsq
from iq_to_audio_torch import cli as tcli
from iq_to_audio_torch.io.riff import WavStreamWriter
from iq_to_audio_torch.post import digital as tdig
from iq_to_audio_torch.post import docker_backend as tdb
from iq_to_audio_tpu import cli as jcli
from iq_to_audio_tpu.post import digital as jdig
from iq_to_audio_tpu.post import docker_backend as jdb

RATE = 16_000
PKGS = {"jax": (jsq, jdig, jdb, jcli), "torch": (tsq, tdig, tdb, tcli)}

SQUELCH_CASES = {
    "adaptive": dict(method="adaptive"),
    "adaptive-manual": dict(method="adaptive", auto_noise_floor=False, manual_noise_floor_db=-45.0),
    "static": dict(method="static", trim_silence=False),
    "static-hold-fade": dict(method="static", hold_seconds=0.3, fade_seconds=0.05),
    "transient": dict(method="transient", trim_silence=False),
    "transient-trim": dict(method="transient", trim_lead_seconds=0.05, trim_trail_seconds=0.1),
}


def _write(path, frames, rate=RATE, codec="pcm_s16le"):
    frames = np.atleast_2d(np.asarray(frames, np.float32).T).T
    with WavStreamWriter(path, rate, frames.shape[1], codec) as w:
        w.write_float(frames)
    return path


def _result_fields(res, root):
    """A file result with its paths made relative to its run's directory."""
    d = asdict(res)
    d["input_path"] = d["input_path"].relative_to(root)
    d["output_path"] = d["output_path"].relative_to(root)
    return d


# -- apply_squelch -----------------------------------------------------------


@pytest.mark.parametrize("case", sorted(SQUELCH_CASES))
@pytest.mark.parametrize("seed", [3, 11])
def test_apply_squelch_matches_jax(case, seed):
    audio = make_burst_audio(seed=seed)
    kw = SQUELCH_CASES[case]
    got = tsq.apply_squelch(audio, float(RATE), tsq.SquelchConfig(**kw))
    want = jsq.apply_squelch(audio, float(RATE), jsq.SquelchConfig(**kw))
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_apply_squelch_edges_match_jax():
    """Empty, all-quiet and shorter-than-the-window inputs."""
    for audio, kw in (
        (np.zeros(0, np.float32), {}),
        (np.full(RATE, 1e-6, np.float32),
         dict(method="static", auto_noise_floor=False, manual_noise_floor_db=-30.0)),
        (np.full(1000, 0.5, np.float32), {}),
    ):
        got = tsq.apply_squelch(audio, float(RATE), tsq.SquelchConfig(**kw))
        want = jsq.apply_squelch(audio, float(RATE), jsq.SquelchConfig(**kw))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


# -- process_audio_file: in memory and streaming -------------------------------


def _file_pair(tmp_path, audio, kw, *, threshold, codec="pcm_s16le"):
    """The same WAV through each package's process_audio_file; returns the
    two output byte strings and the two results."""
    out = {}
    for tag, (sq, *_rest) in PKGS.items():
        d = tmp_path / f"{tag}-{threshold}"
        d.mkdir()
        p = _write(d / "rec.wav", audio, codec=codec)
        opts = sq.AudioPostOptions(config=sq.SquelchConfig(**kw), stream_threshold_bytes=threshold)
        res = sq.process_audio_file(p, opts)
        out[tag] = (res.output_path.read_bytes(), _result_fields(res, d))
    return out


@pytest.mark.parametrize("case", sorted(SQUELCH_CASES))
def test_process_audio_file_bytes_match_jax(case, tmp_path, monkeypatch):
    """In memory (threshold 10**15) and forced streaming (threshold 1) on a
    small ``_ENV_BLOCK`` grid, set in both modules as TestStreamingSquelch
    sets it: all four output files are the same bytes."""
    for sq in (jsq, tsq):
        monkeypatch.setattr(sq, "_ENV_BLOCK", 2048)
    audio = make_burst_audio(seconds=2.0)
    mem = _file_pair(tmp_path, audio, SQUELCH_CASES[case], threshold=10**15)
    stream = _file_pair(tmp_path, audio, SQUELCH_CASES[case], threshold=1)
    assert mem["torch"] == mem["jax"]
    assert stream["torch"] == stream["jax"]
    assert stream["torch"][0] == mem["torch"][0]


def test_stereo_f32_stream_matches_jax(tmp_path, monkeypatch):
    for sq in (jsq, tsq):
        monkeypatch.setattr(sq, "_ENV_BLOCK", 2048)
    mono = make_burst_audio(seconds=1.5)
    audio = np.stack([mono, np.roll(mono, 500)], axis=1)
    for threshold in (10**15, 1):
        pair = _file_pair(tmp_path, audio, {}, threshold=threshold, codec="pcm_f32le")
        assert pair["torch"] == pair["jax"]


def test_block_bytes_env_routes_both_to_streaming(tmp_path, monkeypatch):
    """``IQ2A_POST_BLOCK_BYTES`` sends a WAV to the streaming engine in both
    packages when no threshold is configured; the bytes agree."""
    called = []
    for tag, sq in (("jax", jsq), ("torch", tsq)):
        monkeypatch.setattr(sq, "_ENV_BLOCK", 2048)
        orig = sq._process_wav_streaming

        def spy(path, options, bytes_in, _orig=orig, _tag=tag):
            called.append(_tag)
            return _orig(path, options, bytes_in)

        monkeypatch.setattr(sq, "_process_wav_streaming", spy)
    monkeypatch.setenv("IQ2A_POST_BLOCK_BYTES", "100")
    pair = _file_pair(tmp_path, make_burst_audio(seconds=0.5), {}, threshold=None)
    assert called == ["jax", "torch"]
    assert pair["torch"] == pair["jax"]


def test_stream_percentile_matches_jax():
    qs = [0.0, 5.0, 20.0, 50.0, 95.0, 100.0]
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 30_000))
        x = rng.uniform(-160.0, 60.0, size=n).astype(np.float32)
        blocks = max(1, n // 777)
        got = tsq._stream_percentile_f32(lambda: iter(np.array_split(x, blocks)), n, qs, -200.0, 800.0)
        want = jsq._stream_percentile_f32(lambda: iter(np.array_split(x, blocks)), n, qs, -200.0, 800.0)
        for q in qs:
            assert got[q].view(np.uint32) == want[q].view(np.uint32)


# -- batch, targets, rerun hygiene ---------------------------------------------


def _batch_dir(root, tag):
    d = root / tag
    d.mkdir()
    for k in range(3):
        _write(d / f"rec{k}.wav", make_burst_audio(seed=k))
    (d / "ignore.txt").write_text("x")
    return d


def test_process_audio_batch_matches_jax(tmp_path):
    summaries = {}
    for tag, (sq, *_rest) in PKGS.items():
        d = _batch_dir(tmp_path, tag)
        opts = sq.AudioPostOptions(config=sq.SquelchConfig())
        targets = sq.gather_audio_targets(d, opts)
        calls = []
        summary = sq.process_audio_batch(
            targets, opts, progress_cb=lambda done, total, p, c=calls: c.append((done, total, p.name))
        )
        summaries[tag] = (
            [t.relative_to(d) for t in targets],
            [_result_fields(r, d) for r in summary.results],
            summary.failed,
            calls,
            {p.name: p.read_bytes() for p in sorted(d.glob("*-cleaned.wav"))},
        )
    assert summaries["torch"] == summaries["jax"]
    assert len(summaries["torch"][4]) == 3


def test_rerun_hygiene_matches_jax(tmp_path, caplog):
    """A second directory pass skips the cleaned outputs in both packages,
    with the same log; an explicit cleaned file is taken as given."""
    seen = {}
    for tag, (sq, *_rest) in PKGS.items():
        d = tmp_path / tag
        d.mkdir()
        p = _write(d / "rec.wav", make_burst_audio())
        opts = sq.AudioPostOptions(config=sq.SquelchConfig())
        assert sq.process_audio_batch(sq.gather_audio_targets(d, opts), opts).processed == 1
        caplog.clear()
        with caplog.at_level(logging.INFO):
            again = sq.gather_audio_targets(d, opts)
        msgs = [r.getMessage().replace(str(d), "<d>") for r in caplog.records
                if "output suffix" in r.getMessage()]
        cleaned = d / "rec-cleaned.wav"
        seen[tag] = (again == [p], msgs, sq.gather_audio_targets(cleaned, opts) == [cleaned])
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] and seen["torch"][1] and seen["torch"][2]


def test_non_wav_skip_and_missing_path_match_jax(tmp_path, caplog, monkeypatch):
    """Without ``soundfile`` a flac is skipped with the same per-file
    warning; a missing path raises FileNotFoundError in both."""
    seen = {}
    for tag, (sq, *_rest) in PKGS.items():
        monkeypatch.setattr(sq, "_soundfile", lambda: None)
        d = tmp_path / tag
        d.mkdir()
        p = _write(d / "rec.wav", make_burst_audio())
        (d / "rec.flac").write_bytes(b"fLaC junk")
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            targets = sq.gather_audio_targets(d, sq.AudioPostOptions(config=sq.SquelchConfig()))
        seen[tag] = (targets == [p], [r.getMessage().replace(str(d), "<d>") for r in caplog.records])
        with pytest.raises(FileNotFoundError):
            sq.gather_audio_targets(d / "nope", sq.AudioPostOptions(config=sq.SquelchConfig()))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] and any("soundfile" in m and "rec.flac" in m for m in seen["torch"][1])


# -- digital decoders and the Docker backend -------------------------------------


def test_decoder_registry_matches_jax():
    assert tdig.DIGITAL_DECODERS == tuple(
        tdig.DigitalDecoder(**{f: getattr(d, f) for f in ("key", "label", "description", "default_command")})
        for d in jdig.DIGITAL_DECODERS
    )
    assert tdig.DEFAULT_DECODER_KEY == jdig.DEFAULT_DECODER_KEY == "dsd-fme"
    for key in tdig.DIGITAL_DECODER_MAP:
        assert tdig.get_decoder(key).default_command == jdig.get_decoder(key).default_command
    with pytest.raises(KeyError, match="Unknown decoder key"):
        tdig.get_decoder("nope")
    assert tdb.DEFAULT_IMAGE == jdb.DEFAULT_IMAGE


def _run_backend(db, tmp_path, *, exit_code=0, logs=(b"line one\n", b"line two\n")):
    """One run_and_stream through the mocked client: (exit code or error
    text, log lines, the client's containers.run kwargs)."""
    client, _ = make_client(exit_code=exit_code, logs=logs)
    backend = db.DockerBackend(config=db.DockerBackendConfig(image=db.DEFAULT_IMAGE), client=client)
    request = db.DockerLaunchRequest(
        command=("dsd-fme", "-i", "x.wav"), audio_dir=tmp_path, decoder_key="dsd-fme"
    )
    lines: list[str] = []
    try:
        outcome = backend.run_and_stream(request, log_callback=lines.append)
    except db.DockerLaunchError as exc:
        outcome = f"{type(exc).__name__}: {exc}"
    _, kwargs = client.containers.run.call_args
    return outcome, lines, kwargs


@pytest.mark.parametrize("exit_code", [0, 3])
def test_backend_command_and_stream_match_jax(exit_code, tmp_path):
    logs = (b"line one\n", b"\xe2\x9c\x93 done\n", b"")
    got = _run_backend(tdb, tmp_path, exit_code=exit_code, logs=logs)
    want = _run_backend(jdb, tmp_path, exit_code=exit_code, logs=logs)
    assert got == want
    assert got[2]["command"] == ["dsd-fme", "-i", "x.wav"]
    assert (got[0] == 0) == (exit_code == 0)


def test_backend_probe_and_image_info_match_jax():
    for db in (jdb, tdb):
        client, _ = make_client()
        client.ping.side_effect = OSError("no socket")
        conn = db.DockerBackend(client=client).probe()
        assert not conn.available
        with pytest.raises(db.DockerConnectionError):
            db.DockerBackend(client=client).ensure_connection()
    infos = []
    for db in (jdb, tdb):
        client, _ = make_client()
        infos.append(db.DockerBackend(client=client).get_image_info().format_status())
    assert infos[0] == infos[1] and "MB" in infos[1]


def _digital_cli(pkg, monkeypatch, argv):
    *_rest, db, cli = PKGS[pkg]
    client, _ = make_client()

    class FakeBackend(db.DockerBackend):
        def __init__(self, *, config=None):
            super().__init__(config=config, client=client)

    monkeypatch.setattr(db, "DockerBackend", FakeBackend)
    rc = cli.main(argv)
    call = client.containers.run.call_args
    return rc, (None if call is None else call[1]["command"])


@pytest.mark.parametrize(
    "extra",
    [["--decoder", "multimon-ng"], ["--", "dsd-fme", "-i", "x.wav"], []],
    ids=["preset", "explicit", "default"],
)
def test_digital_cli_matches_jax(extra, tmp_path, monkeypatch, capsys):
    argv = ["digital", "--audio-dir", str(tmp_path), *extra]
    got = _digital_cli("torch", monkeypatch, argv)
    want = _digital_cli("jax", monkeypatch, argv)
    assert got == want and got[0] == 0
    assert "line one" in capsys.readouterr().out


def test_digital_cli_missing_dir_matches_jax(tmp_path, monkeypatch):
    argv = ["digital", "--audio-dir", str(tmp_path / "missing")]
    assert _digital_cli("torch", monkeypatch, argv) == _digital_cli("jax", monkeypatch, argv) == (1, None)


# -- --audio-post on the command line --------------------------------------------


POST_ARGV = {
    "default": [],
    "static-no-trim": ["--audio-post-mode", "static", "--audio-post-no-trim"],
    "transient-floor": ["--audio-post-mode", "transient", "--audio-post-noise-floor", "-50"],
    "stream": ["--audio-post-stream-mb", "0.001", "--audio-post-suffix=-sq"],
    "overwrite": ["--audio-post-overwrite", "--audio-post-lead", "0.05"],
}


@pytest.mark.parametrize("case", sorted(POST_ARGV))
def test_audio_post_cli_bytes_match_jax(case, tmp_path):
    files = {}
    for tag, (*_rest, cli) in PKGS.items():
        d = _batch_dir(tmp_path, tag)
        rc = cli.main(["--audio-post", str(d), *POST_ARGV[case]])
        files[tag] = (rc, {p.name: p.read_bytes() for p in sorted(d.iterdir())})
    assert files["torch"] == files["jax"]
    assert files["torch"][0] == 0


@pytest.mark.parametrize("case", ["missing", "empty", "failed"])
def test_audio_post_cli_errors_match_jax(case, tmp_path, caplog):
    """A missing path, a directory without audio and a file that does not
    parse: the same exit status (1) and the same error lines."""
    seen = {}
    for tag, (*_rest, cli) in PKGS.items():
        d = tmp_path / tag
        d.mkdir()
        target = d
        if case == "missing":
            target = d / "nope"
        elif case == "failed":
            _write(d / "good.wav", make_burst_audio())
            (d / "bad.wav").write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            rc = cli.main(["--audio-post", str(target)])
        errors = [r.getMessage().replace(str(d), "<d>") for r in caplog.records
                  if r.levelno >= logging.ERROR]
        seen[tag] = (rc, errors, sorted(p.name for p in d.iterdir()))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == 1 and seen["torch"][1]


def test_audio_post_percentile_range_exits_2():
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--audio-post", "d", "--audio-post-noise-percentile", "1.5"])
        assert exc.value.code == 2
