"""The port's spectral analysis against the JAX package's: the numpy
backend bit for bit, the ``torch`` and ``matmul`` backends within the
tolerances the JAX package's own tests give its device backends; and that
every analysis entry point runs on the card unless the CPU is asked for."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import make_nfm_iq, make_tone_iq

from iq_to_audio_tpu.analysis import spectrum as jspec
from iq_to_audio_torch.analysis import spectrum as tspec
from iq_to_audio_torch.analysis import WaterfallResult, compute_psd, streaming_waterfall

torch.set_num_threads(1)

FS = 48_000.0


def _blocks(iq, size):
    return [iq[i : i + size] for i in range(0, iq.size, size)] + [None]


@pytest.mark.parametrize("nfft", [1024, 4096, 1 << 14])
def test_compute_psd_numpy_bit_identical(nfft):
    iq = make_tone_iq(FS, 0.2, 5_000.0)
    f_j, p_j = jspec.compute_psd(iq, FS, nfft=nfft)
    f_t, p_t = compute_psd(iq, FS, nfft=nfft, backend="numpy")
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(p_t, p_j)


@pytest.mark.parametrize("hop", [None, 300])
def test_streaming_waterfall_numpy_bit_identical(hop):
    iq = make_nfm_iq(FS, 1.0, 5_000.0)
    want = jspec.streaming_waterfall(_blocks(iq, 5_000), FS, nfft=1024, hop=hop, max_slices=50)
    got = streaming_waterfall(
        _blocks(iq, 5_000), FS, nfft=1024, hop=hop, max_slices=50, backend="numpy"
    )
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert isinstance(got[2], WaterfallResult) and got[3] == want[3]
    np.testing.assert_array_equal(got[2].times, want[2].times)
    np.testing.assert_array_equal(got[2].matrix, want[2].matrix)
    assert got[2].matrix.shape[0] <= 50


def test_torch_backend_matches_numpy_and_jax():
    iq = make_tone_iq(FS, 0.2, 5_000.0)
    f1, p1 = compute_psd(iq, FS, nfft=4096, backend="numpy")
    f2, p2 = compute_psd(iq, FS, nfft=4096, backend="torch", device="cpu")
    np.testing.assert_allclose(f1, f2)
    np.testing.assert_allclose(p1, p2, atol=0.2)  # f32 vs f64 FFT
    _, pj = jspec.compute_psd(iq, FS, nfft=4096, backend="jax")
    hot = p1 > p1.max() - 80.0
    np.testing.assert_allclose(p2[hot], pj[hot], atol=0.2)


def test_matmul_backend_matches_numpy():
    iq = make_tone_iq(FS, 0.2, 5_000.0)
    f1, p1 = compute_psd(iq, FS, nfft=4096, backend="numpy")
    f2, p2 = compute_psd(iq, FS, nfft=4096, backend="matmul", device="cpu")
    np.testing.assert_allclose(f1, f2)
    # compare where the spectrum carries energy; deep-floor bins are
    # dominated by f32 rounding of near-zero power
    hot = p1 > p1.max() - 80.0
    assert hot.sum() > 100
    np.testing.assert_allclose(p1[hot], p2[hot], atol=0.3)
    assert f2[np.argmax(p2)] == f1[np.argmax(p1)]
    _, pj = jspec.compute_psd(iq, FS, nfft=4096, backend="matmul")
    np.testing.assert_allclose(p2[hot], pj[hot], atol=0.3)


def test_matmul_backend_large_nfft_falls_back():
    """Above its cap the matmul backend is refused: it never drops to the
    host FFT behind the caller's back.  At the cap it runs."""
    iq = make_tone_iq(FS, 0.4, 5_000.0)
    for device in ("cpu", None):
        with pytest.raises(ValueError, match="stops at nfft=4096"):
            compute_psd(iq, FS, nfft=1 << 14, backend="matmul", device=device)
    with pytest.raises(ValueError, match="stops at nfft=4096"):
        streaming_waterfall(_blocks(iq, 20_000), FS, nfft=8192, backend="matmul", device="cpu")
    _, p1 = compute_psd(iq, FS, nfft=4096, backend="numpy")
    _, p2 = compute_psd(iq, FS, nfft=4096, backend="matmul", device="cpu")
    hot = p1 > p1.max() - 80.0
    np.testing.assert_allclose(p1[hot], p2[hot], atol=0.3)


@pytest.mark.parametrize("backend", ["torch", "matmul"])
def test_waterfall_device_backends_match_numpy(backend):
    iq = make_nfm_iq(FS, 0.5, 5_000.0)
    want = streaming_waterfall(_blocks(iq, 6_000), FS, nfft=1024, max_slices=40, backend="numpy")
    got = streaming_waterfall(
        _blocks(iq, 6_000), FS, nfft=1024, max_slices=40, backend=backend, device="cpu"
    )
    assert got[3] == want[3]
    hot = want[1] > want[1].max() - 70.0
    np.testing.assert_allclose(got[1][hot], want[1][hot], atol=0.3)
    np.testing.assert_array_equal(got[2].times, want[2].times)


def test_backend_names_and_device_default():
    iq = make_tone_iq(FS, 0.1, 5_000.0)
    with pytest.raises(ValueError, match='"torch"'):
        compute_psd(iq, FS, nfft=1024, backend="jax")
    with pytest.raises(ValueError, match="Unknown FFT backend"):
        compute_psd(iq, FS, nfft=1024, backend="fftw")
    with pytest.raises(ValueError):
        compute_psd(np.empty(0, np.complex64), FS)
    with pytest.raises(ValueError, match="enough samples"):
        streaming_waterfall([iq[:100]], FS, nfft=1024)


needs_no_card = pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")


@needs_no_card
@pytest.mark.parametrize("backend", [None, "torch", "matmul"])
@pytest.mark.parametrize("entry", ["compute_psd", "streaming_waterfall"])
def test_analysis_runs_on_the_card_unless_cpu_is_asked_for(entry, backend):
    """With no backend and no device named the analysis asks for the card and,
    without one, raises the pipeline's message; it never carries on on the
    host.  ``device="cpu"`` and ``backend="numpy"`` are the explicit requests."""
    iq = make_nfm_iq(FS, 0.2, 5_000.0)
    kw = {} if backend is None else {"backend": backend}

    def call(**more):
        if entry == "compute_psd":
            return compute_psd(iq, FS, nfft=1024, **kw, **more)[1]
        return streaming_waterfall(_blocks(iq, 4_000), FS, nfft=1024, **kw, **more)[1]

    with pytest.raises(RuntimeError, match="No CUDA device is available; pass device='cpu'"):
        call()
    with pytest.raises(RuntimeError, match="No CUDA device"):
        call(device="cuda")
    got = call(device="cpu")
    if entry == "compute_psd":
        want = compute_psd(iq, FS, nfft=1024, backend="numpy")[1]
    else:
        want = streaming_waterfall(_blocks(iq, 4_000), FS, nfft=1024, backend="numpy")[1]
    hot = want > want.max() - 70.0
    np.testing.assert_allclose(got[hot], want[hot], atol=0.3)


@needs_no_card
@pytest.mark.parametrize("entry", ["plot_psd", "save_stage_psd", "save_capture_spectrum"])
def test_plots_run_on_the_card_unless_cpu_is_asked_for(tmp_path, entry):
    pytest.importorskip("matplotlib")
    from matplotlib.figure import Figure

    from iq_to_audio_torch.analysis import visualize
    from iq_to_audio_torch.io.formats import resolve_input_format
    from iq_to_audio_torch.io.writer import write_stereo_wav

    iq = make_nfm_iq(FS, 0.5, 5_000.0)
    out = tmp_path / "plot.png"

    def call(**kw):
        if entry == "plot_psd":
            visualize.plot_psd(Figure().subplots(), iq, FS, "input", **kw)
            out.write_bytes(b"x")
        elif entry == "save_stage_psd":
            visualize.save_stage_psd({"input": (iq, FS), "audio": (iq.real, FS)}, out, **kw)
        else:
            cap = tmp_path / "cap.wav"
            write_stereo_wav(cap, np.column_stack([iq.real, iq.imag]) * 0.6, int(FS))
            spec, _ = resolve_input_format(cap, requested=None)
            visualize.save_capture_spectrum(
                cap, out, spec=spec, sample_rate=FS, seconds=0.4, nfft=1024, **kw
            )

    with pytest.raises(RuntimeError, match="No CUDA device"):
        call()
    assert not out.exists()
    call(device="cpu")
    assert out.stat().st_size > 0


def test_matmul_backend_keeps_the_tf32_setting():
    iq = make_tone_iq(FS, 0.1, 5_000.0)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        compute_psd(iq, FS, nfft=1024, backend="matmul", device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert (1024, "cpu") in tspec._dft_cache
