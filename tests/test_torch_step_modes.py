"""The port's chunk step in every mode (audio, IQ dump, pass-through, stage
snapshots) and with every channelizer, against the JAX package's step from
the same mid-stream state (exchanged through ``convert.py``), on the CPU at
a small size: s16 audio within 1 LSB, ``iq_r``/``iq_i`` and each stage
array < -100 dB; the accumulator sizing equal to that of the JAX
package's ``build_chunk_step``."""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import error_db, make_nfm_iq

from iq_to_audio_tpu.demod import create_decoder as j_create_decoder
from iq_to_audio_tpu.pipeline import step as jstep

from iq_to_audio_torch.convert import accs_from_jax, state_from_jax, state_to_jax
from iq_to_audio_torch.demod import create_decoder
from iq_to_audio_torch.ops.ddc import DDCPlan, bandpass_kernel, interleave_kernel
from iq_to_audio_torch.ops.nco import nco_increment_fixed
from iq_to_audio_torch.ops.resample import ResamplePlan, design_resampler_kernel
from iq_to_audio_torch.pipeline import step as tstep
from iq_to_audio_torch.pipeline.filters import compute_decimation, design_channel_filter

torch.set_num_threads(1)

FS = 250_000.0
OFFSETS = (25_000.0, -60_000.0)
HAVE_GXX = shutil.which("g++") is not None


def _geometry(pass_through=False, target=16_384):
    decim, fs_ch = compute_decimation(FS, 96_000.0)
    taps = design_channel_filter(FS, 12_500.0, decim)
    align = 1 if pass_through else ResamplePlan.create(fs_ch, 48_000.0, 1).down
    plan = DDCPlan.create(len(taps), decim, target_chunk=target, out_align=align)
    rs_plan = None if pass_through else ResamplePlan.create(fs_ch, 48_000.0, plan.out_size)
    incs = [nco_increment_fixed(o, FS) for o in OFFSETS]
    return plan, rs_plan, fs_ch, taps, incs


def _build_pair(monkeypatch, *, channelizer, pass_through=False, dump_iq=False,
                want_stages=False, env=(), iq_order="iq"):
    """The JAX step and the port's step for one configuration.  ``env`` picks
    the JAX package's formulation of the conv channelizer; the port reads
    only ``IQ2A_CHANNELIZER`` and runs its one formulation against each."""
    monkeypatch.setenv("IQ2A_CHANNELIZER", channelizer)
    for k in ("IQ2A_CONVJ", "IQ2A_MM", "IQ2A_PALLAS", "IQ2A_ACC", "IQ2A_SUPER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env:
        monkeypatch.setenv(k, v)
    plan, rs_plan, fs_ch, taps, incs = _geometry(pass_through)
    kernel_np = bandpass_kernel(taps, incs)
    rs_kernel = None if rs_plan is None else design_resampler_kernel(rs_plan.up, rs_plan.down)
    jdec = tdec = None
    if not pass_through:
        jdec = j_create_decoder("nfm", deemph_us=300.0, agc_enabled=True)
        tdec = create_decoder("nfm", deemph_us=300.0, agc_enabled=True)
        jdec.setup(fs_ch)
        tdec.setup(fs_ch)
    common = dict(
        ddc_plan=plan, rs_plan=rs_plan, ddc_kernel_np=kernel_np, rs_kernel_np=rs_kernel,
        incs_fixed=incs, codec="pcm_s16le", iq_order=iq_order, pass_through=pass_through,
        dump_iq=dump_iq, est_total_chunks=4, super_chunks=1, want_stages=want_stages,
        taps_np=np.asarray(taps),
    )
    js = jstep.build_chunk_step(decoder=jdec, **common)
    ts = tstep.build_chunk_step(decoder=tdec, device=torch.device("cpu"), **common)
    return js, ts, plan, rs_plan


def _raw_chunks(plan, n_chunks, seed):
    iq = make_nfm_iq(FS, plan.chunk_size * n_chunks / FS, OFFSETS[0], seed=seed)
    iq = iq + 0.4 * make_nfm_iq(FS, plan.chunk_size * n_chunks / FS, OFFSETS[1], seed=seed + 1)
    raw = np.empty(2 * iq.size, np.int16)
    raw[0::2] = np.round(np.clip(iq.real * 0.5, -1, 1) * 32767)
    raw[1::2] = np.round(np.clip(iq.imag * 0.5, -1, 1) * 32767)
    return raw.reshape(n_chunks, 2 * plan.chunk_size)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_both(js, ts, plan, rs_plan, n_chunks=3, stages_on_first=False):
    """Warm the JAX stream one chunk, hand its state and accumulators to the
    port, then run ``n_chunks`` on both."""
    off0 = 0 if rs_plan is None or rs_plan.identity else rs_plan.chunk_offset(0)
    jstate, jaccs = js.init_state(12_345), js.init_accs()
    jstate, jaccs, _ = js.fn(jstate, jaccs, jnp.asarray(_raw_chunks(plan, 1, 9)[0]), off0, 0)
    tstate = state_from_jax(_np_tree(jstate), "cpu")
    taccs = accs_from_jax(_np_tree(jaccs), "cpu")
    assert set(taccs) == set(ts.init_accs())
    for k, v in ts.init_accs().items():
        assert taccs[k].shape == v.shape and taccs[k].dtype == v.dtype, k
    for k, v in ts.init_state().items():
        if k != "demod":
            assert tstate[k].shape == v.shape and tstate[k].dtype == v.dtype, k
    rs_in = plan.out_size
    jstages = tstages = None
    for slot, raw in enumerate(_raw_chunks(plan, n_chunks, 4)):
        off = 0 if rs_plan is None or rs_plan.identity else rs_plan.chunk_offset(rs_in)
        if stages_on_first and slot == 0:
            jstate, jaccs, out = js.fn_stages(jstate, jaccs, jnp.asarray(raw), off, slot)
            jstages = _np_tree(out["stages"])
            tstate, tstages = ts.fn_stages(tstate, taccs, torch.from_numpy(raw), off, slot)
        else:
            jstate, jaccs, _ = js.fn(jstate, jaccs, jnp.asarray(raw), off, slot)
            tstate = ts.fn(tstate, taccs, torch.from_numpy(raw), off, slot)
        rs_in += plan.out_size
    return _np_tree(jstate), _np_tree(jaccs), tstate, taccs, jstages, tstages


def _check_outputs(jstate, jaccs, tstate, taccs, plan, n_chunks=3, iq_db=-100.0):
    m = plan.out_size
    if "audio" in jaccs:
        got = taccs["audio"].numpy().astype(np.int32)
        want = jaccs["audio"].astype(np.int32)
        assert np.abs(got - want).max() <= 1
        assert np.abs(want).max() > 1000
    for key in ("iq_r", "iq_i"):
        if key in jaccs:
            got, want = taccs[key].numpy()[:, : n_chunks * m], jaccs[key][:, : n_chunks * m]
            assert np.abs(want).max() > 0.01
            assert error_db(got, want) < iq_db, key
    back = state_to_jax(tstate)
    assert set(back) == set(jstate)
    np.testing.assert_array_equal(back["phase"], jstate["phase"])
    assert back["fir_tail"].shape == jstate["fir_tail"].shape
    assert error_db(back["fir_tail"], jstate["fir_tail"]) < -100.0


CHANNELIZERS = [
    # the hand kernel's plain version against each JAX formulation of the conv
    ("conv", ()),
    ("conv", (("IQ2A_CONVJ", "0"),)),
    ("conv", (("IQ2A_CONVJ", "1"),)),
    ("conv", (("IQ2A_MM", "1"),)),
    ("fft", ()),
    pytest.param("native", (), marks=pytest.mark.skipif(not HAVE_GXX, reason="needs g++")),
]


@pytest.mark.parametrize("mode", ["audio", "dump_iq", "pass_through"])
@pytest.mark.parametrize("channelizer,env", CHANNELIZERS)
def test_step_mode_matches_jax(monkeypatch, mode, channelizer, env):
    js, ts, plan, rs_plan = _build_pair(
        monkeypatch, channelizer=channelizer, env=env,
        pass_through=mode == "pass_through", dump_iq=mode == "dump_iq",
    )
    assert js.channelizer == ts.channelizer == channelizer
    assert (ts.acc_chunks, ts.super_chunks) == (js.acc_chunks, js.super_chunks)
    assert set(ts.init_accs()) == {
        "audio": {"audio"}, "dump_iq": {"audio", "iq_r", "iq_i"}, "pass_through": {"iq_r", "iq_i"},
    }[mode]
    if mode == "pass_through":
        assert set(ts.init_state()) == {"phase", "fir_tail"} and ts.audio_capacity == 0
    if channelizer == "fft":
        assert ts.init_state()["fir_tail"].shape == (2, plan.overlap)
        assert ts.os_plan == type(ts.os_plan)(**js.os_plan.__dict__)
    jstate, jaccs, tstate, taccs, _, _ = _run_both(js, ts, plan, rs_plan)
    _check_outputs(jstate, jaccs, tstate, taccs, plan)


@pytest.mark.parametrize("iq_order", ["iq", "qi_inv"])
@pytest.mark.parametrize("dump_iq", [False, True])
def test_fn_stages_matches_jax(monkeypatch, iq_order, dump_iq):
    js, ts, plan, rs_plan = _build_pair(
        monkeypatch, channelizer="conv", want_stages=True, dump_iq=dump_iq, iq_order=iq_order
    )
    jstate, jaccs, tstate, taccs, jstages, tstages = _run_both(
        js, ts, plan, rs_plan, stages_on_first=True
    )
    _check_outputs(jstate, jaccs, tstate, taccs, plan)
    assert set(tstages) == set(jstages) >= {"input", "mixed", "filtered", "decimated", "demod"}
    for name, want in jstages.items():
        got = tstages[name]
        if isinstance(want, tuple):
            assert isinstance(got, tuple) and len(got) == 2, name
            for g, w in zip(got, want):
                assert g.shape == w.shape, name
                assert error_db(g.numpy(), w) < -100.0, name
        else:
            assert got.shape == want.shape, name
            assert error_db(got.numpy(), want) < -100.0, name
    # the snapshot chunk wrote the same outputs as a plain step would have
    d = plan.decimation
    assert error_db(tstages["filtered"][0][:, ::d].numpy(), tstages["decimated"][0].numpy()) < -100.0


@pytest.mark.parametrize("channelizer", ["fft", "native"])
def test_stage_snapshots_need_conv(monkeypatch, channelizer):
    if channelizer == "native" and not HAVE_GXX:
        pytest.skip("needs g++")
    # build_chunk_step asked for stages never picks fft/native by default ...
    monkeypatch.delenv("IQ2A_CHANNELIZER", raising=False)
    plan, rs_plan, fs_ch, taps, incs = _geometry()
    dec = create_decoder("nfm", deemph_us=300.0, agc_enabled=True)
    dec.setup(fs_ch)
    common = dict(
        ddc_plan=plan, rs_plan=rs_plan, ddc_kernel_np=bandpass_kernel(taps, incs),
        rs_kernel_np=design_resampler_kernel(rs_plan.up, rs_plan.down), incs_fixed=incs,
        codec="pcm_s16le", iq_order="iq", decoder=dec, device=torch.device("cpu"),
        taps_np=np.asarray(taps),
    )
    assert tstep.build_chunk_step(want_stages=True, **common).channelizer == "conv"
    assert tstep.build_chunk_step(**common).channelizer == ("native" if HAVE_GXX else "fft")
    # ... and a step pinned to one refuses them with the JAX package's words
    step = tstep.build_chunk_step(channelizer=channelizer, **common)
    raw = torch.from_numpy(_raw_chunks(plan, 1, 1)[0])
    with pytest.raises(ValueError, match="stage snapshots need the conv channelizer"):
        step.fn_stages(step.init_state(), step.init_accs(), raw, rs_plan.chunk_offset(0), 0)
    with pytest.raises(ValueError, match="stage snapshots need the conv channelizer"):
        tstep.chunk_step(
            step.init_state(), step.init_accs(), raw, 0, 0, step._incs, None, step._rs_kernel,
            ddc_plan=plan, rs_plan=rs_plan, decoder=dec, codec="pcm_s16le", stages={},
            channelizer=channelizer, ddc_kernel=step._ddc_kernel, os_plan=step.os_plan,
            inc_lo=step._inc_lo,
        )


def test_native_refused_on_cuda_device():
    with pytest.raises(ValueError, match="native runs on the CPU device only"):
        tstep.choose_channelizer(
            torch.device("cuda"), want_stages=False, have_taps=True, pinned="native"
        )
    assert tstep.choose_channelizer(torch.device("cuda"), want_stages=False, have_taps=True) in (
        "conv", "fft"
    )


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize(
    "env", [(), (("IQ2A_MM", "1"),), (("IQ2A_MM", "0"),), (("IQ2A_CONVJ", "1"),), (("IQ2A_CONVJ", "0"),)]
)
def test_conv_channelizer_is_the_hand_kernel_whatever_the_environment(monkeypatch, env, device):
    """The conv channelizer has one formulation, the polyphase tensor of the
    hand kernel: the JAX package's formulation variables select nothing."""
    from iq_to_audio_torch.ops.poly_fir import build_poly_kernel

    monkeypatch.delenv("IQ2A_CHANNELIZER", raising=False)
    for k, v in env:
        monkeypatch.setenv(k, v)
    assert tstep.choose_channelizer(
        torch.device(device), want_stages=device == "cpu", have_taps=True
    ) == "conv"
    plan, rs_plan, fs_ch, taps, incs = _geometry()
    kernel_np = bandpass_kernel(taps, incs)
    dec = create_decoder("nfm", deemph_us=300.0, agc_enabled=True)
    dec.setup(fs_ch)
    step = tstep.build_chunk_step(
        ddc_plan=plan, rs_plan=rs_plan, ddc_kernel_np=kernel_np,
        rs_kernel_np=design_resampler_kernel(rs_plan.up, rs_plan.down), incs_fixed=incs,
        codec="pcm_s16le", iq_order="qi", decoder=dec, device=torch.device("cpu"),
        channelizer="conv",
    )
    assert step.channelizer == "conv" and step._ddc_kernel is None and step.os_plan is None
    want = build_poly_kernel(interleave_kernel(kernel_np, "qi"), 2 * plan.decimation)
    np.testing.assert_array_equal(step._poly_w.numpy(), want)


SIZING = [
    # (pass_through, dump_iq, est_total_chunks, acc_chunks_cap, super_chunks)
    (False, False, 4, None, None), (False, True, 40, None, None), (True, False, 13, None, None),
    (False, False, None, None, None), (False, True, 7, 3, None), (False, False, 9, None, 1),
    (True, False, 100, 5, 2), (False, True, 1, None, None),
]


@pytest.mark.parametrize("pass_through,dump_iq,est,cap,sup", SIZING)
def test_accumulator_sizing_equals_jax_build_chunk_step(monkeypatch, pass_through, dump_iq, est, cap, sup):
    """The port sizes windows and dispatch groups as the JAX package's ``build_chunk_step`` does on
    an accelerator backend, the ``+ c*m*8`` bytes of the IQ accumulators
    included."""
    monkeypatch.setattr(jstep.jax, "default_backend", lambda: "tpu")
    monkeypatch.setenv("IQ2A_CHANNELIZER", "fft")
    for k in ("IQ2A_ACC", "IQ2A_SUPER", "IQ2A_GROUPS", "IQ2A_SUPER_UNBOUNDED", "IQ2A_PALLAS"):
        monkeypatch.delenv(k, raising=False)
    plan, rs_plan, fs_ch, taps, incs = _geometry(pass_through, target=1 << 20)
    jdec = tdec = None
    if not pass_through:
        jdec = j_create_decoder("nfm", deemph_us=300.0, agc_enabled=True)
        tdec = create_decoder("nfm", deemph_us=300.0, agc_enabled=True)
    common = dict(
        ddc_plan=plan, rs_plan=rs_plan, ddc_kernel_np=bandpass_kernel(taps, incs),
        rs_kernel_np=None, incs_fixed=incs, codec="pcm_s16le", iq_order="iq",
        pass_through=pass_through, dump_iq=dump_iq, est_total_chunks=est, acc_chunks_cap=cap,
        super_chunks=sup,
    )
    js = jstep.build_chunk_step(decoder=jdec, **common)
    ts = tstep.build_chunk_step(decoder=tdec, device=torch.device("cpu"), **common)
    assert (ts.acc_chunks, ts.super_chunks) == (js.acc_chunks, js.super_chunks)
    assert ts.audio_capacity == js.audio_capacity
    for name, acc in ts.init_accs().items():
        assert tuple(acc.shape) == tuple(js.init_accs()[name].shape), name
