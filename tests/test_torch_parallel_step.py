"""The port's sharded step (``iq_to_audio_torch/parallel/sharded.py``) on
gloo CPU ranks, against the port's single-device step and the JAX
package's sharded step on its 8 virtual devices.

One world of 8 ranks (dp = 2 x seq = 4) runs every case once, in a fixture
shared by the file's tests: NFM, USB with the AGC and AM at 384 kHz over two
chunks, the same continued from a state the JAX step left, the 1-tap
filter, and the flagship geometry over three chunks.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from conftest import error_db, make_nfm_iq

import torch_parallel_ranks as ranks
from iq_to_audio_tpu.ops.ddc import bandpass_kernel as j_bandpass_kernel
from iq_to_audio_tpu.ops.ddc import interleave_kernel as j_interleave_kernel
from iq_to_audio_tpu.parallel.mesh import make_mesh as j_make_mesh
from iq_to_audio_tpu.parallel.sharded import build_sharded_step as j_build_sharded_step
from iq_to_audio_tpu.parallel.sharded import plan_for_mesh as j_plan_for_mesh
from iq_to_audio_torch.convert import sharded_state_from_jax, sharded_state_to_jax
from iq_to_audio_torch.demod import create_decoder
from iq_to_audio_torch.ops.ddc import bandpass_kernel, interleave_kernel
from iq_to_audio_torch.ops.nco import nco_increment_fixed
from iq_to_audio_torch.ops.resample import ResamplePlan, design_resampler_kernel
from iq_to_audio_torch.parallel.launch import run_world
from iq_to_audio_torch.parallel.sharded import plan_for_mesh
from iq_to_audio_torch.pipeline.filters import design_channel_filter
from iq_to_audio_torch.pipeline.step import build_chunk_step

torch.set_num_threads(1)

DP, SEQ = 2, 4
MODES = ["nfm", "usb", "am"]


def _raw_chunks(sample_rate: float, n: int, chunks: int, offset: float) -> list[np.ndarray]:
    iq = make_nfm_iq(sample_rate, (chunks + 1) * n / sample_rate, offset)[: chunks * n]
    raw = np.empty(2 * iq.size, dtype=np.float32)
    raw[0::2], raw[1::2] = iq.real, iq.imag
    raw = (np.clip(raw, -1, 0.999) * 32768).astype("<i2")
    return [raw[k * 2 * n : (k + 1) * 2 * n] for k in range(chunks)]


def _case(mode: str, sample_rate: float, decim: int, target_chunk: int, offsets, chunks: int,
          tone: float, num_taps: int | None = None) -> dict:
    if num_taps == 1:
        taps = np.ones(1)
    else:
        taps = design_channel_filter(sample_rate, 12_500.0, decim)
    ddc_plan = plan_for_mesh(num_taps=len(taps), decimation=decim, seq=SEQ,
                             target_chunk=target_chunk)
    fs_channel = sample_rate / decim
    rs_plan = None if num_taps == 1 else ResamplePlan.create(fs_channel, 48_000.0,
                                                              ddc_plan.out_size)
    incs = [nco_increment_fixed(o, sample_rate) for o in offsets]
    pair = bandpass_kernel(taps, incs)
    rs_offsets = [0] * chunks if rs_plan is None else [
        rs_plan.chunk_offset(k * ddc_plan.out_size) for k in range(chunks)
    ]
    return {
        "mode": mode, "sample_rate": sample_rate, "taps": taps, "ddc_plan": ddc_plan,
        "rs_plan": rs_plan, "incs": incs, "pair": pair,
        "kernel_il": interleave_kernel(pair, "iq"),
        "rs_kernel": None if rs_plan is None else design_resampler_kernel(rs_plan.up, rs_plan.down),
        "alpha": math.exp(-1.0 / (fs_channel * 300e-6)), "fs_channel": fs_channel,
        "raws": _raw_chunks(sample_rate, ddc_plan.chunk_size, chunks, tone),
        "offsets": rs_offsets,
    }


def _jax_sharded(case: dict, state0=None):
    """The JAX package's sharded step over the case's chunks on a 2 x 4 mesh:
    float audio per chunk and the final state, as numpy."""
    mesh = j_make_mesh(DP * SEQ, dp=DP)
    fn, init = j_build_sharded_step(
        mesh, ddc_plan=_jax_plan(case["ddc_plan"]), rs_plan=_jax_rs_plan(case["rs_plan"]),
        num_channels=len(case["incs"]), codec="pcm_s16le", mode=case["mode"],
        deemph_alpha=case["alpha"],
    )
    state = init()
    if state0 is not None:
        specs = jax.tree_util.tree_map(lambda a: a.sharding, state)
        state = jax.tree_util.tree_map(lambda a, s: jax.device_put(a, s), state0, specs)
    incs = jax.device_put(np.asarray(case["incs"], np.uint32), NamedSharding(mesh, P("dp")))
    kernel = jax.device_put(j_interleave_kernel(j_bandpass_kernel(case["taps"], case["incs"]), "iq"),
                            NamedSharding(mesh, P("dp", None, None)))
    rs_k = jax.device_put(
        case["rs_kernel"] if case["rs_kernel"] is not None else np.zeros((1, 1, 1), np.float32),
        NamedSharding(mesh, P()),
    )
    audio = []
    for raw, off in zip(case["raws"], case["offsets"]):
        raw_dev = jax.device_put(raw, NamedSharding(mesh, P("seq")))
        state, out = fn(state, raw_dev, jnp.int32(off), incs, kernel, rs_k)
        audio.append(np.asarray(out))
    return audio, jax.tree_util.tree_map(np.asarray, state)


def _jax_plan(plan):
    from iq_to_audio_tpu.ops.ddc import DDCPlan

    return DDCPlan(num_taps=plan.num_taps, decimation=plan.decimation, chunk_size=plan.chunk_size)


def _jax_rs_plan(plan):
    from iq_to_audio_tpu.ops.resample import ResamplePlan as JResamplePlan

    return None if plan is None else JResamplePlan(up=plan.up, down=plan.down, in_size=plan.in_size)


def _single_device(case: dict) -> list[np.ndarray]:
    """The port's single-device conv step over the same chunks: s16 audio
    as float, per chunk, cut to the chunk's valid count."""
    decoder = create_decoder(case["mode"], deemph_us=300.0, agc_enabled=True)
    decoder.setup(case["fs_channel"])
    ddc_plan, rs_plan = case["ddc_plan"], case["rs_plan"]
    step = build_chunk_step(
        ddc_plan=ddc_plan, rs_plan=rs_plan, ddc_kernel_np=case["pair"],
        rs_kernel_np=case["rs_kernel"], incs_fixed=case["incs"], codec="pcm_s16le",
        iq_order="iq", decoder=decoder, device=torch.device("cpu"), channelizer="conv",
        super_chunks=1,
    )
    state, accs = step.init_state(), step.init_accs()
    cap = step.audio_capacity
    out = []
    for k, (raw, off) in enumerate(zip(case["raws"], case["offsets"])):
        slot = k % step.acc_chunks
        state = step.fn(state, accs, torch.from_numpy(raw), off, slot)
        count = rs_plan.out_count(k * ddc_plan.out_size, ddc_plan.out_size)
        out.append(accs["audio"][:, slot * cap : slot * cap + count].numpy() / 32767.0)
    return out


def _rows(results: list, name: str) -> tuple[list[np.ndarray], dict]:
    """The rows' audio per chunk, stacked to ``(C, cap)``, and the state in
    the JAX layout, from the ranks with seq index 0."""
    lead = sorted((r[name] for r in results if r[name]["shard"] == 0), key=lambda r: r["row"])
    audio = [np.concatenate([r["audio"][k] for r in lead]) for k in range(len(lead[0]["audio"]))]
    state = {key: np.concatenate([r["state"][key] for r in lead]) if key != "fir_tail"
             else lead[0]["state"][key] for key in lead[0]["state"]}
    return audio, state


def _s16(a: np.ndarray) -> np.ndarray:
    return np.round(np.clip(a, -0.99, 0.99) * 32767.0) / 32767.0


@pytest.fixture(scope="module")
def world():
    """Every case through one 8-rank world, plus the JAX references."""
    if len(jax.devices()) < DP * SEQ:
        pytest.skip("needs 8 virtual devices")
    offsets = [5_000.0, -20_000.0, 40_000.0, -60_000.0]
    taps = len(design_channel_filter(384_000.0, 12_500.0, 4))
    # seq * 2 * taps, as the JAX package's test sizes its chunk
    cases = {mode: _case(mode, 384_000.0, 4, SEQ * 2 * taps, offsets, 2, 5_000.0) for mode in MODES}
    cases["one_tap"] = _case("nfm", 384_000.0, 4, 4096, [1_000.0, 0.0], 2, 1_000.0, num_taps=1)
    cases["flagship"] = _case("nfm", 2_500_000.0, 26, 1 << 16,
                              [25_000.0, -40_000.0, 60_000.0, -80_000.0], 3, 25_000.0)
    jax_out = {name: _jax_sharded(case) for name, case in cases.items()}
    # continued runs: chunk 1 from the state the JAX step left after chunk 0
    for mode in ("nfm", "usb"):
        first = {**cases[mode], "raws": cases[mode]["raws"][:1], "offsets": cases[mode]["offsets"][:1]}
        _, state0 = _jax_sharded(first)
        cont = {**cases[mode], "raws": cases[mode]["raws"][1:], "offsets": cases[mode]["offsets"][1:],
                "state0": state0}
        cases[f"{mode}_from_jax"] = cont
        jax_out[f"{mode}_from_jax"] = _jax_sharded(cont, state0)
    results = run_world(ranks.sharded_cases, DP * SEQ, "cpu", (DP, cases), timeout=240)
    return cases, jax_out, results


@pytest.mark.parametrize("mode", MODES)
def test_sharded_matches_single_device(world, mode):
    cases, _, results = world
    got, _ = _rows(results, mode)
    want = _single_device(cases[mode])
    for k, (a, b) in enumerate(zip(got, want)):
        err = error_db(_s16(a[:, : b.shape[1]]), b)
        assert err < -55.0, (mode, k, err)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_matches_jax_sharded(world, mode):
    cases, jax_out, results = world
    got, state = _rows(results, mode)
    want, want_state = jax_out[mode]
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        err = error_db(a, b)
        assert err < -55.0, (mode, k, err)
    assert set(state) == set(want_state)
    np.testing.assert_array_equal(state["phase"], want_state["phase"])
    for key in set(state) - {"phase"}:
        np.testing.assert_allclose(state[key], want_state[key], rtol=1e-3, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("mode", ["nfm", "usb"])
def test_sharded_continues_from_a_jax_state(world, mode):
    """The JAX step's state after chunk 0, cut into the ranks' shares
    (``convert.sharded_state_from_jax``), carries the port's chunk 1 to the
    JAX step's chunk 1."""
    _, jax_out, results = world
    got, state = _rows(results, f"{mode}_from_jax")
    want, want_state = jax_out[f"{mode}_from_jax"]
    err = error_db(got[0], want[0])
    assert err < -55.0, err
    np.testing.assert_array_equal(state["phase"], want_state["phase"])


def test_sharded_state_conversion_round_trip():
    rng = np.random.default_rng(3)
    jstate = {
        "phase": rng.integers(0, 1 << 32, 4, dtype=np.uint64).astype(np.uint32),
        "fir_tail": rng.standard_normal(10).astype(np.float32),
        "deemph_y": rng.standard_normal(4).astype(np.float32),
        "rs_tail": rng.standard_normal((4, 6)).astype(np.float32),
    }
    rows = [sharded_state_from_jax(jstate, dp=2, row=r, captures=1, device="cpu") for r in range(2)]
    assert rows[1]["phase"].dtype == torch.int64 and rows[1]["rs_tail"].shape == (2, 6)
    back = sharded_state_to_jax(rows, captures=1)
    for key, value in jstate.items():
        np.testing.assert_array_equal(back[key], value)
    multi = {**jstate, "fir_tail": rng.standard_normal((2, 10)).astype(np.float32)}
    rows = [sharded_state_from_jax(multi, dp=2, row=r, captures=2, device="cpu") for r in range(2)]
    assert rows[1]["fir_tail"].shape == (10,)
    np.testing.assert_array_equal(sharded_state_to_jax(rows, captures=2)["fir_tail"],
                                  multi["fir_tail"])


def test_sharded_single_tap_filter_carries_empty_tail(world):
    """num_taps == 1: the carried FIR tail is EMPTY on every rank, and the
    second step runs."""
    _, jax_out, results = world
    got, state = _rows(results, "one_tap")
    assert state["fir_tail"].shape == (0,)
    assert all(np.isfinite(a).all() for a in got)
    want, _ = jax_out["one_tap"]
    assert error_db(got[-1], want[-1]) < -55.0


def test_sharded_flagship_geometry(world):
    """2.5 MS/s, decimation 26, the 1601-tap filter, 312/625 with offsets
    that vary chunk to chunk, at dp 2 x seq 4 over three chunks, against
    the port's single-device step and the JAX sharded step."""
    cases, jax_out, results = world
    case = cases["flagship"]
    assert len(case["taps"]) >= 1601
    assert (case["rs_plan"].up, case["rs_plan"].down) == (312, 625)
    assert case["ddc_plan"].out_size % case["rs_plan"].down != 0
    assert len(set(case["offsets"])) > 1
    got, _ = _rows(results, "flagship")
    for k, (a, b) in enumerate(zip(got, _single_device(case))):
        err = error_db(_s16(a[:, : b.shape[1]]), b)
        assert err < -55.0, (k, err)
    for k, (a, b) in enumerate(zip(got, jax_out["flagship"][0])):
        err = error_db(a, b)
        assert err < -55.0, (k, err)


@pytest.mark.parametrize(
    "taps,decim,seq,target",
    [
        (1601, 26, 4, 1 << 17),  # dp 2 x seq 4, NFM and USB+AGC of dryrun_multichip
        (1601, 26, 2, 1 << 17),  # dp 4 x seq 2 with four captures
        (61, 4, 4, 4 * 2 * 61),
        (1, 4, 4, 4096),
    ],
)
def test_plan_for_mesh_matches_jax(taps, decim, seq, target):
    got = plan_for_mesh(num_taps=taps, decimation=decim, seq=seq, target_chunk=target)
    want = j_plan_for_mesh(num_taps=taps, decimation=decim, seq=seq, target_chunk=target)
    assert (got.num_taps, got.decimation, got.chunk_size) == (
        want.num_taps, want.decimation, want.chunk_size)
