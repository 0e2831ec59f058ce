"""The chunk step: scale -> channelizer (DDC) -> demod (NFM, AM, USB/LSB)
-> polyphase resample -> s16 encode, on one device, for one to five
channels, with the stream state carried as a dict of tensors.

Port of the JAX package's ``pipeline/step.py``: audio out, pass-through
(no demodulator: the decimated IQ is the output), the IQ dump beside the
audio, the first-chunk stage snapshots, and the choice among the
channelizers.  PyTorch runs eagerly, so the JAX ``lax.scan`` superstep is a
Python loop over the chunks of one dispatch group and the accumulator slots
are written in place.

Channelizers (``IQ2A_CHANNELIZER`` pins one; :func:`build_chunk_step`):

* ``conv``: the decimating FIR over the raw interleaved stream, as the
  hand-written polyphase FIR
  (:func:`iq_to_audio_torch.ops.poly_fir.poly_fir_il`: the CUDA kernel on
  the card, its plain version on CPU tensors).  The default on a CUDA
  device and the only stage-snapshot path.  The library formulations of
  the same filter (``conv1d``, J-conv, shifted dense matmul) are reference
  functions of :mod:`iq_to_audio_torch.ops.ddc` and no step runs them.
* ``fft``: the overlap-save FFT bank (:mod:`iq_to_audio_torch.ops.osfir`);
  its state carries the ``(2, L-1)`` pair tail.
* ``native``: the C++ phase-split channelizer
  (:mod:`iq_to_audio_torch.ops.native_ddc`), CPU device only; the default
  there when the library builds, else ``fft``.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..demod.base import Decoder
from ..ops.ddc import (
    DDCPlan,
    ddc_apply_fft_il,
    ddc_apply_il,
    ddc_fullrate_stages,
    interleave_kernel,
)
from ..ops.nco import MASK62, device_increment
from ..ops.poly_fir import build_poly_kernel
from ..ops.resample import ResamplePlan, polyphase_resample

LOG = logging.getLogger(__name__)

#: host bytes of one accumulation window's outputs, at most
_ACC_BYTES_BUDGET = 96 << 20

_STAGES_NEED_CONV = (
    "stage snapshots need the conv channelizer "
    "(unset IQ2A_CHANNELIZER or use 'conv' with --plot-stages)"
)


def _device_scale(raw: torch.Tensor, codec: str) -> torch.Tensor:
    """Sample scaling to float32 (ffmpeg-compatible), keeping the stream
    interleaved."""
    if codec == "pcm_u8":
        return (raw.to(torch.float32) - 128.0) * (1.0 / 128.0)
    if codec == "pcm_s16le":
        return raw.to(torch.float32) * (1.0 / 32768.0)
    if codec == "pcm_f32le":
        return raw.to(torch.float32)
    raise ValueError(f"Unsupported codec '{codec}'")


def _deinterleave_pair(f: torch.Tensor, iq_order: str, n: int):
    """Split a scaled interleaved stream into the (re, im) pair with the
    reference IQ-order semantics (``iq``/``qi`` slot order, ``*_inv``
    negates Q).  Cold paths only (first-chunk stage snapshots)."""
    pairs = f.reshape(n, 2)
    if iq_order.startswith("iq"):
        i, q = pairs[:, 0], pairs[:, 1]
    else:
        q, i = pairs[:, 0], pairs[:, 1]
    if iq_order.endswith("_inv"):
        q = -q
    return i, q


def _device_convert(raw: torch.Tensor, codec: str, iq_order: str, n: int):
    """Scale + de-interleave to the float32 (re, im) pair (cold paths)."""
    return _deinterleave_pair(_device_scale(raw, codec), iq_order, n)


def chunk_step(
    state: dict,
    accs: dict,
    raw: torch.Tensor,
    rs_offset: int,
    slot: int,
    incs: torch.Tensor,
    poly_w: torch.Tensor | None,
    rs_kernel: torch.Tensor | None,
    *,
    ddc_plan: DDCPlan,
    rs_plan: ResamplePlan | None,
    decoder: Decoder | None,
    codec: str,
    iq_order: str = "iq",
    pass_through: bool = False,
    dump_iq: bool = False,
    stages: dict | None = None,
    channelizer: str = "conv",
    ddc_kernel: torch.Tensor | None = None,
    ddc_kernel_pair: torch.Tensor | None = None,
    os_plan=None,
    inc_lo: torch.Tensor,
) -> dict:
    """One chunk.  Returns the new state; the outputs of the chunk are
    written in place into slot ``slot`` of the accumulators: the s16 audio
    (clip +-0.99, scale 32767, round half to even — reference
    processing.py:449-452) into ``accs["audio"]`` unless ``pass_through``,
    and the decimated baseband into ``accs["iq_r"]``/``accs["iq_i"]`` at
    ``slot * m`` when ``dump_iq`` or ``pass_through``.

    ``conv`` filters with ``poly_w``; ``ddc_kernel`` is what the other
    channelizers filter with: the complex bank (``fft``) or the reversed
    real lowpass taps (``native``).  ``incs`` and ``inc_lo`` (int64, per
    channel) are the NCO's 62-bit increments per input sample and per
    output sample (:mod:`iq_to_audio_torch.ops.nco`).  A ``stages``
    dict asks for the stage snapshots (conv channelizer only) and is filled
    with them: ``input``/``mixed``/``filtered`` at the input rate and
    ``decimated`` at the channel rate as (re, im) pairs, then the
    demodulator's intermediates.
    """
    n, m = ddc_plan.chunk_size, ddc_plan.out_size
    if channelizer in ("native", "fft") and stages is not None:
        raise ValueError(_STAGES_NEED_CONV)
    if channelizer == "native":
        # consumes the UNSCALED raw chunk (convert fused into the kernel);
        # the carried state is the conv path's interleaved tail
        from ..ops.native_ddc import ddc_apply_native

        yr, yi, fir_tail, phase_next = ddc_apply_native(
            ddc_plan, ddc_kernel, incs, raw, state["fir_tail"], state["phase"], inc_lo,
            codec, iq_order,
        )
    elif channelizer == "fft":
        f = _device_scale(raw, codec)
        yr, yi, fir_tail, phase_next = ddc_apply_fft_il(
            ddc_plan, os_plan, ddc_kernel, f, state["fir_tail"], state["phase"], inc_lo,
            iq_order,
        )
    else:
        f = _device_scale(raw, codec)
        yr, yi, fir_tail, phase_next = ddc_apply_il(
            ddc_plan, poly_w, f, state["fir_tail"], state["phase"], inc_lo
        )
    new_state = {"phase": phase_next, "fir_tail": fir_tail}
    if stages is not None:
        # cold path: materialise the pair and run the full-rate stages off
        # the pair kernel
        xr, xi = _deinterleave_pair(f, iq_order, n)
        tr, ti = _deinterleave_pair(state["fir_tail"], iq_order, ddc_plan.overlap)
        mix_r, mix_i, filt_r, filt_i = ddc_fullrate_stages(
            ddc_plan, ddc_kernel_pair, xr, xi, torch.stack([tr, ti]), state["phase"], incs
        )
        stages["input"] = (xr, xi)
        stages["mixed"] = (mix_r, mix_i)
        stages["filtered"] = (filt_r, filt_i)
        stages["decimated"] = (yr, yi)
    if dump_iq or pass_through:
        accs["iq_r"][:, slot * m : (slot + 1) * m] = yr
        accs["iq_i"][:, slot * m : (slot + 1) * m] = yi
    if pass_through:
        return new_state
    audio_ch, new_state["demod"], inter = decoder.process(state["demod"], yr, yi)
    if rs_plan is None or rs_plan.identity:
        audio48, cap = audio_ch, m
    else:
        audio48, new_state["rs_tail"] = polyphase_resample(
            rs_plan, rs_kernel, audio_ch, state["rs_tail"], rs_offset
        )
        cap = rs_plan.out_capacity
    # the running pre-clip peak is stream state, monotone over the run
    new_state["peak"] = torch.maximum(state["peak"], audio48.abs().amax(dim=-1))
    encoded = torch.round(torch.clamp(audio48, -0.99, 0.99) * 32767.0).to(torch.int16)
    accs["audio"][:, slot * cap : (slot + 1) * cap] = encoded
    if stages is not None:
        stages.update(inter)
    return new_state


@dataclass
class ChunkStep:
    """Host handle for one streaming configuration on one device."""

    ddc_plan: DDCPlan
    rs_plan: ResamplePlan | None
    num_channels: int
    codec: str
    decoder: Decoder | None
    acc_chunks: int
    super_chunks: int
    device: torch.device
    _poly_w: torch.Tensor | None
    _rs_kernel: torch.Tensor | None
    _incs: torch.Tensor  # int64: the NCO's 62-bit increments per input sample
    _inc_lo: torch.Tensor  # ... and per output sample
    iq_order: str = "iq"
    pass_through: bool = False
    dump_iq: bool = False
    channelizer: str = "conv"
    os_plan: object = None
    _ddc_kernel: torch.Tensor | None = None  # see chunk_step
    _ddc_kernel_pair: torch.Tensor | None = None  # stage snapshots only

    @property
    def chunk_size(self) -> int:
        return self.ddc_plan.chunk_size

    @property
    def audio_capacity(self) -> int:
        """Per-chunk audio slot size inside the accumulator."""
        if self.pass_through:
            return 0
        if self.rs_plan is None or self.rs_plan.identity:
            return self.ddc_plan.out_size
        return self.rs_plan.out_capacity

    def init_state(self, start_sample: int = 0) -> dict:
        """Fresh stream state.  The NCO phase at input sample ``n`` is exactly
        ``inc * n mod 2**62``, so a stream may start at any absolute
        ``start_sample``; the other carries start at zero."""
        plan, c, dev = self.ddc_plan, self.num_channels, self.device
        phase0 = [(int(inc) * start_sample) & MASK62 for inc in self._incs.cpu()]
        # fft carries the (2, L-1) pair tail; conv and native the raw-domain
        # interleaved tail, so their checkpoints interchange
        tail_shape = (2, plan.overlap) if self.channelizer == "fft" else (2 * plan.overlap,)
        state = {
            "phase": torch.tensor(phase0, dtype=torch.int64, device=dev),
            "fir_tail": torch.zeros(tail_shape, dtype=torch.float32, device=dev),
        }
        if not self.pass_through:
            state["demod"] = self.decoder.init_state((c,), dev)
            state["peak"] = torch.zeros(c, dtype=torch.float32, device=dev)
            if self.rs_plan is not None and not self.rs_plan.identity:
                state["rs_tail"] = torch.zeros(
                    (c, self.rs_plan.tail_len), dtype=torch.float32, device=dev
                )
        return state

    def init_accs(self) -> dict:
        k, c, dev = self.acc_chunks, self.num_channels, self.device
        accs = {}
        if self.pass_through or self.dump_iq:
            shape = (c, k * self.ddc_plan.out_size)
            accs["iq_r"] = torch.zeros(shape, dtype=torch.float32, device=dev)
            accs["iq_i"] = torch.zeros(shape, dtype=torch.float32, device=dev)
        if not self.pass_through:
            accs["audio"] = torch.zeros(
                (c, k * self.audio_capacity), dtype=torch.int16, device=dev
            )
        return accs

    def _call(self, state, accs, raw, rs_offset, slot, stages=None):
        return chunk_step(
            state, accs, raw, rs_offset, slot, self._incs, self._poly_w, self._rs_kernel,
            ddc_plan=self.ddc_plan, rs_plan=self.rs_plan, decoder=self.decoder,
            codec=self.codec, iq_order=self.iq_order, pass_through=self.pass_through,
            dump_iq=self.dump_iq, stages=stages, channelizer=self.channelizer,
            ddc_kernel=self._ddc_kernel,
            ddc_kernel_pair=self._ddc_kernel_pair if stages is not None else None,
            os_plan=self.os_plan, inc_lo=self._inc_lo,
        )

    def fn(self, state, accs, raw, rs_offset, slot):
        return self._call(state, accs, raw, rs_offset, slot)

    def fn_stages(self, state, accs, raw, rs_offset, slot):
        """:meth:`fn` plus the stage snapshots of the chunk: returns
        ``(state, stages)``.  Needs a step built with ``want_stages``."""
        if self._ddc_kernel_pair is None:
            raise ValueError(_STAGES_NEED_CONV)
        stages: dict = {}
        return self._call(state, accs, raw, rs_offset, slot, stages), stages

    def fn_super(self, state, accs, raw_stack, rs_offset, slot_base):
        """The chunks of one dispatch group, filling slots
        ``slot_base..slot_base+S-1``.  One ``rs_offset`` serves all of them,
        which holds only when the resampler alignment repeats chunk to chunk."""
        rs = self.rs_plan
        if rs is not None and not rs.identity and self.ddc_plan.out_size % rs.down != 0:
            raise ValueError(
                "superstep requires decimated chunk size to be a multiple of the "
                f"resampler 'down' ({self.ddc_plan.out_size} % {rs.down} != 0); "
                "dispatch chunks one at a time with fn() instead"
            )
        for k in range(raw_stack.shape[0]):
            state = self.fn(state, accs, raw_stack[k], rs_offset, slot_base + k)
        return state


def choose_channelizer(
    device: torch.device, *, want_stages: bool, have_taps: bool, pinned: str | None = None
) -> str:
    """Channelizer selection, as the JAX package's ``build_chunk_step`` makes it:
    ``IQ2A_CHANNELIZER`` (or ``pinned``, which wins) names one of ``conv``,
    ``fft``, ``native``; unset, a CUDA device gets ``conv`` and the CPU
    gets ``native`` when the library builds (it needs the real lowpass taps
    and cannot make stage snapshots), then ``fft``, and ``conv`` for a
    stage-snapshot run.  ``native`` on a CUDA device is an error."""
    choice = (pinned or os.environ.get("IQ2A_CHANNELIZER", "")).lower()
    on_cpu = device.type == "cpu"
    if choice == "native" and not on_cpu:
        raise ValueError(
            "IQ2A_CHANNELIZER=native runs on the CPU device only; "
            "use 'conv' or 'fft' on a CUDA device"
        )
    native_ok = False
    if have_taps and not want_stages and (choice == "native" or (choice == "" and on_cpu)):
        from ..ops.native_ddc import available as native_available

        native_ok = native_available()
        if choice == "native" and not native_ok:
            LOG.warning(
                "IQ2A_CHANNELIZER=native requested but the native library "
                "is unavailable; falling back to the FFT bank"
            )
    if choice in ("conv", "fft"):
        return choice
    if native_ok:
        return "native"
    if (on_cpu and not want_stages) or choice == "native":
        return "fft"
    return "conv"


def build_chunk_step(
    *,
    ddc_plan: DDCPlan,
    rs_plan: ResamplePlan | None,
    ddc_kernel_np: np.ndarray,
    rs_kernel_np: np.ndarray | None,
    incs_fixed: list[int],
    codec: str,
    iq_order: str,
    decoder: Decoder | None,
    device: torch.device,
    pass_through: bool = False,
    dump_iq: bool = False,
    est_total_chunks: int | None = None,
    acc_chunks_cap: int | None = None,
    super_chunks: int | None = None,
    want_stages: bool = False,
    taps_np: np.ndarray | None = None,
    channelizer: str | None = None,
    fft_size: int | None = None,
    nco_res: list[int] | None = None,
) -> ChunkStep:
    """Geometry (8-chunk accumulation windows split into dispatch groups,
    as the JAX package sizes them for accelerators) and device constants.
    ``acc_chunks_cap`` bounds the window (checkpoints land on window
    boundaries); ``super_chunks`` pins the dispatch group (1 for a
    stage-snapshot run).  ``taps_np`` (the real lowpass taps) lets the CPU
    choose the native channelizer.  ``channelizer`` pins what
    :func:`choose_channelizer` would read from the environment;
    ``fft_size`` pins the ``fft`` channelizer's FFT size (else the
    overlap-save planner picks it).  ``nco_res`` are the uint32
    increments' residuals
    (:func:`~iq_to_audio_torch.ops.nco.nco_increment_residual`), zero when
    not given: the NCO runs at :func:`~iq_to_audio_torch.ops.nco.device_increment`
    of each pair, as the bandpass taps of ``ddc_kernel_np`` should turn."""
    c = len(incs_fixed)
    pairs = list(zip(incs_fixed, nco_res or [0] * c))
    per_chunk = 0
    if not pass_through:
        cap = (
            ddc_plan.out_size
            if (rs_plan is None or rs_plan.identity)
            else rs_plan.out_capacity
        )
        per_chunk += c * cap * 2
    if pass_through or dump_iq:
        per_chunk += c * ddc_plan.out_size * 8
    acc_chunks = max(1, min(64, _ACC_BYTES_BUDGET // max(per_chunk, 1)))
    if est_total_chunks is not None and est_total_chunks > 0:
        # never allocate more window slots than the capture can fill
        pow2 = 1 << max(0, (est_total_chunks - 1).bit_length())
        acc_chunks = max(1, min(acc_chunks, pow2))
    # each window's deferred drain is backpressure that keeps uploads shallow
    acc_chunks = min(acc_chunks, 8)
    if acc_chunks_cap is not None:
        acc_chunks = max(1, min(acc_chunks, acc_chunks_cap))
    if super_chunks is None:
        if est_total_chunks is not None and est_total_chunks > 0:
            # ~6 dispatch groups per capture
            super_chunks = min(acc_chunks, max(1, -(-est_total_chunks // 6)))
        else:
            # unbounded length: small groups bound the final group's padding
            super_chunks = min(acc_chunks, 2)
    if rs_plan is not None and not rs_plan.identity and ddc_plan.out_size % rs_plan.down != 0:
        super_chunks = 1  # per-chunk rs_offset required (see fn_super)
    super_chunks = max(1, min(super_chunks, acc_chunks))
    acc_chunks = (acc_chunks // super_chunks) * super_chunks
    if est_total_chunks is not None and est_total_chunks > 0:
        padded_total = -(-est_total_chunks // super_chunks) * super_chunks
        acc_chunks = max(super_chunks, min(acc_chunks, padded_total))

    device = torch.device(device)
    channelizer = choose_channelizer(
        device, want_stages=want_stages, have_taps=taps_np is not None, pinned=channelizer
    )

    def dev(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    os_plan = poly_w = ddc_kernel = None
    # the pair kernel feeds only the stage-snapshot path
    pair_kernel = (
        dev(np.asarray(ddc_kernel_np, dtype=np.float32))
        if want_stages and channelizer == "conv"
        else None
    )
    if channelizer == "native":
        # the reversed real lowpass taps; the per-channel bandpass rotation
        # is the separable oscillator inside the kernel, driven by `incs`
        ddc_kernel = dev(np.asarray(taps_np, dtype=np.float32)[::-1])
    elif channelizer == "fft":
        from ..ops.ddc import bank_from_kernel
        from ..ops.osfir import OverlapSavePlan

        os_plan = OverlapSavePlan.for_chunk(
            ddc_plan.num_taps, ddc_plan.decimation, ddc_plan.chunk_size,
            fft_size=fft_size, cpu_tuned=device.type == "cpu",
        )
        ddc_kernel = dev(bank_from_kernel(ddc_kernel_np, os_plan))
    else:
        # IQ order and Q inversion are folded into the interleaved taps
        kernel_il_np = interleave_kernel(ddc_kernel_np, iq_order)
        poly_w = dev(build_poly_kernel(kernel_il_np, 2 * ddc_plan.decimation))
    return ChunkStep(
        ddc_plan=ddc_plan,
        rs_plan=rs_plan,
        num_channels=c,
        codec=codec,
        decoder=decoder,
        acc_chunks=acc_chunks,
        super_chunks=super_chunks,
        device=device,
        _poly_w=poly_w,
        _rs_kernel=(
            dev(np.asarray(rs_kernel_np, dtype=np.float32))
            if rs_kernel_np is not None
            else None
        ),
        _incs=torch.tensor(
            [device_increment(*p) for p in pairs], dtype=torch.int64, device=device
        ),
        _inc_lo=torch.tensor(
            [device_increment(*p, ddc_plan.decimation) for p in pairs], dtype=torch.int64,
            device=device,
        ),
        iq_order=iq_order,
        pass_through=pass_through,
        dump_iq=dump_iq,
        channelizer=channelizer,
        os_plan=os_plan,
        _ddc_kernel=ddc_kernel,
        _ddc_kernel_pair=pair_kernel,
    )
