"""The chunk step: scale -> polyphase-FIR DDC -> demod (NFM, AM, USB/LSB)
-> polyphase resample -> s16 encode, on one device, for one to five
channels, with the stream state carried as a dict of tensors.

Port of the JAX package's ``pipeline/step.py`` (audio out; no pass-through,
no IQ dump, no stage snapshots).  PyTorch runs eagerly, so
the JAX ``lax.scan`` superstep is a Python loop over the chunks of one
dispatch group and the accumulator slot is written in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..demod.base import Decoder
from ..ops.ddc import MASK32, DDCPlan, ddc_apply_il, interleave_kernel
from ..ops.poly_fir import build_poly_kernel
from ..ops.resample import ResamplePlan, polyphase_resample

#: host bytes of one accumulation window's s16 audio, at most
_ACC_BYTES_BUDGET = 96 << 20


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


def chunk_step(
    state: dict,
    accs: dict,
    raw: torch.Tensor,
    rs_offset: int,
    slot: int,
    incs: torch.Tensor,
    poly_w: torch.Tensor,
    rs_kernel: torch.Tensor | None,
    *,
    ddc_plan: DDCPlan,
    rs_plan: ResamplePlan | None,
    decoder: Decoder,
    codec: str,
) -> dict:
    """One chunk.  Returns the new state; the s16 audio of the chunk is
    written in place into slot ``slot`` of ``accs["audio"]`` (clip +-0.99,
    scale 32767, round half to even — reference processing.py:449-452)."""
    m = ddc_plan.out_size
    inc_lo = (incs * ddc_plan.decimation) & MASK32  # exact mod 2**32
    f = _device_scale(raw, codec)
    yr, yi, fir_tail, phase_next = ddc_apply_il(
        ddc_plan, poly_w, f, state["fir_tail"], state["phase"], inc_lo
    )
    audio_ch, demod_state, _ = decoder.process(state["demod"], yr, yi)
    new_state = {"phase": phase_next, "fir_tail": fir_tail, "demod": demod_state}
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
    return new_state


@dataclass
class ChunkStep:
    """Host handle for one streaming configuration on one device."""

    ddc_plan: DDCPlan
    rs_plan: ResamplePlan | None
    num_channels: int
    codec: str
    decoder: Decoder
    acc_chunks: int
    super_chunks: int
    device: torch.device
    _poly_w: torch.Tensor
    _rs_kernel: torch.Tensor | None
    _incs: torch.Tensor  # int64 holding uint32 increments

    @property
    def chunk_size(self) -> int:
        return self.ddc_plan.chunk_size

    @property
    def audio_capacity(self) -> int:
        """Per-chunk audio slot size inside the accumulator."""
        if self.rs_plan is None or self.rs_plan.identity:
            return self.ddc_plan.out_size
        return self.rs_plan.out_capacity

    def init_state(self, start_sample: int = 0) -> dict:
        """Fresh stream state.  The NCO phase at input sample ``n`` is exactly
        ``inc * n mod 2**32``, so a stream may start at any absolute
        ``start_sample``; the other carries start at zero."""
        plan, c, dev = self.ddc_plan, self.num_channels, self.device
        incs_np = self._incs.cpu().numpy().astype(np.uint64)
        phase0 = (incs_np * np.uint64(start_sample % (1 << 32))) % np.uint64(1 << 32)
        state = {
            "phase": torch.from_numpy(phase0.astype(np.int64)).to(dev),
            # the raw-domain interleaved tail of the polyphase FIR
            "fir_tail": torch.zeros(2 * plan.overlap, dtype=torch.float32, device=dev),
            "demod": self.decoder.init_state((c,), dev),
            "peak": torch.zeros(c, dtype=torch.float32, device=dev),
        }
        if self.rs_plan is not None and not self.rs_plan.identity:
            state["rs_tail"] = torch.zeros(
                (c, self.rs_plan.tail_len), dtype=torch.float32, device=dev
            )
        return state

    def init_accs(self) -> dict:
        k, c = self.acc_chunks, self.num_channels
        audio = torch.zeros((c, k * self.audio_capacity), dtype=torch.int16, device=self.device)
        return {"audio": audio}

    def fn(self, state, accs, raw, rs_offset, slot):
        return chunk_step(
            state, accs, raw, rs_offset, slot, self._incs, self._poly_w, self._rs_kernel,
            ddc_plan=self.ddc_plan, rs_plan=self.rs_plan, decoder=self.decoder,
            codec=self.codec,
        )

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


def build_chunk_step(
    *,
    ddc_plan: DDCPlan,
    rs_plan: ResamplePlan | None,
    ddc_kernel_np: np.ndarray,
    rs_kernel_np: np.ndarray | None,
    incs_fixed: list[int],
    codec: str,
    iq_order: str,
    decoder: Decoder,
    device: torch.device,
    est_total_chunks: int | None = None,
    acc_chunks_cap: int | None = None,
) -> ChunkStep:
    """Geometry (8-chunk accumulation windows split into dispatch groups,
    as the JAX package sizes them for accelerators) and device constants.
    ``acc_chunks_cap`` bounds the window (checkpoints land on window
    boundaries).  The channelizer is always the polyphase FIR."""
    c = len(incs_fixed)
    cap = (
        ddc_plan.out_size
        if (rs_plan is None or rs_plan.identity)
        else rs_plan.out_capacity
    )
    acc_chunks = max(1, min(64, _ACC_BYTES_BUDGET // max(c * cap * 2, 1)))
    if est_total_chunks is not None and est_total_chunks > 0:
        # never allocate more window slots than the capture can fill
        pow2 = 1 << max(0, (est_total_chunks - 1).bit_length())
        acc_chunks = max(1, min(acc_chunks, pow2))
    # each window's deferred drain is backpressure that keeps uploads shallow
    acc_chunks = min(acc_chunks, 8)
    if acc_chunks_cap is not None:
        acc_chunks = max(1, min(acc_chunks, acc_chunks_cap))
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

    kernel_il = interleave_kernel(ddc_kernel_np, iq_order)
    poly_np = build_poly_kernel(kernel_il, 2 * ddc_plan.decimation)
    return ChunkStep(
        ddc_plan=ddc_plan,
        rs_plan=rs_plan,
        num_channels=c,
        codec=codec,
        decoder=decoder,
        acc_chunks=acc_chunks,
        super_chunks=super_chunks,
        device=device,
        _poly_w=torch.from_numpy(poly_np).to(device),
        _rs_kernel=(
            torch.from_numpy(np.asarray(rs_kernel_np, dtype=np.float32)).to(device)
            if rs_kernel_np is not None
            else None
        ),
        _incs=torch.tensor(list(incs_fixed), dtype=torch.int64, device=device),
    )
