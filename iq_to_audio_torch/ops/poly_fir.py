"""Decimating polyphase FIR: the channelizer.

Counterpart of the JAX package's ``ops/pallas_ddc.py``.  With ``F = 2D`` an
input of ``T`` rows ``X[t, :]`` of ``F`` features turns the decimating
bandpass filter into

    out[o, r] = sum_{k<K} X[r + k, :] @ W[k, :, o]

with ``W`` of shape ``(K, F, 2C)`` from :func:`build_poly_kernel`.  Two
input layouts give ``X``:

* :func:`poly_fir_il`, the main path: the contiguous reshape
  ``X[t, f] = x_il[F*t + f]`` of the raw interleaved stream, with
  ``W = build_poly_kernel(kernel_il, 2D)`` (``pallas_poly_fir_il``);
* :func:`poly_fir_pair`: the ``(2, T, D) -> (T, 2D)`` relay
  ``X[t, i*D + p] = x_pair[i, D*t + p]`` of an (re, im) pair, with
  ``W = build_poly_kernel(kernel, D)`` (``pallas_poly_fir``).

Each runs the hand-written CUDA kernel ``csrc/poly_fir.cu`` for a CUDA
tensor and its plain torch version for a CPU tensor; there is no other
route.  ``poly_fir_il.launches`` and ``poly_fir_pair.launches`` count kernel
launches.

The kernel computes the same sums as one dense GEMM on the tensor cores:
four consecutive output rows ride the column axis (:func:`shifted_taps`),
the reduction walks the feature axis in blocks of 8 and the tap axis in
blocks of ``k_block`` taps, and every product is three TF32 products of
operands split into ``hi + lo`` (:func:`split_tf32`).
:func:`poly_fir_shifted_plain` is that arithmetic in plain torch, block by
block; the tests hold it against the JAX package's kernels.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch

from . import _cuda_build

#: warps per CTA, each owning one m16 tile of super-rows (4 output rows each)
WARPS = 4
#: super-rows per CTA (``kTileRows``): one m16 tile per warp
TILE_ROWS = 16 * WARPS
#: depth of the shared-memory ring: block b + 1 loads while block b runs
STAGES = 2
#: consecutive output rows that share a super-row (columns of the GEMM per output)
SHIFT = 4
#: features per block: the depth of one ``m16n8k8`` MMA
FEAT_BLOCK = 8
#: floats per staged super-row: 4 rows x 8 features + 4 of padding (``kXsStride``)
XS_STRIDE = 36
#: shared memory of one SM, of which each resident CTA reserves 1 KB
_SMEM_SM = 228 * 1024
#: SMs of an H100 SXM, the default of :func:`choose_k_block`
_SM_COUNT = 132
#: the most dynamic shared memory one CTA may use on Hopper
_SMEM_MAX = 227 * 1024
#: outputs per row (2C) the kernel is instantiated for: one to five channels
SUPPORTED_OUT = (2, 4, 6, 8, 10)


def build_poly_kernel(conv_kernel: np.ndarray, decimation: int) -> np.ndarray:
    """Repack the conv kernel ``(2C, in_ch, L)`` (tap axis reversed) into the
    polyphase tensor ``(K, F, 2C)`` with ``F = in_ch*D`` features and
    ``K = (L-1)//D + 1`` taps: conv tap ``j = kD + p`` of input ``i`` lands
    on ``W[k, i*D + p]``."""
    out_ch, in_ch, L = conv_kernel.shape
    D = decimation
    K = (L - 1) // D + 1
    # taps padded to K*D with zeros, then (out, in, k, p) -> (k, in*D + p, out)
    padded = np.zeros((out_ch, in_ch, K * D), dtype=np.float32)
    padded[:, :, :L] = conv_kernel
    w = padded.reshape(out_ch, in_ch, K, D).transpose(2, 1, 3, 0)
    return np.ascontiguousarray(w.reshape(K, in_ch * D, out_ch))


def super_taps(k_taps: int) -> int:
    """Steps ``s`` of the shifted reduction: ``ceil((K + SHIFT - 1) / SHIFT)``."""
    return (k_taps + 2 * SHIFT - 2) // SHIFT


def smem_bytes(k_block: int, feat: int, out_ch: int) -> int:
    """Dynamic shared memory of one CTA: two stages, each the input window
    (tile rows + ``k_block/4 - 1`` super-rows of ``XS_STRIDE`` floats) plus
    the split tap tile (``k_block + 3`` taps x ``out_ch`` x 4 ``float4``).
    It does not depend on ``feat``: the feature axis is walked in blocks of
    ``FEAT_BLOCK``."""
    del feat
    sb = -(-k_block // SHIFT)
    rows = TILE_ROWS + sb - 1
    return STAGES * (4 * rows * XS_STRIDE + (SHIFT * sb + 3) * out_ch * 64)


def _ctas_by_regs(out_ch: int) -> int:
    """CTAs per SM the kernel's launch bounds keep registers for
    (``min_ctas`` in ``csrc/poly_fir.cu``)."""
    tiles = out_ch // 2
    return 5 if tiles <= 1 else 4 if tiles <= 2 else 3 if tiles <= 5 else 2


@functools.lru_cache(maxsize=256)
def choose_k_block(
    k_taps: int,
    feat: int,
    out_ch: int,
    out_size: int | None = None,
    sm_count: int = _SM_COUNT,
) -> int:
    """Taps staged per block, a multiple of 4.

    Every balanced split of the super-tap axis is a candidate.  Given
    ``out_size``, the one whose CTAs pass in the fewest waves over
    ``sm_count`` SMs wins (a second, part-filled wave runs at low
    occupancy); then, and without ``out_size``, at least two CTAs per SM,
    then the fewest blocks.  ``feat`` does not enter, so any decimation
    fits: one block of 4 taps needs under 40 KB."""
    s_all = super_taps(k_taps)
    ctas = None if out_size is None else -(-out_size // (SHIFT * TILE_ROWS))
    best = None
    for n_blocks in range(1, s_all + 1):
        sb = -(-s_all // n_blocks)
        smem = smem_bytes(SHIFT * sb, feat, out_ch)
        if smem > _SMEM_MAX or (n_blocks > 1 and sb == -(-s_all // (n_blocks - 1))):
            continue
        per_sm = min(_ctas_by_regs(out_ch), _SMEM_SM // (smem + 1024))
        waves = 0 if ctas is None else -(-ctas // (sm_count * per_sm))
        key = (waves, per_sm < 2, n_blocks)
        if best is None or key < best[0]:
            best = (key, SHIFT * sb)
    return best[1]


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 with the low 13 mantissa bits rounded
    away, to nearest, ties away from zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``hi = tf32(v)`` rounded to nearest, ``lo`` the TF32 truncation of
    ``v - hi``, as the kernel splits.  ``hi + lo == v`` exactly when ``v`` has
    at most 22 significant bits, as an s16 or u8 sample scaled by a power of
    two has; else to ``2**-21`` of ``v``."""
    hi = tf32_round(v)
    return hi, ((v - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def shifted_taps(poly_w: np.ndarray) -> np.ndarray:
    """The B matrix of the shifted GEMM, ``((K + 3) F, 4 O)``: column
    ``i*O + o`` of row ``j`` is ``Wflat[j - F*i, o]`` with
    ``Wflat = W.reshape(K*F, O)`` read as zero outside.  The kernel never
    builds it (it reads tap ``k - i`` of the zero-framed tensor); this is the
    indexer the tests hold against ``shift_matmul_kernel``."""
    K, F, O = poly_w.shape
    b = np.zeros(((K + SHIFT - 1) * F, SHIFT, O), dtype=poly_w.dtype)
    for i in range(SHIFT):
        b[i * F : (i + K) * F, i, :] = poly_w.reshape(K * F, O)
    return b.reshape(-1, SHIFT * O)


def poly_fir_shifted_plain(
    x: torch.Tensor,
    poly_w: torch.Tensor,
    decimation: int,
    out_size: int,
    *,
    pair: bool = False,
    k_block: int | None = None,
    products: int = 3,
) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: the shifted GEMM over
    super-rows of 4 outputs, walked feature block by feature block and tap
    block by tap block, one depth-8 step at a time, each step
    ``lo@hi + hi@lo + hi@hi`` of the TF32 halves accumulated in float32, a
    chain per super-tap added to the running sums (``products=1`` keeps
    ``hi@hi`` alone: one TF32 product, which the tests show to miss the
    accuracy gate).  Returns float32 ``(2C, out_size)``.
    """
    K, F, out_ch = poly_w.shape
    D = decimation
    assert F == 2 * D, (F, D)
    s_all = super_taps(K)
    kb = choose_k_block(K, F, out_ch) if k_block is None else max(1, min(K, int(k_block)))
    sb = min(s_all, -(-kb // SHIFT))
    rho = -(-out_size // SHIFT)
    t_need = SHIFT * (rho + s_all)
    if pair:
        have, need = x.shape[-1], t_need * D
        x = x[:, :need] if have >= need else torch.nn.functional.pad(x, (0, need - have))
        X = x.reshape(2, t_need, D).transpose(0, 1).reshape(t_need, F)
    else:
        have, need = x.shape[-1], t_need * F
        x = x[:need] if have >= need else torch.nn.functional.pad(x, (0, need - have))
        X = x.reshape(t_need, F)
    f_pad = -F % FEAT_BLOCK
    X = torch.nn.functional.pad(X, (0, f_pad))
    B = torch.from_numpy(shifted_taps(poly_w.cpu().numpy())).to(x.device)
    B = torch.nn.functional.pad(B, (0, 0, 0, (SHIFT * s_all - K - SHIFT + 1) * F))
    B = torch.nn.functional.pad(B.reshape(SHIFT * s_all, F, SHIFT * out_ch), (0, 0, 0, f_pad))
    a_hi, a_lo = split_tf32(X)
    b_hi, b_lo = split_tf32(B)
    acc = torch.zeros((rho, SHIFT * out_ch), dtype=torch.float32, device=x.device)

    def step(rows_of, cols):
        """One depth-8 MMA step: the A and B slices of 1 or 2 rows of X."""
        parts = []
        for mats in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))[3 - products :]:
            a = torch.cat([mats[0][slice(t, t + SHIFT * rho, SHIFT), cols] for t in rows_of], 1)
            parts.append(a @ torch.cat([mats[1][t, cols] for t in rows_of], 0))
        return parts

    for f0 in range(0, F + f_pad, FEAT_BLOCK):
        # F = 8n + 4: the last block's 4 features of two rows make one step
        half = F % FEAT_BLOCK == 4 and f0 + FEAT_BLOCK > F
        cols = slice(f0, f0 + (4 if half else FEAT_BLOCK))
        for s0 in range(0, s_all, sb):
            for s in range(s0, min(s_all, s0 + sb)):
                part = torch.zeros_like(acc)  # a chain per super-tap, then FADD
                for q in range(0, SHIFT, 2 if half else 1):
                    t = SHIFT * s + q
                    for p in step((t, t + 1) if half else (t,), cols):
                        part += p
                acc += part
    out = acc.reshape(rho * SHIFT, out_ch)[:out_size]
    return out.T.contiguous()


def poly_fir_il_plain(
    x_il: torch.Tensor,
    poly_w: torch.Tensor,
    decimation: int,
    out_size: int,
    *,
    k_block: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: for each tap block, sum ``X[k:k+m] @ W[k]``.

    Returns float32 ``(2C, out_size)``.
    """
    feat = 2 * decimation
    K, F, out_ch = poly_w.shape
    assert F == feat, (F, feat)
    m = out_size
    need = (m + K - 1) * F
    have = x_il.shape[-1]
    x = x_il[:need] if have >= need else torch.nn.functional.pad(x_il, (0, need - have))
    X = x.reshape(m + K - 1, F)
    kb = K if k_block is None else max(1, min(K, int(k_block)))
    out = torch.zeros((m, out_ch), dtype=torch.float32, device=x_il.device)
    for k0 in range(0, K, kb):
        part = torch.zeros_like(out)
        for k in range(k0, min(K, k0 + kb)):
            part += X[k : k + m] @ poly_w[k]
        out += part
    return out.T.contiguous()


def poly_fir_pair_plain(
    x_pair: torch.Tensor,
    poly_w: torch.Tensor,
    decimation: int,
    out_size: int,
    *,
    k_block: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`poly_fir_pair`: relay the pair to the
    interleaved ``(T, 2D)`` rows with torch ops, then the
    :func:`poly_fir_il_plain` loop.  Returns float32 ``(2C, out_size)``."""
    D = decimation
    K = poly_w.shape[0]
    t_need = out_size + K - 1
    have = x_pair.shape[-1]
    need = t_need * D
    if have >= need:
        x_pair = x_pair[:, :need]
    else:
        x_pair = torch.nn.functional.pad(x_pair, (0, need - have))
    relayed = x_pair.reshape(2, t_need, D).transpose(0, 1).reshape(-1)
    return poly_fir_il_plain(relayed, poly_w, decimation, out_size, k_block=k_block)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load("poly_fir")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.iq2a_poly_fir_il, lib.iq2a_poly_fir_pair):
        fn.argtypes = [ptr, i64, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    return lib


#: split taps by ``id(poly_w)``: (weak reference, version, stream, packed tensor)
_PACKED: dict[int, tuple] = {}


def _packed_taps(poly_w: torch.Tensor, stream: int) -> torch.Tensor | None:
    """The scratch that holds ``poly_w`` split and tiled by the pack kernel,
    if an earlier launch filled it: it is kept while the tensor lives, is not
    written in place and is used on the same stream, so a stream of chunks
    packs its taps once."""
    hit = _PACKED.get(id(poly_w))
    if hit is not None and hit[0]() is poly_w and hit[1:3] == (poly_w._version, stream):
        return hit[3]
    return None


def _launch(
    wrapper,
    x: torch.Tensor,
    length: int,
    poly_w: torch.Tensor,
    decimation: int,
    out_size: int,
    k_block: int | None,
) -> torch.Tensor:
    """Check a CUDA call, allocate the result, launch ``wrapper``'s kernel
    (and the tap split, the first time it sees ``poly_w``) and count it."""
    name = wrapper.__name__
    K, F, out_ch = poly_w.shape
    if poly_w.device != x.device:
        raise ValueError(f"{name}: the input and poly_w must be on one device")
    if x.dtype != torch.float32 or poly_w.dtype != torch.float32:
        raise ValueError(f"{name}: float32 inputs required")
    if not x.is_contiguous() or not poly_w.is_contiguous():
        raise ValueError(f"{name}: contiguous inputs required")
    if F != 2 * decimation:
        raise ValueError(f"{name}: poly_w has {F} features, expected {2 * decimation}")
    if out_ch not in SUPPORTED_OUT:
        raise ValueError(f"{name}: {out_ch} outputs per row unsupported")
    if x.numel() >= 1 << 31 or out_size <= 0:
        raise ValueError(f"{name}: stream length out of range")
    if x.get_device() != torch.cuda.current_device():
        raise ValueError(f"{name}: the input is not on the current CUDA device")
    if k_block is None:
        kb = choose_k_block(K, F, out_ch, out_size, _sm_count(x.get_device()))
    else:
        kb = max(1, min(K, int(k_block)))
        if smem_bytes(kb, F, out_ch) > _SMEM_MAX:
            raise ValueError(f"{name}: k_block {k_block} does not fit shared memory")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    packed = _packed_taps(poly_w, stream)
    pack = packed is None
    if pack:
        n_fb = -(-F // FEAT_BLOCK)
        packed = torch.empty(
            n_fb * (SHIFT * super_taps(K) + 3) * out_ch * 16, dtype=torch.float32, device=x.device
        )
    out = torch.empty((out_ch, out_size), dtype=torch.float32, device=x.device)
    rc = getattr(_library(), f"iq2a_{name}")(
        x.data_ptr(), length, poly_w.data_ptr(), packed.data_ptr(), out.data_ptr(),
        out_size, K, F, out_ch, -(-kb // SHIFT), int(pack), stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    if pack:  # only now: a failed call must not leave an unfilled scratch behind
        key = id(poly_w)
        ref = weakref.ref(poly_w, lambda _: _PACKED.pop(key, None))
        _PACKED[key] = (ref, poly_w._version, stream, packed)
    wrapper.launches += 1
    return out


def poly_fir_il(
    x_il: torch.Tensor,
    poly_w: torch.Tensor,
    decimation: int,
    out_size: int,
    *,
    k_block: int | None = None,
) -> torch.Tensor:
    """Decimating polyphase FIR of the interleaved stream.

    Parameters
    ----------
    x_il: float32 ``(2(L-1) + 2N,)`` scaled raw samples incl. the carried tail.
    poly_w: float32 ``(K, 2D, 2C)`` from :func:`build_poly_kernel`.
    k_block: taps staged per block (rounded up to a multiple of 4); default
        from :func:`choose_k_block`.

    Returns float32 ``(2C, out_size)``.  A CPU tensor goes through
    :func:`poly_fir_il_plain`; a CUDA tensor through the kernel, or raises.
    """
    if x_il.device.type == "cpu":
        return poly_fir_il_plain(x_il, poly_w, decimation, out_size, k_block=k_block)
    if x_il.device.type != "cuda":
        raise ValueError(f"poly_fir_il: unsupported device {x_il.device}")
    if x_il.dim() != 1:
        raise ValueError("poly_fir_il: 1-D x_il required")
    return _launch(poly_fir_il, x_il, x_il.numel(), poly_w, decimation, out_size, k_block)


poly_fir_il.launches = 0


def poly_fir_pair(
    x_pair: torch.Tensor,
    poly_w: torch.Tensor,
    decimation: int,
    out_size: int,
    *,
    k_block: int | None = None,
) -> torch.Tensor:
    """Decimating polyphase FIR of an (re, im) pair; the kernel reads the
    ``(2, T, D) -> (T, 2D)`` relay in place.

    Parameters
    ----------
    x_pair: float32 ``(2, L-1+N)`` input including the carried tail.
    poly_w: float32 ``(K, 2D, 2C)`` = ``build_poly_kernel(kernel, D)`` of the
        pair kernel ``(2C, 2, L)``.
    k_block: as for :func:`poly_fir_il`.

    Returns float32 ``(2C, out_size)``.  A CPU tensor goes through
    :func:`poly_fir_pair_plain`; a CUDA tensor through the kernel, or raises.
    """
    if x_pair.device.type == "cpu":
        return poly_fir_pair_plain(x_pair, poly_w, decimation, out_size, k_block=k_block)
    if x_pair.device.type != "cuda":
        raise ValueError(f"poly_fir_pair: unsupported device {x_pair.device}")
    if x_pair.dim() != 2 or x_pair.shape[0] != 2:
        raise ValueError("poly_fir_pair: (2, n) x_pair required")
    return _launch(poly_fir_pair, x_pair, x_pair.shape[1], poly_w, decimation, out_size, k_block)


poly_fir_pair.launches = 0
