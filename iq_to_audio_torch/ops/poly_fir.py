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
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _cuda_build

#: output rows per CTA (``kTileM`` in ``csrc/poly_fir.cu``)
TILE_M = 128
#: shared memory a CTA should use, so that three fit on one SM
_SMEM_BUDGET = 72 * 1024
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
    w = np.zeros((K, in_ch * D, out_ch), dtype=np.float32)
    for j in range(L):
        k, p = divmod(j, D)
        for i in range(in_ch):
            w[k, i * D + p, :] = conv_kernel[:, i, j]
    return w


def smem_bytes(k_block: int, feat: int, out_ch: int) -> int:
    """Dynamic shared memory of one CTA: the ``TILE_M + k_block - 1``-row
    input window at the odd row stride ``feat | 1``, plus the tap block."""
    return 4 * ((TILE_M + k_block - 1) * (feat | 1) + k_block * feat * out_ch)


def choose_k_block(k_taps: int, feat: int, out_ch: int) -> int:
    """Taps staged per block: all of them when the CTA fits the shared
    memory budget, else the largest multiple of 8 that fits (or the largest
    block at all, below 8).  Geometries too wide for the budget at one tap
    fall back to the card's per-CTA maximum, and raise beyond it."""
    if smem_bytes(k_taps, feat, out_ch) <= _SMEM_BUDGET:
        return k_taps
    for budget in (_SMEM_BUDGET, _SMEM_MAX):
        fixed = (TILE_M - 1) * (feat | 1)
        fit = (budget // 4 - fixed) // ((feat | 1) + feat * out_ch)
        if fit >= 1:
            return min(k_taps, (fit // 8) * 8 if fit >= 8 else fit)
    raise ValueError(
        f"polyphase FIR with {feat} features x {out_ch} outputs does not fit "
        "one CTA's shared memory (decimation too large)"
    )


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
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load("poly_fir")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.iq2a_poly_fir_il, lib.iq2a_poly_fir_pair):
        fn.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    return lib


def _check(name: str, x: torch.Tensor, poly_w: torch.Tensor, decimation: int, out_size: int):
    """The checks both wrappers make of a CUDA call; returns ``(K, F, O)``."""
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
    return K, F, out_ch


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
    k_block: taps staged per block; default from :func:`choose_k_block`.

    Returns float32 ``(2C, out_size)``.  A CPU tensor goes through
    :func:`poly_fir_il_plain`; a CUDA tensor through the kernel, or raises.
    """
    if x_il.device.type == "cpu":
        return poly_fir_il_plain(x_il, poly_w, decimation, out_size, k_block=k_block)
    if x_il.device.type != "cuda":
        raise ValueError(f"poly_fir_il: unsupported device {x_il.device}")
    if x_il.dim() != 1:
        raise ValueError("poly_fir_il: 1-D x_il required")
    K, F, out_ch = _check("poly_fir_il", x_il, poly_w, decimation, out_size)
    kb = choose_k_block(K, F, out_ch) if k_block is None else max(1, min(K, int(k_block)))
    out = torch.empty((out_ch, out_size), dtype=torch.float32, device=x_il.device)
    rc = _library().iq2a_poly_fir_il(
        x_il.data_ptr(), x_il.numel(), poly_w.data_ptr(), out.data_ptr(),
        out_size, K, F, out_ch, kb, torch.cuda.current_stream(x_il.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"poly_fir_il: CUDA error {rc} at launch")
    poly_fir_il.launches += 1
    return out


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
    k_block: taps staged per block; default from :func:`choose_k_block`.

    Returns float32 ``(2C, out_size)``.  A CPU tensor goes through
    :func:`poly_fir_pair_plain`; a CUDA tensor through the kernel, or raises.
    """
    if x_pair.device.type == "cpu":
        return poly_fir_pair_plain(x_pair, poly_w, decimation, out_size, k_block=k_block)
    if x_pair.device.type != "cuda":
        raise ValueError(f"poly_fir_pair: unsupported device {x_pair.device}")
    if x_pair.dim() != 2 or x_pair.shape[0] != 2:
        raise ValueError("poly_fir_pair: (2, n) x_pair required")
    K, F, out_ch = _check("poly_fir_pair", x_pair, poly_w, decimation, out_size)
    kb = choose_k_block(K, F, out_ch) if k_block is None else max(1, min(K, int(k_block)))
    out = torch.empty((out_ch, out_size), dtype=torch.float32, device=x_pair.device)
    rc = _library().iq2a_poly_fir_pair(
        x_pair.data_ptr(), x_pair.shape[1], poly_w.data_ptr(), out.data_ptr(),
        out_size, K, F, out_ch, kb, torch.cuda.current_stream(x_pair.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"poly_fir_pair: CUDA error {rc} at launch")
    poly_fir_pair.launches += 1
    return out


poly_fir_pair.launches = 0
