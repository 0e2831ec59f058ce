"""Exact interchange of the stream state between the JAX package and the
port.

The JAX state is a pytree of arrays (``ChunkStep.init_state`` there): the
uint32 NCO ``phase``, the float32 ``fir_tail``, the ``demod`` carries, the
running ``peak`` and the resampler ``rs_tail``.  The port holds the same
dict of tensors, with the phase as the ``int64`` 62-bit phase of its NCO
(``ops/nco.py``): the uint32 phase shifted up 30 bits.  Both directions
are exact.  A phase off the uint32 grid (an NCO with increment residuals)
goes out as its 62 bits in uint64, which only the port reads back.

The walk is over whatever keys the state holds, so the layouts of every
step mode interchange: the interleaved ``(2(L-1),)`` tail of the FIR
channelizers, the ``(2, L-1)`` pair tail of the ``fft`` channelizer, and a
pass-through state (``phase`` and ``fir_tail`` only: no ``demod``, ``peak``
or ``rs_tail``).  The output accumulators (int16 ``audio``, float32
``iq_r``/``iq_i``) go through :func:`accs_from_jax`.

The JAX sharded step (``parallel/sharded.py`` there) carries one flat dict
for the whole mesh: ``phase``, ``demod_prev_r``, ``demod_prev_i``,
``deemph_y``, ``dc_x``, ``dc_y``, ``agc_gain`` of shape ``(C,)``,
``rs_tail`` ``(C, T)``, and ``fir_tail`` ``(2(L-1),)``, or ``(G, 2(L-1))``
with ``G`` captures.  Each rank of the port holds its ``dp`` row's share:
the row's ``C/dp`` channels and its capture's tail.
:func:`sharded_state_from_jax` cuts one row's share out of the JAX dict and
:func:`sharded_state_to_jax` puts the rows together again.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.nco import LOW_BITS, MASK62


def state_from_jax(np_state, device) -> dict:
    """Numpy arrays (``jax.tree_util.tree_map(np.asarray, state)``) to
    tensors on ``device``; a uint32 phase becomes the 62-bit one in int64, a
    uint64 phase is one already."""
    if isinstance(np_state, dict):
        return {k: state_from_jax(v, device) for k, v in np_state.items()}
    arr = np.asarray(np_state)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64) << LOW_BITS
    elif arr.dtype == np.uint64:
        arr = arr.astype(np.int64)
    elif arr.dtype != np.float32:
        raise TypeError(f"unexpected state dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def state_to_jax(state) -> dict:
    """Tensors to numpy arrays in the JAX layout; the int64 62-bit phase
    becomes the uint32 one, or stays 62 bits in uint64 off the uint32 grid."""
    if isinstance(state, dict):
        return {k: state_to_jax(v) for k, v in state.items()}
    arr = state.detach().cpu().numpy()
    if arr.dtype == np.int64:
        if arr.min(initial=0) < 0 or arr.max(initial=0) > MASK62:
            raise ValueError("phase outside the 62-bit range")
        if np.any(arr & ((1 << LOW_BITS) - 1)):
            return arr.astype(np.uint64)
        return (arr >> LOW_BITS).astype(np.uint32)
    return arr.copy()


def accs_from_jax(np_accs: dict, device) -> dict:
    """The window accumulators of the JAX step (``ChunkStep.init_accs``
    there, as numpy arrays) to tensors on ``device``: the s16 ``audio`` and
    the float32 ``iq_r``/``iq_i`` of dump-iq and pass-through runs."""
    out = {}
    for name, value in np_accs.items():
        arr = np.asarray(value)
        want = np.int16 if name == "audio" else np.float32
        if arr.dtype != want:
            raise TypeError(f"accumulator {name!r}: expected {want.__name__}, got {arr.dtype}")
        out[name] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return out


def sharded_state_from_jax(np_state: dict, *, dp: int, row: int, captures: int, device) -> dict:
    """The share of ``dp`` row ``row`` of the JAX sharded step's state, as
    tensors on ``device``."""
    c_local = np.asarray(np_state["phase"]).shape[0] // dp
    rows = slice(row * c_local, (row + 1) * c_local)
    local = {}
    for key, value in np_state.items():
        arr = np.asarray(value)
        if key == "fir_tail":
            local[key] = arr[row] if captures > 1 else arr
        else:
            local[key] = arr[rows]
    return state_from_jax(local, device)


def sharded_state_to_jax(row_states: list[dict], *, captures: int) -> dict:
    """The JAX sharded step's state from the shares of the ``dp`` rows, in
    row order (joined before the phase's layout is chosen, so that every
    row's phase goes out in the same one)."""
    out = {}
    for key in row_states[0]:
        parts = [s[key].detach().cpu() for s in row_states]
        if key == "fir_tail":
            out[key] = torch.stack(parts) if captures > 1 else parts[0]
        else:
            out[key] = torch.cat(parts)
    return state_to_jax(out)
