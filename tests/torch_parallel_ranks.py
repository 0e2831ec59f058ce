"""Rank functions of the ``test_torch_parallel_*`` tests.

The spawned ranks import this module by name (``run_world`` pickles a rank
function by its import path), so it imports nothing of JAX and nothing of
the JAX package: the ranks run the port alone.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from iq_to_audio_torch.convert import sharded_state_from_jax, state_to_jax
from iq_to_audio_torch.parallel.mesh import make_mesh
from iq_to_audio_torch.parallel.sharded import build_sharded_step, local_operands


def sharded_cases(ctx, dp: int, cases: dict) -> dict:
    """Every case through the port's sharded step on one ``dp x seq`` mesh:
    per case, this rank's audio of each chunk and its final state in the
    JAX layout.  A case is a dict of the step's geometry and inputs;
    ``state0`` (JAX layout) replaces the fresh state."""
    mesh = make_mesh(ctx.world, dp=dp, device="cpu")
    row = mesh.get_local_rank("dp")
    out = {}
    for name, case in cases.items():
        fn, init_state = build_sharded_step(
            mesh, ddc_plan=case["ddc_plan"], rs_plan=case["rs_plan"],
            num_channels=len(case["incs"]), codec="pcm_s16le", mode=case["mode"],
            deemph_alpha=case["alpha"],
        )
        state = init_state()
        if case.get("state0") is not None:
            state = sharded_state_from_jax(case["state0"], dp=dp, row=row, captures=1,
                                           device="cpu")
        incs, poly_w = local_operands(
            mesh, case["incs"], case["kernel_il"], case["ddc_plan"].decimation
        )
        rs_kernel = None if case["rs_kernel"] is None else torch.from_numpy(case["rs_kernel"])
        audio = []
        for raw, offset in zip(case["raws"], case["offsets"]):
            raw_local = torch.from_numpy(np.ascontiguousarray(_local_slice(mesh, raw)))
            state, chunk_audio = fn(state, raw_local, offset, incs, poly_w, rs_kernel)
            audio.append(chunk_audio.numpy().copy())
        out[name] = {"row": row, "shard": mesh.get_local_rank("seq"), "audio": audio,
                     "state": state_to_jax(state)}
    return out


def _local_slice(mesh, raw: np.ndarray) -> np.ndarray:
    """This rank's ``seq`` slice of an interleaved chunk."""
    seq, index = mesh.shape[1], mesh.get_local_rank("seq")
    n = raw.shape[-1] // seq
    return raw[..., index * n : (index + 1) * n]


def imported_modules(ctx) -> list[str]:
    """The modules of JAX or of the JAX package a rank has loaded after
    importing every module of the port's multi-device slice."""
    import iq_to_audio_torch.cli  # noqa: F401
    import iq_to_audio_torch.parallel.dp_runner  # noqa: F401

    make_mesh(ctx.world, device="cpu")
    return sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.") or m.startswith("iq_to_audio_tpu")
    )


def fail_on_rank_one(ctx) -> None:
    """Rank 1 raises while rank 0 waits in a collective."""
    if ctx.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    dist.barrier()
