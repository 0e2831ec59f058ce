"""Device mesh over the ranks of a ``torch.distributed`` world (port of the
JAX package's ``parallel/mesh.py``).

The JAX package lays a ``("dp", "seq")`` mesh over the devices one process
sees.  Torch has no single-process counterpart, so the port runs one rank
per device (:mod:`.launch` starts them) and lays the mesh over the ranks:
a :class:`~torch.distributed.device_mesh.DeviceMesh` whose ``seq`` groups
carry the halos and scan summaries and whose ``dp`` groups gather the
channels.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def device_count(device: str | torch.device = "cuda") -> int:
    """The world a run on ``device`` uses: the visible cards on ``cuda``;
    on ``cpu`` the ranks named by ``IQ2A_CPU_RANKS`` (default 1), the
    counterpart of the JAX package's
    ``--xla_force_host_platform_device_count``."""
    kind = torch.device(device).type
    if kind == "cuda":
        return torch.cuda.device_count()
    if kind == "cpu":
        return max(1, int(os.environ.get("IQ2A_CPU_RANKS", "1")))
    raise ValueError(f"unsupported device {device!r}")


def make_mesh(
    n_devices: int | None = None,
    *,
    dp: int | None = None,
    device: str | torch.device = "cuda",
) -> DeviceMesh:
    """Build a ("dp", "seq") mesh over the ranks of the initialised world.

    ``dp`` defaults to 1 (everything sequence-parallel); raise it to batch
    independent channels or captures across devices.  Rank ``r`` sits at
    ``(r // seq, r % seq)``.  The mesh spans the whole world: launch as
    many ranks as it has devices.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised world: start the ranks with "
            "iq_to_audio_torch.parallel.launch.run_world"
        )
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"Requested {n} devices but only {world} present.")
    if n != world:
        raise ValueError(
            f"Requested {n} devices of a world of {world} ranks: the mesh spans "
            "the whole world, so launch one rank per device of the mesh."
        )
    dp = dp or 1
    if n % dp != 0:
        raise ValueError(f"dp={dp} must divide device count {n}.")
    return init_device_mesh(
        torch.device(device).type, (dp, n // dp), mesh_dim_names=("dp", "seq")
    )
