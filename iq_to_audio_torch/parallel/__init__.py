"""Multi-device execution: meshes of ranks and the sharded pipeline step.

The single-capture workload is sequence-parallel by nature: the decimating
FIR's output frames are independent given an (L-1)-sample halo, and the
per-sample recurrences are first-order linear scans that compose across
shards.  The mesh is ``("dp", "seq")``:

* ``dp``  — data parallel over batched channels (or captures),
* ``seq`` — sequence parallel within one chunk: the chunk is split, the FIR
  and discriminator halos cross to the right neighbour, the demod scans run
  locally and are stitched with an all-gathered carry prefix, and the
  audio-rate tail work is replicated.

The JAX package drives the mesh from one process (``shard_map``); the port
runs one rank per device on ``torch.distributed`` (NCCL on the card, gloo
on the CPU), started by :func:`.launch.run_world`.
"""

from .mesh import make_mesh
from .sharded import build_sharded_step, distributed_first_order_scan

__all__ = ["make_mesh", "build_sharded_step", "distributed_first_order_scan"]
