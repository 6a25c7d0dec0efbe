"""Data parallelism over the path batch (the ``--dp`` / ``--mesh_shape``
CLI flags), with ``torch.distributed``.

Port of ``prtp_tpu/parallel/{distributed,mesh,dp}.py`` for the 1-D
data-parallel mesh the CLIs drive. JAX shards the path batch over a
``jax.sharding.Mesh`` of one process's chips; the port runs one process
a rank, each on its own card (NCCL) or on the CPU (gloo), with the
design and the state replicated and the batch split into contiguous
blocks, one a rank: :mod:`.distributed` (process groups, the env-gated
multi-process join, spawning local ranks), :mod:`.mesh` (the mesh the
flags ask for), :mod:`.dp` (the sharded train step and evaluation).
"""

from .distributed import is_main_process, maybe_initialize, run_ranks
from .mesh import Mesh, mesh_from_options, requested_ranks

__all__ = ["Mesh", "is_main_process", "maybe_initialize",
           "mesh_from_options", "requested_ranks", "run_ranks"]
