"""The data-parallel mesh of the ``--dp`` / ``--mesh_shape`` flags.

Port of ``prtp_tpu/parallel/mesh.py::mesh_from_options``: a 1-D mesh
over the path batch, every other tensor replicated. In the port the
mesh is the default process group, one rank a process; rank r holds the
r-th contiguous block of every batch (JAX's ``P("dp")``, and the last
axis of a grouped ``(K, B)`` batch, as ``stacked_batch_sharding``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This process's rank of ``size`` in the data-parallel process
    group ``group`` (None: the default group)."""

    size: int
    rank: int
    group: object = None

    @classmethod
    def of_group(cls, group=None) -> "Mesh":
        """The mesh of an initialized process group."""
        return cls(dist.get_world_size(group), dist.get_rank(group), group)


def requested_ranks(options, device="cuda") -> int | None:
    """How many ranks ``--dp`` / ``--mesh_shape`` ask for: None when
    neither is given (one process, no group). ``--dp`` alone means every
    visible card (``torch.cuda.device_count()``), one rank on the CPU, or
    every rank of an existing process group; ``--mesh_shape N`` means N
    (an explicit mesh implies ``--dp``). A multi-dimensional
    ``--mesh_shape`` (the 2-D ``(dp, gp)`` edge sharding is the
    :mod:`.graph_shard` library API, as in JAX), more ranks than cards,
    or another N than an existing group's size is refused."""
    if not (getattr(options, "dp", False)
            or getattr(options, "mesh_shape", None)):
        return None
    shape = getattr(options, "mesh_shape", None)
    if shape and len(shape) > 1:
        raise ValueError(
            f"--mesh_shape {shape}: the train/test CLIs run a 1-D "
            "data-parallel mesh; for the 2-D (dp, gp) graph-sharded "
            "step use prtp_tpu_torch.parallel.graph_shard directly")
    if dist.is_initialized():
        world = dist.get_world_size()
        if shape and shape[0] != world:
            raise ValueError(f"--mesh_shape {shape[0]}: the process group "
                             f"has {world} ranks")
        return world
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        want = shape[0] if shape else have
        if want > have:
            raise RuntimeError(
                f"need {want} CUDA cards, have {have}: one rank drives one "
                "card (pass device='cpu' for ranks on the CPU)")
    else:
        want = shape[0] if shape else 1
    if want < 1:
        raise ValueError(f"--mesh_shape {shape}: at least one rank")
    return want


def mesh_from_options(options, device="cuda") -> Mesh | None:
    """None unless ``--dp`` or ``--mesh_shape`` is given; otherwise the
    mesh of the process group this process is a rank of (which
    :func:`~prtp_tpu_torch.parallel.distributed.run_ranks` starts), after
    checking the flags against it (:func:`requested_ranks`)."""
    if requested_ranks(options, device) is None:
        return None
    if not dist.is_initialized():
        raise RuntimeError("--dp needs a process group: run the CLI, or "
                           "parallel.run_ranks, which starts one")
    return Mesh.of_group()
