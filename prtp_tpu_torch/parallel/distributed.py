"""Process groups for data parallelism: the env-gated multi-process join
and the CLIs' local ranks.

Port of ``prtp_tpu/parallel/distributed.py``. JAX runs one process a
host, which drives all of that host's chips, and joins the processes of
a multi-host slice with ``jax.distributed.initialize``. The port runs
one process a card, so ``PRTP_NUM_PROCESSES`` counts cards, and joins
them with ``torch.distributed.init_process_group``: NCCL for CUDA
tensors, gloo for the CPU's. The join is env-gated, and a no-op without
the variables, as in JAX:

  PRTP_COORDINATOR=host0:9971 PRTP_NUM_PROCESSES=8 PRTP_PROCESS_ID=i \\
      python -m prtp_tpu_torch.train --dp ...

or ``PRTP_MULTIHOST=1`` under ``torchrun``, whose ``env://`` variables
name the group. Without a group, a CLI given ``--dp`` starts its own
ranks on this host (:func:`run_ranks`).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def is_main_process() -> bool:
    """Whether this process is rank 0 of its group, or has none: the one
    that writes logs, configs and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def maybe_initialize(device="cuda", backend: str | None = None,
                     log=print) -> bool:
    """Join the process group the environment names, if it names one.

    ``PRTP_COORDINATOR`` (``host:port``), ``PRTP_NUM_PROCESSES`` and
    ``PRTP_PROCESS_ID`` give the group's address, size and this
    process's rank; ``PRTP_MULTIHOST=1`` takes them from torchrun's
    ``env://`` variables. ``backend`` defaults to
    :func:`default_backend` of ``device``. Returns True when it joined;
    without the variables, or when a group exists already, it does
    nothing and returns False."""
    coord = os.environ.get("PRTP_COORDINATOR")
    auto = os.environ.get("PRTP_MULTIHOST") == "1"
    if not coord and not auto:
        return False
    if dist.is_initialized():
        return False
    backend = backend or default_backend(device)
    if coord:
        dist.init_process_group(
            backend, init_method=f"tcp://{coord}",
            world_size=int(os.environ["PRTP_NUM_PROCESSES"]),
            rank=int(os.environ["PRTP_PROCESS_ID"]))
    else:
        dist.init_process_group(backend, init_method="env://")
    log(f"torch.distributed: process {dist.get_rank()}/"
        f"{dist.get_world_size()}, backend {backend}")
    return True


def rank_device(device) -> torch.device:
    """This process's device: one process drives one card, so under a
    group of several ranks a CUDA ``device`` becomes ``cuda:LOCAL_RANK``
    (torchrun's) or ``cuda:<rank modulo the visible cards>``; the CPU
    stays the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or not dist.is_initialized():
        return dev
    if dist.get_world_size() == 1:
        return (dev if dev.index is not None
                else torch.device("cuda", torch.cuda.current_device()))
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else dist.get_rank() % torch.cuda.device_count())
    return torch.device("cuda", index)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, options, device, backend, port, world):
    """A spawned rank: join the local group, run ``fn`` on this rank's
    device (``cuda:<rank>``, or the CPU), leave the group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        from .mesh import mesh_from_options
        fn(options, mesh_from_options(options, device), dev)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, options, device="cuda", backend: str | None = None):
    """Call ``fn(options, mesh, device)`` on every rank of the
    data-parallel mesh that ``--dp`` / ``--mesh_shape`` ask for
    (:func:`~prtp_tpu_torch.parallel.mesh.requested_ranks`).

    In a process group (torchrun, ``PRTP_COORDINATOR``) this process is
    one rank: ``fn`` runs here on its device. Otherwise this process
    starts the ranks on this host: one rank runs here, in a group of one;
    N ranks are N new processes (``spawn``), rank r on ``cuda:r`` or, for
    ``device="cpu"``, on the CPU, joined over localhost, and this call
    returns None once all have finished (a rank's exception is raised
    here). ``backend`` defaults to :func:`default_backend` of
    ``device``."""
    from .mesh import mesh_from_options, requested_ranks

    backend = backend or default_backend(device)
    world = requested_ranks(options, device)
    if dist.is_initialized():
        return fn(options, mesh_from_options(options, device),
                  rank_device(device))
    if world == 1:
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
        try:
            return fn(options, mesh_from_options(options, device),
                      rank_device(device))
        finally:
            dist.destroy_process_group()
    torch.multiprocessing.start_processes(
        _rank_entry, args=(fn, options, str(device), backend, free_port(),
                           world),
        nprocs=world, join=True, start_method="spawn")
    return None
