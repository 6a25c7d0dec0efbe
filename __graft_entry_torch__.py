"""Entry points of the PyTorch/CUDA port: a forward on the flagship
model and a multi-rank dry run of one training step.

The counterpart of ``__graft_entry__.py`` on ``prtp_tpu_torch``:

- :func:`entry` returns ``(fn, example_args)``, the forward on the small
  flagship (``fn(model, design, path_ids)``, under ``torch.no_grad()``);
- :func:`dryrun_multichip` runs one full training step on tiny shapes
  over ``n`` ranks: for an even ``n >= 4`` the 2-D ``(n/2, 2)`` mesh of
  ``parallel.graph_shard`` (path batch on ``dp``, every level's edge
  tables on ``gp``, the segment reduce) held against
  ``trainer.train_step`` on every rank; otherwise the 1-D data-parallel
  step of ``parallel.dp`` on the mailbox model.

The ranks are processes (``torch.distributed``): one a card over NCCL
when there are at least ``n`` cards; otherwise ``n`` gloo ranks sharing
the card(s), rank r on ``cuda:<r % cards>``; with ``device="cpu"``, ``n``
gloo ranks on the CPU. Without a card the default ``device="cuda"``
raises; nothing falls back to the CPU on its own.

    python __graft_entry_torch__.py
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from prtp_tpu_torch import resolve_device

GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4  # atol: x the leaf's largest |g|


def _flagship(small=True, map_size=128, cnn_hw=512, seed=0,
              gnn_reduce="mailbox", device="cuda"):
    """The full multimodal PathModel (the JAX package's weights for
    ``jax.random.PRNGKey(seed)``, ``utils/convert.py::init_from_seed``)
    on ``device``, a random design packed there, and the parsed design:
    ``(model, design, parsed)``."""
    from prtp_tpu_torch.data.random_design import make_random_design
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.utils.convert import init_from_seed

    dev = resolve_device(device)
    level_sizes = ([64, 96, 80, 96, 64, 64] if small
                   else [4096, 8192, 6144, 8192, 4096, 4096, 2048, 2048])
    parsed = make_random_design(
        level_sizes, cell_feat_dim=36, num_paths=64 if small else 1350,
        map_size=map_size, cnn_hw=cnn_hw, seed=seed)
    design = pack_design(parsed, map_size=map_size, device=dev,
                         segment=gnn_reduce == "segment")
    model = init_from_seed(
        PathModel(36, 3, out_dim=128, hidden_dim=256, cnn_outdim=128,
                  map_size=map_size, gnn_reduce=gnn_reduce), seed)
    return model.to(dev), design, parsed


def entry(device="cuda"):
    """``(fn, example_args)``: the forward of the small flagship in eval
    mode, ``fn(model, design, path_ids)``, on its first 32 paths."""
    model, design, _parsed = _flagship(small=True, device=device)
    model.eval()
    path_ids = torch.arange(min(32, design.num_paths),
                            device=design.path_endpoint.device)

    def fn(model, design, path_ids):
        with torch.no_grad():
            return model(design, path_ids)

    return fn, (model, design, path_ids)


def _max_grad_gap(state, ref) -> tuple:
    """Hold ``state``'s gradients against ``ref``'s leaf by leaf (rtol
    GRAD_RTOL, atol GRAD_ATOL x the leaf's largest |g|); returns the
    largest distance over its allowance and that leaf's name ("" where
    every leaf is equal)."""
    worst = (0.0, "")
    for (name, p), (_n, q) in zip(state.model.named_parameters(),
                                  ref.model.named_parameters()):
        ga = p.grad.detach().double().cpu().numpy()
        gb = q.grad.detach().double().cpu().numpy()
        scale = float(np.max(np.abs(gb))) or 1.0
        np.testing.assert_allclose(
            ga, gb, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
            err_msg=f"{name}: sharded vs replicated gradient mismatch "
                    "(a missing gp sum or a wrong axis)")
        gap = float(np.max(np.abs(ga - gb)
                           / (GRAD_ATOL * scale + GRAD_RTOL * np.abs(gb))))
        if gap > worst[0]:
            worst = (gap, name)
    return worst


def _dryrun_impl(n_devices: int, dev: torch.device) -> dict:
    """One rank's step of :func:`dryrun_multichip` in the initialized
    process group of ``n_devices`` ranks."""
    from prtp_tpu_torch.parallel import Mesh
    from prtp_tpu_torch.parallel.dp import dp_train_step
    from prtp_tpu_torch.parallel.graph_shard import (
        graph_sharded_train_step, make_2d_mesh, shard_design)
    from prtp_tpu_torch.trainer import (init_state, make_optimizer,
                                        pad_batch, train_step)

    use_2d = n_devices >= 4 and n_devices % 2 == 0
    model, design, _parsed = _flagship(
        small=True, map_size=16, cnn_hw=64,
        gnn_reduce="segment" if use_2d else "mailbox", device=dev)
    tx = make_optimizer(1e-3)
    # a multiple of n, at least 16: the batch splits evenly over dp
    batch = n_devices * max(2, -(-16 // n_devices))
    ids, mask = pad_batch(np.arange(min(batch, design.num_paths)), batch,
                          dev)
    out = {"matched": False}
    if use_2d:
        mesh = make_2d_mesh(n_devices // 2, 2)
        ref = init_state(copy.deepcopy(model), tx, dev)
        state = init_state(model, tx, dev)
        mets = graph_sharded_train_step(state, shard_design(mesh, design),
                                        ids, mask, mesh)
        ref_mets = train_step(ref, design, ids, mask)
        np.testing.assert_allclose(float(mets["loss"]),
                                   float(ref_mets["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(mets["r2"]), float(ref_mets["r2"]),
                                   rtol=1e-3)
        out["grad_gap"] = _max_grad_gap(state, ref)
        out["matched"] = True
    else:
        mesh = Mesh.of_group()
        state = init_state(model, tx, dev)
        mets = dp_train_step(state, design, ids, mask, mesh)
    loss = float(mets["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    shape = mesh.shape if use_2d else {"dp": mesh.size}
    return dict(out, loss=loss, mesh=shape)


def _dryrun_rank(rank, n_devices, device, backend, port, out_dir):
    """A spawned rank: its device, the group over localhost, the step;
    rank 0 writes the result to ``out_dir``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False  # the port's float32
        torch.backends.cudnn.allow_tf32 = False
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n_devices))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n_devices, rank=rank)
    try:
        result = _dryrun_impl(n_devices, dev)
        if rank == 0:
            with open(os.path.join(out_dir, "result.json"), "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def _refuse_shared_cards(cards: int) -> None:
    """Raise if a card's compute mode admits one process at most: the
    ranks would share it."""
    try:
        modes = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.split()
    except (OSError, subprocess.SubprocessError):
        return  # no reading: the ranks' start will tell
    for i, mode in enumerate(modes[:cards]):
        if "exclusive" in mode.lower() or "prohibited" in mode.lower():
            raise RuntimeError(
                f"cuda:{i}'s compute mode is {mode}: it admits at most one "
                "process, so the dry run's ranks cannot share it")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full training step on tiny shapes over ``n_devices`` ranks
    (module doc), as processes of their own. Prints JAX's lines and
    returns rank 0's result: ``loss``, ``mesh``, ``matched`` and, on the
    2-D mesh, ``grad_gap`` (the largest gradient distance over its
    allowance, and its leaf), with the ``backend``."""
    from prtp_tpu_torch.parallel.distributed import free_port

    dev = resolve_device(device)
    if dev.type == "cuda":
        from prtp_tpu_torch.ops import _build
        _build.build()  # once here, not once a rank
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= n_devices else "gloo"
        if backend == "gloo":
            _refuse_shared_cards(cards)
    else:
        backend = "gloo"
    with tempfile.TemporaryDirectory(prefix="prtp_dryrun_") as tmp:
        torch.multiprocessing.start_processes(
            _dryrun_rank, args=(n_devices, dev.type, backend, free_port(),
                                tmp),
            nprocs=n_devices, join=True, start_method="spawn")
        with open(os.path.join(tmp, "result.json")) as f:
            result = json.load(f)
    result["backend"] = backend
    if result["matched"]:
        print(f"dryrun_multichip({n_devices}): 2-D segment-reduce step "
              f"matches replicated step (loss/r2/gradients)", flush=True)
    print(f"dryrun_multichip({n_devices}): ok, loss={result['loss']:.4f}, "
          f"mesh={result['mesh']}", flush=True)
    return result


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry(): forward ok,", tuple(out.shape))
    dryrun_multichip(max(8, torch.cuda.device_count()))
