"""Child process of ``tests/test_torch_graph_shard.py``: the port's 2-D
``(dp, gp)`` edge-sharded steps, one gloo rank a process on the CPU.

Usage:
  python _torch_graph_shard_child.py <dir>

``<dir>/cases.pkl`` maps each case's name to its parsed design, the
model's keyword arguments and initial parameters (a state dict of numpy
arrays), ``pack_design``'s extra keyword arguments (``pack``), the
padded batch ``(ids, mask)``, the mesh shape ``(n_dp,
n_gp)``, the batch axis and the number of steps. For each world size
the cases need, this process forks that many ranks (after importing the
port once, so no rank imports it again); each rank runs
every case of its world size: ``shard_design`` and STEPS
``graph_sharded_train_step`` calls from the given state, and writes
``<dir>/<case>_rank<r>.pt``: the losses, the first step's gradients,
the flat parameters' checksum after each step, the count of
destination slots split across gp blocks, and first, at the given
state and where the case asks for it (``walk``), the GNN walk alone on
the sharded design (:func:`walk`).
"""

import os
import pickle
import sys


def walk(model, graph, seed=7):
    """The walk's final state for a random h0 (numpy seed ``seed``), and
    for a random cotangent of it the h0 cotangent and the GNN's
    parameter gradients (the optimizer's buffers, zeroed by the next
    step)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shape = (graph.num_rows + 1, model.gnn.out_dim)
    h0 = torch.from_numpy(
        (0.3 * rng.normal(size=shape)).astype(np.float32)).requires_grad_()
    cot = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    h = model.gnn(graph, h0)
    (h * cot).sum().backward()
    return (h.detach().numpy(), h0.grad.numpy(),
            {k: p.grad.numpy().copy() for k, p in model.gnn.named_parameters()})


def run_rank(rank, world, port, cases, out_dir):
    import numpy as np
    import torch
    import torch.distributed as dist

    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.parallel.graph_shard import (graph_sharded_train_step,
                                                     make_2d_mesh,
                                                     shard_design)
    from prtp_tpu_torch.trainer import init_state, make_optimizer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        for name, case in cases.items():
            mesh = make_2d_mesh(*case["shape"])
            parsed = case["parsed"]
            model = PathModel(parsed["cell_feat"].shape[1],
                              parsed["net_feat"].shape[1], **case["model_kw"])
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in case["state"].items()})
            state = init_state(model, make_optimizer(case["lr"]), "cpu")
            design = shard_design(mesh, pack_design(
                parsed, map_size=case["model_kw"]["map_size"], device="cpu",
                segment=True, **case["pack"]))
            ids, mask = (torch.from_numpy(np.asarray(x))
                         for x in case["batch"])
            out = {"losses": [], "checksums": [], "grads": None,
                   "split_slots": design.graph.shard.split_slots,
                   "mesh": (mesh.dp_rank, mesh.gp_rank),
                   "walk": (walk(model, design.graph) if case["walk"]
                            else None)}
            for t in range(case["steps"]):
                mets = graph_sharded_train_step(state, design, ids, mask, mesh,
                                                batch_axis=case["batch_axis"])
                out["losses"].append(float(mets["loss"]))
                if t == 0:
                    out["grads"] = {k: p.grad.numpy().copy()
                                    for k, p in model.named_parameters()}
                out["checksums"].append(
                    float(state.optimizer.flat.double().abs().sum()))
            torch.save(out, os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main():
    import torch.multiprocessing as mp

    import prtp_tpu_torch.parallel.graph_shard  # noqa: F401 (the ranks fork)
    import prtp_tpu_torch.trainer  # noqa: F401
    from prtp_tpu_torch.parallel.distributed import free_port

    out_dir = sys.argv[1]
    with open(os.path.join(out_dir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    worlds = sorted({c["shape"][0] * c["shape"][1] for c in cases.values()})
    for world in worlds:
        mine = {k: c for k, c in cases.items()
                if c["shape"][0] * c["shape"][1] == world}
        mp.start_processes(run_rank, args=(world, free_port(), mine, out_dir),
                           nprocs=world, join=True, start_method="fork")
    print("RESULT ok", " ".join(sorted(cases)), flush=True)


if __name__ == "__main__":
    main()
