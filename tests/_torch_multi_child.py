"""Child process of ``tests/test_torch_multi.py``: the port's
design-sharded multi-design step, two gloo ranks on the CPU.

Usage:
  python _torch_multi_child.py <dir>

``<dir>/cases.pkl`` maps each case's name to the parsed designs, the
model's keyword arguments and initial parameters (a state dict of numpy
arrays), the per-design batch ``(ids, mask)`` ``(K, B)``, the task, the
alignment of JAX's bucket and the number of steps. This process imports
the port once and forks two ranks; each rank runs every case from the
given state: ``multidesign_eval_step`` at the init, then the steps of
``multidesign_train_step`` over the 2-rank mesh, and writes
``<dir>/<case>_rank<r>.pt``: the predictions and metrics of the
evaluation, each step's loss, the first step's gradients and the flat
parameters' checksum after each step.
"""

import os
import pickle
import sys


def run_rank(rank, world, port, cases, out_dir):
    import numpy as np
    import torch
    import torch.distributed as dist

    from prtp_tpu_torch.graph import stack_designs
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.parallel import Mesh
    from prtp_tpu_torch.parallel.multi import (multidesign_eval_step,
                                               multidesign_train_step)
    from prtp_tpu_torch.trainer import init_state, make_optimizer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = Mesh.of_group()
        for name, case in cases.items():
            kw = case["model_kw"]
            dtype = kw.get("compute_dtype")
            parsed = case["parsed"]
            model = PathModel(parsed[0]["cell_feat"].shape[1],
                              parsed[0]["net_feat"].shape[1], **kw)
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in case["state"].items()})
            state = init_state(model, make_optimizer(case["lr"]), "cpu")
            stacked = stack_designs(
                parsed, align=case["align"], map_size=kw["map_size"],
                device="cpu",
                compute_dtype=torch.bfloat16 if dtype else torch.float32)
            ids, mask = (torch.from_numpy(np.asarray(x))
                         for x in case["batch"])
            preds, mets = multidesign_eval_step(model, stacked, ids, mask,
                                                case["task"], mesh)
            out = {"preds": preds.numpy(),
                   "eval": {k: float(v) for k, v in mets.items()},
                   "losses": [], "checksums": [], "grads": None}
            for t in range(case["steps"]):
                mets = multidesign_train_step(state, stacked, ids, mask,
                                              case["task"], mesh)
                out["losses"].append(float(mets["loss"]))
                if t == 0:
                    out["grads"] = {k: p.grad.numpy().copy()
                                    for k, p in model.named_parameters()}
                out["checksums"].append(
                    float(state.optimizer.flat.double().abs().sum()))
            out["params"] = {k: v.numpy().copy()
                             for k, v in model.state_dict().items()}
            torch.save(out, os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main():
    import torch.multiprocessing as mp

    import prtp_tpu_torch.parallel.multi  # noqa: F401 (the ranks fork)
    import prtp_tpu_torch.trainer  # noqa: F401
    from prtp_tpu_torch.parallel.distributed import free_port

    out_dir = sys.argv[1]
    with open(os.path.join(out_dir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    mp.start_processes(run_rank, args=(2, free_port(), cases, out_dir),
                       nprocs=2, join=True, start_method="fork")
    print("RESULT ok", " ".join(sorted(cases)), flush=True)


if __name__ == "__main__":
    main()
