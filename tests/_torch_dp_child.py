"""Child process of ``tests/test_torch_dp.py``'s two-process run.

Usage:
  python _torch_dp_child.py <process_id> <coordinator_port> [<dir>]  # a rank
  python _torch_dp_child.py ref [<dir>]                         # one process

A rank joins a 2-process gloo group through the same env-gated entry the
CLIs call (``prtp_tpu_torch.parallel.maybe_initialize``) and runs ONE
data-parallel train step over the group, on the CPU; ``ref`` runs the
same step in one process with ``trainer.train_step``. Both build the same
tiny model and design from seeds, and print a RESULT line: the loss and
a checksum of the parameters after the step. With ``<dir>`` each then
runs the step of the same model in bf16 (JAX's padded scan's rounding,
its bias sums over the rows of JAX's pack aligned to 8) and writes the
loss, the first step's gradients and the parameters' checksum to
``<dir>/bf16_<rank or ref>.pt``.
"""

import os
import sys


def tiny_inputs(compute_dtype=None):
    """The design (seed 3, its raw parsed dict too), the model (seed 0)
    and the padded batch of every run of this file, the model in
    ``compute_dtype``; a bf16 design's pack is bf16 with JAX's padded
    level rows (align 8)."""
    import numpy as np
    import torch

    from prtp_tpu_torch.data.random_design import make_random_design
    from prtp_tpu_torch.graph import pack_design, scan_pair_rows
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.trainer import pad_batch

    parsed = make_random_design([16, 24, 16, 8], cell_feat_dim=12,
                                net_feat_dim=3, map_size=16, cnn_hw=64,
                                seed=3)
    pack = ({} if compute_dtype is None else
            dict(compute_dtype=torch.bfloat16,
                 scan_rows=scan_pair_rows(parsed, align=8)))
    design = pack_design(parsed, map_size=16, device="cpu", **pack)
    model = PathModel(12, 3, out_dim=16, hidden_dim=32, cnn_outdim=8,
                      map_size=16, global_dim=8, compute_dtype=compute_dtype,
                      generator=torch.Generator().manual_seed(0))
    ids, mask = pad_batch(np.arange(min(15, design.num_paths)), 16, "cpu")
    return parsed, design, model, ids, mask


def run_step(mesh, out_dir=None):
    import torch

    from prtp_tpu_torch.parallel.dp import broadcast_state, dp_train_step
    from prtp_tpu_torch.trainer import init_state, make_optimizer, train_step

    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    for dtype in (None, "bfloat16") if out_dir else (None,):
        _parsed, design, model, ids, mask = tiny_inputs(dtype)
        state = init_state(model, make_optimizer(1e-3), "cpu")
        rounding = None if dtype is None else "scan"
        if mesh is None:
            mets = train_step(state, design, ids, mask, rounding=rounding)
        else:
            broadcast_state(state, mesh)
            mets = dp_train_step(state, design, ids, mask, mesh,
                                 rounding=rounding)
        checksum = float(state.optimizer.flat.double().abs().sum())
        if dtype is None:
            print(f"RESULT rank={rank} world={world} "
                  f"loss={float(mets['loss']):.9g} checksum={checksum:.12g}",
                  flush=True)
            continue
        tag = "ref" if mesh is None else rank
        torch.save({"loss": float(mets["loss"]), "checksum": checksum,
                    "grads": {k: p.grad.clone()
                              for k, p in model.named_parameters()}},
                   os.path.join(out_dir, f"bf16_{tag}.pt"))


def main():
    if sys.argv[1] == "ref":
        run_step(None, sys.argv[2] if len(sys.argv) > 2 else None)
        return
    os.environ["PRTP_COORDINATOR"] = f"127.0.0.1:{sys.argv[2]}"
    os.environ["PRTP_NUM_PROCESSES"] = "2"
    os.environ["PRTP_PROCESS_ID"] = sys.argv[1]
    from prtp_tpu_torch.parallel import Mesh, maybe_initialize

    assert maybe_initialize("cpu"), "the env-gated join did not happen"
    assert not maybe_initialize("cpu"), "a second join must do nothing"
    run_step(Mesh.of_group(), sys.argv[3] if len(sys.argv) > 3 else None)


if __name__ == "__main__":
    main()
