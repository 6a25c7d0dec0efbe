"""Child process of ``tests/test_torch_dp.py``'s two-process run.

Usage:
  python _torch_dp_child.py <process_id> <coordinator_port>   # a rank
  python _torch_dp_child.py ref                               # one process

A rank joins a 2-process gloo group through the same env-gated entry the
CLIs call (``prtp_tpu_torch.parallel.maybe_initialize``) and runs ONE
data-parallel train step over the group, on the CPU; ``ref`` runs the
same step in one process with ``trainer.train_step``. Both build the same
tiny model and design from seeds, and print a RESULT line: the loss and
a checksum of the parameters after the step.
"""

import os
import sys


def run_step(mesh):
    import numpy as np
    import torch

    from prtp_tpu_torch.data.random_design import make_random_design
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.parallel.dp import broadcast_state, dp_train_step
    from prtp_tpu_torch.trainer import (init_state, make_optimizer,
                                        pad_batch, train_step)

    parsed = make_random_design([16, 24, 16, 8], cell_feat_dim=12,
                                net_feat_dim=3, map_size=16, cnn_hw=64,
                                seed=3)
    design = pack_design(parsed, map_size=16, device="cpu")
    model = PathModel(12, 3, out_dim=16, hidden_dim=32, cnn_outdim=8,
                      map_size=16, global_dim=8,
                      generator=torch.Generator().manual_seed(0))
    state = init_state(model, make_optimizer(1e-3), "cpu")
    ids, mask = pad_batch(np.arange(min(15, design.num_paths)), 16, "cpu")
    if mesh is None:
        mets = train_step(state, design, ids, mask)
        rank, world = 0, 1
    else:
        broadcast_state(state, mesh)
        mets = dp_train_step(state, design, ids, mask, mesh)
        rank, world = mesh.rank, mesh.size
    checksum = float(state.optimizer.flat.double().abs().sum())
    print(f"RESULT rank={rank} world={world} loss={float(mets['loss']):.9g} "
          f"checksum={checksum:.12g}", flush=True)


def main():
    if sys.argv[1] == "ref":
        run_step(None)
        return
    os.environ["PRTP_COORDINATOR"] = f"127.0.0.1:{sys.argv[2]}"
    os.environ["PRTP_NUM_PROCESSES"] = "2"
    os.environ["PRTP_PROCESS_ID"] = sys.argv[1]
    from prtp_tpu_torch.parallel import Mesh, maybe_initialize

    assert maybe_initialize("cpu"), "the env-gated join did not happen"
    assert not maybe_initialize("cpu"), "a second join must do nothing"
    run_step(Mesh.of_group())


if __name__ == "__main__":
    main()
