"""One PyTorch thread a test process.

The suite runs in several worker processes at once (pytest-xdist), each
beside JAX's own threads, and PyTorch's default of one intra-op thread
a core makes every worker's CPU ops contend for all the cores: the
port's heaviest test files took 1.4x as long in all (a run of six of
them at ``-n 6``). Every ``tests/test_torch_*.py`` imports this module,
so it runs at each worker's collection: this process gets one PyTorch
thread, and the processes the tests start (CLI children, gloo ranks)
one each through ``OMP_NUM_THREADS``.
"""

import os

import torch

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)
