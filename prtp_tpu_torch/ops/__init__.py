"""Kernels of the level walk and plain ops around them.

``KERNELS`` lists the wrappers that launch a hand-written CUDA kernel;
each keeps an integer ``launches`` count of its kernel launches.
"""

from .fused_gnn import exact_gnn_forward, local_mean, softmax_sum
from .gather import gather_rows
from .pool import pool_2x2

KERNELS = (gather_rows, softmax_sum, local_mean)

__all__ = ["KERNELS", "exact_gnn_forward", "gather_rows", "local_mean",
           "pool_2x2", "softmax_sum"]
