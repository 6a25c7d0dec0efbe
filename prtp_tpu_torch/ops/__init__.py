"""Kernels of the level walk, of the segment reduce and of flat Adam, and
plain ops around them.

``KERNELS`` lists the wrappers that launch a hand-written CUDA kernel;
each keeps an integer ``launches`` count of its kernel launches.
"""

from .adam import flat_adam
from .fused_gnn import (attn_bwd, attn_sum, exact_gnn_forward, exact_walk,
                        local_mean, mailbox_scatter, softmax_sum,
                        softmax_sum_bwd)
from .gather import gather_rows
from .pool import pool_2x2
from .segment_kernels import (segment_attn_bwd, segment_attn_sum,
                              segment_mean, segment_softmax_sum,
                              segment_softmax_sum_bwd)
from .segment_walk import segment_walk

KERNELS = (gather_rows, softmax_sum, local_mean, softmax_sum_bwd,
           mailbox_scatter, flat_adam, attn_sum, attn_bwd,
           segment_softmax_sum, segment_mean, segment_softmax_sum_bwd,
           segment_attn_sum, segment_attn_bwd)

__all__ = ["KERNELS", "attn_bwd", "attn_sum", "exact_gnn_forward",
           "exact_walk", "flat_adam", "gather_rows", "local_mean",
           "mailbox_scatter", "pool_2x2", "segment_attn_bwd",
           "segment_attn_sum", "segment_mean",
           "segment_softmax_sum", "segment_softmax_sum_bwd", "segment_walk",
           "softmax_sum", "softmax_sum_bwd"]
