"""Reshape-based 2x2/stride-2 pooling on NCHW tensors.

Port of ``prtp_tpu/ops/pool.py``. The reshape + axis reduction gives the
same forward values as a windowed pool; its gradient splits among EXACT
ties inside a window, as JAX's does, where ``F.max_pool2d`` routes to
one element — so the later backward keeps JAX's tie routing.

In bf16 the odd-extent average is JAX's ``nn.avg_pool``: the window
summed in the order (0, 0), (0, 1), (1, 0), (1, 1), rounded to bf16
after each add, then divided by 4 (``F.avg_pool2d`` sums in float32 and
rounds once). The even-extent mean and every max are the same in any
dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pool_2x2(x: torch.Tensor, pooling: str, what: str = "pool") -> torch.Tensor:
    """2x2/stride-2 max or avg pool on NCHW ``x``."""
    if pooling not in ("max", "avg"):
        raise ValueError(f"wrong pooling type for {what}: {pooling}")
    n, c, h, w = x.shape
    if h % 2 or w % 2:  # odd extent: the windowed form (floors the edge)
        if pooling == "max":
            return F.max_pool2d(x, 2)
        if x.dtype == torch.float32:
            return F.avg_pool2d(x, 2)
        h2, w2 = h - h % 2, w - w % 2
        s = x[:, :, 0:h2:2, 0:w2:2] + x[:, :, 0:h2:2, 1:w2:2]
        s = s + x[:, :, 1:h2:2, 0:w2:2]
        return (s + x[:, :, 1:h2:2, 1:w2:2]) / 4
    x6 = x.reshape(n, c, h // 2, 2, w // 2, 2)
    if pooling == "max":
        return x6.amax(dim=(3, 5))
    return x6.mean(dim=(3, 5))
