"""LayoutNet — the small 4-conv layout CNN (reference LayoutNet).

Port of ``prtp_tpu/models/layoutnet.py`` in NCHW: 2 input channels,
512x512 input -> 128x128 single-channel output (two stride-2 pools).
Every conv is a SAME-padded (``k // 2``) ``F.conv2d``, its weight
gradient by autograd. The JAX package may run Conv_0 as an im2col GEMM
against a pack-time patch table, for XLA's slow tiny-channel weight
gradient on the TPU; it computes the same function, and on the H100
cuDNN's convolution is the faster of the two, forward and backward, so
the port keeps it. Convs are named ``Conv_0..3`` as the flax modules
are.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.pool import pool_2x2
from .mlp import lecun_normal_

# (in, out, kernel) of Conv_0..3
_CONVS = ((2, 32, 9), (32, 64, 7), (64, 32, 9), (32, 1, 7))


def conv2d(cin: int, cout: int, k: int,
           generator: torch.Generator) -> nn.Conv2d:
    """SAME-padded conv initialised as flax's ``nn.Conv`` (lecun-normal
    kernel over fan-in k*k*cin, zero bias)."""
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k, padding=k // 2)
    lecun_normal_(conv.weight, k * k * cin, generator)
    with torch.no_grad():
        conv.bias.zero_()
    return conv


class LayoutNet(nn.Module):
    def __init__(self, generator: torch.Generator, pooling: str = "max"):
        super().__init__()
        if pooling not in ("max", "avg"):
            raise ValueError(f"wrong pooling type for layoutnet: {pooling}")
        self.pooling = pooling
        for i, (cin, cout, k) in enumerate(_CONVS):
            self.add_module(f"Conv_{i}", conv2d(cin, cout, k, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 2, H, W) -> (N, 1, H/4, W/4)."""
        x = pool_2x2(F.relu(self.Conv_0(x)), self.pooling, "layoutnet")
        x = pool_2x2(F.relu(self.Conv_1(x)), self.pooling, "layoutnet")
        x = F.relu(self.Conv_2(x))
        return F.leaky_relu(self.Conv_3(x), 0.1)
