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

With ``compute_dtype`` bfloat16 (flax's ``dtype``) every conv runs on
bf16 operands and rounds twice (:class:`Conv2d`), and the activations,
the pools and the output are bf16; the parameters stay float32.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.bf16 import compute_dtype_of
from ..ops.pool import pool_2x2
from .mlp import lecun_normal_

# (in, out, kernel) of Conv_0..3
_CONVS = ((2, 32, 9), (32, 64, 7), (64, 32, 9), (32, 1, 7))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's compute dtype ``compute_dtype`` (None:
    float32, the module's own forward). Under bfloat16, flax's
    ``nn.Conv(dtype=bfloat16)``: the input and the weight cast to bf16,
    the convolution's output rounded to bf16 (``F.conv2d`` on bf16
    operands: cuDNN on the card), then the bias cast to bf16 and added as
    a separate step, rounded again (``F.conv2d`` with a bf16 bias rounds
    once)."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                     self.padding)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


def conv2d(cin: int, cout: int, k: int, generator: torch.Generator,
           bias: bool = True, compute_dtype=None) -> Conv2d:
    """SAME-padded conv initialised as flax's ``nn.Conv`` (lecun-normal
    kernel over fan-in k*k*cin, zero bias), computing in
    ``compute_dtype``."""
    conv = nn.utils.skip_init(Conv2d, cin, cout, k, padding=k // 2,
                              bias=bias)
    conv.compute_dtype = compute_dtype_of(compute_dtype)
    lecun_normal_(conv.weight, k * k * cin, generator)
    if bias:
        with torch.no_grad():
            conv.bias.zero_()
    return conv


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu`` in ``x``'s dtype. In bf16 JAX rounds the
    slope to bf16 first (0.1 becomes 0.10009765625) and the product
    after; ``F.leaky_relu`` multiplies by the float32 slope."""
    if x.dtype == torch.float32:
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x,
                       x * float(torch.tensor(slope, dtype=x.dtype)))


class LayoutNet(nn.Module):
    def __init__(self, generator: torch.Generator, pooling: str = "max",
                 compute_dtype=None):
        super().__init__()
        if pooling not in ("max", "avg"):
            raise ValueError(f"wrong pooling type for layoutnet: {pooling}")
        self.pooling = pooling
        for i, (cin, cout, k) in enumerate(_CONVS):
            self.add_module(f"Conv_{i}", conv2d(cin, cout, k, generator,
                                                compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 2, H, W) -> (N, 1, H/4, W/4), in the compute dtype."""
        x = pool_2x2(F.relu(self.Conv_0(x)), self.pooling, "layoutnet")
        x = pool_2x2(F.relu(self.Conv_1(x)), self.pooling, "layoutnet")
        x = F.relu(self.Conv_2(x))
        return leaky_relu(self.Conv_3(x), 0.1)
