"""U-Net layout branch (reference ``src/Unet.py``).

Port of ``prtp_tpu/models/unet.py`` in NCHW: DoubleConv, Down, Up and
OutConv, a 16/32/64/128 encoder, three decoder ups with skip
connections and an OutConv with an extra pool, so the output map is the
input's side halved (a 256^2 raster gives a 128^2 map). Convolutions are
plain ``F.conv2d``/``F.conv_transpose2d`` (cuDNN on the card), as JAX
runs them as XLA ops outside any Pallas kernel.

Submodules take flax's auto-names (``DoubleConv_0``, ``Down_0..2``,
``Up_0..2``, ``OutConv_0``; inside them ``Conv_0``, ``BatchNorm_0``,
``Conv_1``, ``BatchNorm_1``, ``ConvTranspose_0``), so that
``utils/convert.py`` maps the flax tree by path. Weights follow flax's
initialisers (lecun-normal kernels, zero biases; BatchNorm scale 1, bias
0, running mean 0, variance 1), drawn from the ``generator`` given.

With ``compute_dtype`` bfloat16 (flax's ``dtype``) the convolutions run
on bf16 operands (the biased ones, ``ConvTranspose`` and ``OutConv``,
round twice: ``layoutnet.Conv2d``, :class:`ConvTranspose2d`),
:class:`BatchNorm` computes in float32 from its bf16 input and rounds
once, and the activations, pools, pads and concatenations are bf16; the
parameters and the running averages stay float32.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.bf16 import compute_dtype_of
from ..ops.pool import pool_2x2
from .layoutnet import conv2d
from .mlp import lecun_normal_

# flax nn.BatchNorm(momentum=0.9) and its default epsilon
BN_MOMENTUM, BN_EPS = 0.9, 1e-5
# (out channels of the encoder's DoubleConv and each Down)
_WIDTHS = (16, 32, 64, 128)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9)`` on NCHW, not
    ``nn.BatchNorm2d``'s: in train mode it normalises with the batch
    mean and the biased batch variance over (N, H, W) and updates the
    running averages as ``r = 0.9 r + 0.1 batch`` with the *biased*
    variance too (``BatchNorm2d`` takes the unbiased one there); in eval
    mode it normalises with the running averages. ``weight`` and ``bias``
    are flax's ``scale`` and ``bias``; ``running_mean`` and
    ``running_var`` its ``batch_stats``.

    With ``compute_dtype`` bfloat16, flax's ``BatchNorm(dtype=bfloat16)``
    step by step: the bf16 input taken to float32, the batch statistics
    as flax's fast variance (``E[x^2] - E[x]^2``, at least 0), ``(x -
    mean) * (rsqrt(var + eps) * scale) + bias`` in float32 (the rsqrt
    correctly rounded, as XLA's; ``torch.rsqrt`` on the CPU is not), one
    rounding to bf16; the running averages updated in float32 as
    flax's."""

    def __init__(self, channels: int, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            return self._forward_low(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean,
                                                     alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var,
                                                    alpha=1 - BN_MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=BN_EPS)

    def _forward_low(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            mean = x32.mean(dim=(0, 2, 3))
            var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean, alpha=1 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var, alpha=1 - BN_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt((var + BN_EPS).double()).float() * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.compute_dtype)


class DoubleConv(nn.Module):
    """(3x3 SAME conv without bias => BatchNorm => ReLU) x 2."""

    def __init__(self, cin: int, cout: int, generator: torch.Generator,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.Conv_0 = conv2d(cin, cout, 3, generator, False, dt)
        self.BatchNorm_0 = BatchNorm(cout, dt)
        self.Conv_1 = conv2d(cout, cout, 3, generator, False, dt)
        self.BatchNorm_1 = BatchNorm(cout, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        return F.relu(self.BatchNorm_1(self.Conv_1(x)))


class Down(nn.Module):
    """2x2 pool, then DoubleConv."""

    def __init__(self, cin: int, cout: int, pooling: str,
                 generator: torch.Generator, compute_dtype=None):
        super().__init__()
        self.pooling = pooling
        self.DoubleConv_0 = DoubleConv(cin, cout, generator, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.DoubleConv_0(pool_2x2(x, self.pooling, "unet"))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with flax's compute dtype, as
    ``layoutnet.Conv2d``: under bfloat16 the transposed convolution of
    bf16 operands rounded to bf16, then the bf16 bias added and rounded
    again, as flax's ``nn.ConvTranspose(dtype=bfloat16)``."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                               self.stride)
        return y + self.bias.to(dt)[:, None, None]


class Up(nn.Module):
    """2x2 stride-2 transposed conv with bias, zero-padded to the skip's
    size (the odd row and column at the end), ``[skip, up]`` on
    channels, then DoubleConv."""

    def __init__(self, cin: int, cout: int, generator: torch.Generator,
                 compute_dtype=None):
        super().__init__()
        up = cin // 2
        conv = nn.utils.skip_init(ConvTranspose2d, cin, up, 2, stride=2)
        conv.compute_dtype = compute_dtype_of(compute_dtype)
        # flax's kernel (2, 2, cin, up) has fan-in 2 * 2 * cin
        lecun_normal_(conv.weight, 4 * cin, generator)
        with torch.no_grad():
            conv.bias.zero_()
        self.ConvTranspose_0 = conv
        # the skip has cin / 2 channels too
        self.DoubleConv_0 = DoubleConv(2 * up, cout, generator, compute_dtype)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = self.ConvTranspose_0(x1)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.DoubleConv_0(torch.cat([x2.to(x1.dtype), x1], dim=1))


class OutConv(nn.Module):
    """1x1 conv with bias, 2x2 pool, ReLU."""

    def __init__(self, cin: int, cout: int, pooling: str,
                 generator: torch.Generator, compute_dtype=None):
        super().__init__()
        self.pooling = pooling
        self.Conv_0 = conv2d(cin, cout, 1, generator, True, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(pool_2x2(self.Conv_0(x), self.pooling, "unet"))


class UNet(nn.Module):
    def __init__(self, generator: torch.Generator, pooling: str = "max",
                 in_channels: int = 3, compute_dtype=None):
        super().__init__()
        if pooling not in ("max", "avg"):
            raise ValueError(f"wrong pooling type for unet: {pooling}")
        w0, w1, w2, w3 = _WIDTHS
        dt = compute_dtype
        self.DoubleConv_0 = DoubleConv(in_channels, w0, generator, dt)
        self.Down_0 = Down(w0, w1, pooling, generator, dt)
        self.Down_1 = Down(w1, w2, pooling, generator, dt)
        self.Down_2 = Down(w2, w3, pooling, generator, dt)
        self.Up_0 = Up(w3, w2, generator, dt)
        self.Up_1 = Up(w2, w1, generator, dt)
        self.Up_2 = Up(w1, w0, generator, dt)
        self.OutConv_0 = OutConv(w0, 1, pooling, generator, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C, H, W) -> (N, 1, H/2, W/2)."""
        x1 = self.DoubleConv_0(x)
        x2 = self.Down_0(x1)
        x3 = self.Down_1(x2)
        x4 = self.Down_2(x3)
        x = self.Up_0(x4, x3)
        x = self.Up_1(x, x2)
        x = self.Up_2(x, x1)
        return self.OutConv_0(x)
