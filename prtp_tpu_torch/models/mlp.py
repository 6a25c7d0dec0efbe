"""Variadic MLP block and flax's initialisers.

Port of ``prtp_tpu/models/mlp.py`` (reference ``MLP``): a stack of
Linear layers with ReLU (the reference's LeakyReLU at its default slope
0) between layers and none after the last. Layers are named ``fc0, fc1,
...`` as the flax ``Dense`` layers are, so ``utils/convert.py`` maps
them by name.

Parameters are created uninitialised and drawn from an explicit
``torch.Generator`` with flax's distributions (lecun-normal kernels,
zero biases), never from the global RNG; the CLIs then draw the JAX
package's own weights for ``--seed`` over them
(``utils/convert.py::init_from_seed``). They stay float32; with a
bfloat16 compute dtype each layer is flax's ``Dense(dtype=bfloat16)``
(:func:`dense_bf16`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.bf16 import compute_dtype_of, dense_bf16

# flax lecun_normal = variance_scaling(1, "fan_in", "truncated_normal"):
# a standard normal truncated to [-2, 2], rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _norm_cdf(x: float) -> float:
    return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill ``weight`` with flax's lecun-normal draw: a normal of std
    sqrt(1 / fan_in) / _TRUNC_STD truncated at two of it, by the inverse
    CDF (``jax.random.truncated_normal``'s method): one uniform draw from
    ``generator`` an element, through ``erfinv``. So a seed gives the same
    weights whatever ``nn.init.trunc_normal_`` does: PyTorch 2.11's
    computes exactly this, 2.13's redraws the normals that fall outside
    the bounds, another use of the generator's stream."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        weight.uniform_(2 * _norm_cdf(-2.0) - 1, 2 * _norm_cdf(2.0) - 1,
                        generator=generator)
        weight.erfinv_().mul_(std * math.sqrt(2.0))
        return weight.clamp_(-2.0 * std, 2.0 * std)


def linear(in_dim: int, out_dim: int,
           generator: torch.Generator) -> nn.Linear:
    """``nn.Linear`` initialised as flax's ``Dense``."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    lecun_normal_(layer.weight, in_dim, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """Linear stack; ``features`` are the per-layer output sizes.
    ``compute_dtype`` bfloat16 makes each layer :func:`dense_bf16` and
    the output bf16, as flax's ``MLP(dtype=bfloat16)``."""

    def __init__(self, in_dim: int, features: Sequence[int],
                 generator: torch.Generator, compute_dtype=None):
        super().__init__()
        self.num_layers = len(features)
        self.compute_dtype = compute_dtype_of(compute_dtype)
        for i, f in enumerate(features):
            self.add_module(f"fc{i}", linear(in_dim, f, generator))
            in_dim = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            fc = getattr(self, f"fc{i}")
            x = (fc(x) if self.compute_dtype is None
                 else dense_bf16(x, fc.weight, fc.bias))
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x
