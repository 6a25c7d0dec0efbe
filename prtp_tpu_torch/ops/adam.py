"""Flat Adam's update: CUDA kernel and plain version.

Port of the update of ``prtp_tpu/trainer.py::make_flat_adam`` (:81-93):
Adam with coupled L2 weight decay over ONE parameter vector, one
elementwise pass. The kernel is ``csrc/flat_adam.cu``; its source note
gives the bound and the design. For tensors on the CPU the wrapper runs
the plain version; for CUDA tensors it launches the kernel or raises.

The bias corrections ``1 - b ** t`` are computed on the host in float32
(numpy), as JAX computes them in float32 on its device; the two powers
may differ in the last bit, which moves an update by about 1e-7 of
itself.
"""

from __future__ import annotations

from ctypes import c_float, c_int64, c_void_p

import numpy as np
import torch

from . import _build
from .gather import device_of

_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_void_p, c_int64] + \
    [c_float] * 9 + [c_void_p]


def bias_correction(beta: float, t: int) -> float:
    """``1 - beta ** t`` in float32."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(t))


def flat_adam_plain(p, g, mu, nu, lr, b1, b2, eps, wd, t) -> None:
    """JAX's flat Adam update at step ``t`` (1-based), in place on p, mu
    and nu: ``g + wd*p``, the moments, the bias corrections and
    ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)``."""
    if wd:
        g = g + wd * p
    mu.copy_(b1 * mu + (1 - b1) * g)
    nu.copy_(b2 * nu + (1 - b2) * (g * g))
    mu_hat = mu / bias_correction(b1, t)
    nu_hat = nu / bias_correction(b2, t)
    p.add_(-lr * mu_hat / (torch.sqrt(nu_hat) + eps))


def flat_adam(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
              nu: torch.Tensor, lr: float, b1: float, b2: float, eps: float,
              wd: float, t: int) -> None:
    """One Adam step over the flat float32 vectors p (parameters, updated
    in place), g (gradient), mu and nu (moments, updated in place), all
    1-D, contiguous and of one length; ``t >= 1`` is the step count."""
    for what, x in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{what} must be a contiguous 1-D float32 tensor, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.shape != p.shape:
            raise ValueError(f"{what} has {x.shape[0]} elements, p {p.shape[0]}")
    if t < 1:
        raise ValueError(f"step count t must be >= 1, got {t}")
    if device_of("flat_adam", p, g, mu, nu).type == "cpu":
        flat_adam_plain(p, g, mu, nu, lr, b1, b2, eps, wd, t)
        return
    with torch.cuda.device(p.device):
        _build.launch("flat_adam", _ARGTYPES, p.data_ptr(), g.data_ptr(),
                      mu.data_ptr(), nu.data_ptr(), p.shape[0], lr, b1, 1 - b1,
                      b2, 1 - b2, eps, wd, bias_correction(b1, t),
                      bias_correction(b2, t),
                      torch.cuda.current_stream(p.device).cuda_stream)
    flat_adam.launches += 1


flat_adam.launches = 0
