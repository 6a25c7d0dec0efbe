"""prtp_tpu_torch — the PyTorch/CUDA port of prtp_tpu for NVIDIA Hopper.

The JAX package ``prtp_tpu`` is the reference; this package imports
nothing of it (nor of JAX). Plain tensor code is PyTorch; the level
walk's row gather and mailbox reductions, its backward's two scatters
and flat Adam's update are hand-written CUDA kernels (``csrc/``), built
with ``nvcc`` at first use. Each kernel has a plain PyTorch version
beside it, which runs for tensors on the CPU. Serving is
``test.evaluate_design``, training ``trainer.train_step``; the CLIs are
``python -m prtp_tpu_torch.data.synthetic``, ``.data.generate``,
``.train`` and ``.test``, with torch checkpoints
(``utils/checkpoint.py``).

Entry points take ``device=`` and default to ``"cuda"``: without a card
they raise instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises if CUDA is asked for
    and absent (no fallback to the CPU — pass ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev
