"""bfloat16 compute at the JAX package's rounding points.

Under ``--compute_dtype bfloat16`` the JAX package keeps float32
parameters and casts them, with the inputs, to bf16 for its products. It
rounds their results in two ways, and the port keeps both:

- the level walk's pair-step MLPs (``prtp_tpu/ops/fused_gnn.py::_mm``):
  bf16 operands, the product accumulated and *returned* in float32
  (``preferred_element_type=jnp.float32``), the bias, the carry and every
  reduce in float32: :func:`mm_f32`;
- flax's ``Dense`` and ``Conv`` with ``dtype=bfloat16`` (the fusion head,
  the layout CNNs): the product rounded to bf16, then the bf16 bias
  added and the sum rounded again: :func:`dense_bf16`. The pair-step
  MLPs of the padded scan that JAX evaluates through are flax's bf16
  ``Dense`` too, but for the output layer's last rounding, which XLA
  drops (``ops/fused_gnn.py::_mlp``).

A product of two bf16 values is exact in float32, so :func:`mm_f32`
differs from JAX only in the order of its float32 sum. On the CPU it is
the float32 product of the bf16 operands; on the card one bf16 GEMM
with a float32 output (``torch.mm(..., out_dtype=torch.float32)``). It
never runs a GEMM whose output is bf16, which would round where JAX does
not, and where this torch lacks that call it raises.
"""

from __future__ import annotations

import torch

BF16 = torch.bfloat16


def compute_dtype_of(value):
    """A model's compute dtype: ``None`` for float32 (``None``,
    ``torch.float32`` or ``"float32"``), ``torch.bfloat16`` for
    ``torch.bfloat16`` or ``"bfloat16"``; anything else raises."""
    if value is None or value in (torch.float32, "float32"):
        return None
    if value in (torch.bfloat16, "bfloat16"):
        return BF16
    raise ValueError(f"compute_dtype {value!r}: float32 or bfloat16")


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 2-D bf16 tensors, accumulated and returned in
    float32 (JAX's ``_mm`` with bf16 operands)."""
    if a.dtype != BF16 or b.dtype != BF16:
        raise TypeError(f"mm_f32 takes bf16 operands, got {a.dtype} and "
                        f"{b.dtype}")
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    """:func:`mm_f32` with a gradient. The cotangent is rounded to bf16
    and each input's gradient is a :func:`mm_f32` rounded to the input's
    dtype: flax's bf16 ``Dense`` transposes to bf16 products with bf16
    results. (Its callers round the product to bf16 at once, so the
    cotangent already holds bf16 values.)"""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return mm_f32(a, b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(BF16)
        da = (mm_f32(g, b.t()).to(a.dtype) if ctx.needs_input_grad[0]
              else None)
        db = (mm_f32(a.t(), g).to(b.dtype) if ctx.needs_input_grad[1]
              else None)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`mm_f32`, differentiable."""
    return _MatmulF32.apply(a, b)


def dense_bf16(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None = None) -> torch.Tensor:
    """flax's ``Dense(dtype=bfloat16)`` for a torch-layout weight ``w``
    (out, in): ``x`` and ``w`` cast to bf16, their product rounded to
    bf16, then the bias cast to bf16 and added, the sum rounded again.
    Two roundings, as flax computes it; ``F.linear`` with a bf16 bias
    rounds once and differs in about a quarter of the outputs."""
    y = matmul_f32(x.to(BF16), w.to(BF16).t()).to(BF16)
    return y if b is None else y + b.to(BF16)
