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


# XLA's CPU compiler rewrites a reduction over more than this many
# elements into windows of this many, then reduces the windows' sums
XLA_REDUCE_WINDOW = 32


def stacked_rows(v: torch.Tensor, pn: int, counts) -> torch.Tensor:
    """The rows of ``v`` (the designs' rows one after another, design d's
    ``counts[d]`` rows) as JAX's ``(K, pn, C)`` stack of the designs
    padded to one bucket of ``pn`` rows: each design's at the start of
    its own block of zeros. A level that no design has is packed as one
    empty row (``graph.py``), which lands nowhere."""
    out = v.new_zeros(len(counts) * pn, v.shape[1])
    if sum(counts):
        at = torch.cat([torch.arange(d * pn, d * pn + c)
                        for d, c in enumerate(counts)]).to(v.device)
        out[at] = v
    return out.view(len(counts), pn, v.shape[1])


def _add_in_order(acc, terms):
    for t in terms:
        acc = acc + t  # a bf16 add: float32, then rounded
    return acc


def _stacked_sums(z: torch.Tensor) -> torch.Tensor:
    """The bf16 sums over the two middle axes of ``z`` ``(G, K, R, C)``,
    as XLA's CPU compiler sums a bf16 reduce over two dimensions: where
    neither exceeds a window, in order, k-major; else each dimension cut
    into windows of 32 with its padding centered, each window summed in
    order (k-major) from 0, then the windows' sums reduced by the same
    rule. The zero rows of K's padding are skipped (adding 0 changes no
    sum). Returns ``(G, C)``."""
    win = XLA_REDUCE_WINDOW
    g, k, r, c = z.shape
    acc = z.new_zeros(g, c)
    if k <= win and r <= win:
        return _add_in_order(acc, (z[:, i, j] for i in range(k)
                                   for j in range(r)))
    pads = []
    for n in (k, r):
        padded = max(-(-n // win), 1) * win
        pads.append(((padded - n) // 2, padded))
    (lo_k, pk), (lo_r, pr) = pads
    full = z.new_zeros(g, pk, pr, c)
    full[:, lo_k:lo_k + k, lo_r:lo_r + r] = z
    w = full.view(g, pk // win, win, pr // win, win, c)
    rows_a = [a for a in range(win)
              if any(lo_k <= i * win + a < lo_k + k for i in range(pk // win))]
    acc = z.new_zeros(g, pk // win, pr // win, c)
    parts = _add_in_order(acc, (w[:, :, a, :, b] for a in rows_a
                                for b in range(win)))
    return _stacked_sums(parts)


def column_sums_bf16(vs, rows=None):
    """The column sums of each bf16 (n_i, C_i) tensor of ``vs``, as XLA's
    CPU compiler sums a bf16 ``reduce_sum`` over the rows: every partial
    sum rounded to bf16, in its tree order. A reduction of at most 32
    rows runs in order from row 0; a longer one is padded with zero rows
    to a multiple of 32, half the padding (rounded down) before row 0,
    and each window of 32 is summed in order, then the windows' sums are
    reduced the same way. ``rows[i]`` (at least n_i) sums tensor i as if
    zero rows followed it up to that many, as a padded table's are: the
    windows then fall elsewhere. ``rows[i]`` may also be ``(pn,
    counts)``: tensor i holds the rows of ``len(counts)`` designs that
    JAX stacks on a bucket of ``pn`` rows (:func:`stacked_rows`), and
    ``jax.vmap`` sums them as one reduce over the design and the row
    dimension, windowed in each (:func:`_stacked_sums`, read from the
    compiled HLO and held against XLA by ``tests/test_torch_multi.py``).
    Returns float32 (C_i,) tensors holding bf16 values.

    One pass of the tree serves every tensor of ``vs`` of one width (or
    stacked shape) at once, so a call launches about 32 additions a level
    and width, not a tensor."""
    win = XLA_REDUCE_WINDOW
    out = [None] * len(vs)
    stacked = {}
    for i, r in enumerate(rows or ()):
        if isinstance(r, tuple):
            z = stacked_rows(vs[i], *r)
            stacked.setdefault(tuple(z.shape), []).append((i, z))
    for items in stacked.values():
        sums = _stacked_sums(torch.stack([z for _i, z in items]))
        for (i, _z), part in zip(items, sums):
            out[i] = part.float()
    cur = {i: v for i, v in enumerate(vs) if out[i] is None}
    # the rows each tensor is summed as: its own, or rows[i] with zeros
    n_sum = {i: max(len(v), 0 if rows is None else rows[i])
             for i, v in cur.items()}
    while cur:
        for width in sorted({v.shape[1] for v in cur.values()}):
            items = [i for i, v in cur.items() if v.shape[1] == width]
            wins = []
            for i in items:
                n = n_sum[i]
                # zero rows before and after: centered to a multiple of
                # the window, or, at most one window, after only
                lo = ((-n) % win) // 2 if n > win else 0
                hi = max(-(-n // win), 1) * win - lo - len(cur[i])
                wins.append(torch.nn.functional.pad(cur[i], (0, 0, lo, hi))
                            .view(-1, win, width))
            w = torch.cat(wins) if len(wins) > 1 else wins[0]
            acc = w[:, 0]
            for j in range(1, win):
                acc = acc + w[:, j]  # a bf16 add: float32, then rounded
            for i, part in zip(items, acc.split([t.shape[0] for t in wins])):
                if n_sum[i] > win:
                    cur[i] = part
                    n_sum[i] = len(part)
                else:
                    out[i] = part[0].float()
                    del cur[i]
    return out


def dense_bf16(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None = None) -> torch.Tensor:
    """flax's ``Dense(dtype=bfloat16)`` for a torch-layout weight ``w``
    (out, in): ``x`` and ``w`` cast to bf16, their product rounded to
    bf16, then the bias cast to bf16 and added, the sum rounded again.
    Two roundings, as flax computes it; ``F.linear`` with a bf16 bias
    rounds once and differs in about a quarter of the outputs."""
    y = matmul_f32(x.to(BF16), w.to(BF16).t()).to(BF16)
    return y if b is None else y + b.to(BF16)
