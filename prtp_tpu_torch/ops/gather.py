"""Row gather ``out = h[idx]``: CUDA kernel and plain version.

Port of the Pallas kernel ``gk`` (``scripts/gather_roofline.py``), the
level walk's one global gather per level pair (``h[gather_rows]`` in
``prtp_tpu/ops/fused_gnn.py``). The port's walk gathers only the net
half's prior rows with it (``ops/fused_gnn.py``); the cell mailbox is
read straight from ``h``. The kernel is ``csrc/gather_rows.cu``;
its source note gives the bound and the design. For a tensor on the CPU
the wrapper runs the plain version; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

from ctypes import c_int64, c_void_p

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_int64, c_int64, c_void_p]


def device_of(what: str, *tensors: torch.Tensor) -> torch.device:
    """The one device of a wrapper's tensors, which must be cpu or cuda."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError(f"{what}: tensors on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    return dev


def gather_rows_plain(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return h.index_select(0, idx)


def gather_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[idx]`` for a contiguous (n, D) float32/bfloat16 ``h`` and int32
    ``idx`` (values in ``[0, n)``, not checked on the device)."""
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous 2-D tensor, got "
                         f"{tuple(h.shape)}")
    if h.dtype not in _DTYPES:
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous 1-D int32 tensor, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if device_of("gather_rows", h, idx).type == "cpu":
        return gather_rows_plain(h, idx)
    out = torch.empty((idx.shape[0], h.shape[1]), dtype=h.dtype,
                      device=h.device)
    with torch.cuda.device(h.device):
        _build.launch("gather_rows", _ARGTYPES, h.data_ptr(), idx.data_ptr(),
                      out.data_ptr(), idx.shape[0],
                      h.shape[1] * h.element_size(),
                      torch.cuda.current_stream(h.device).cuda_stream)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
