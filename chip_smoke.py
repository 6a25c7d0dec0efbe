#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (prtp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (nonzero exit) on any error:

1. Print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions; turn TF32 off for matmuls and convolutions (the slice
   is float32).
2. Build every CUDA kernel of the path from ``prtp_tpu_torch/csrc``.
3. Build and pack two designs: the bench headline (80k nodes, 20
   levels, seed 7), whose net drivers all lie in the pair's own cell
   level, and the same design with 10% of each net level's drivers moved
   to an earlier cell level (prior rows). On each, hold every kernel
   against its plain PyTorch version on the card at every shape the walk
   gives it (an all-invalid mailbox row added), timing kernel, plain
   version, and the one PyTorch call that computes the same function
   where there is one. Then each kernel's per-call floor (a one-row call,
   same timer), the kernels' other code paths at edge shapes, and the
   row gather at the TPU probe's shapes (160,000 x 128 bf16, 129,202
   rows).
4. The slice: the full-width float32 regression fusion model, random
   weights from a seed, answers three evaluation requests on the
   headline and one on the prior-row design through ``evaluate_design``;
   the launch counters, zeroed just before each design's requests, must
   show every kernel of that design's walk ran as often as its tables
   say; the predictions must match the same model and design on the CPU
   (plain versions) at rtol/atol 1e-4.
5. Where one request's time goes: device time of the forward, the walk
   and LayoutNet (CUDA events), the device's busy and idle share of an
   evaluate call, and each kernel's in-walk time and count on both
   designs (torch.profiler).

Then one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``. Without a card, or without the package beside it,
the script exits nonzero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

# bench.py's headline design (build_design)
NODES, LEVELS, DECAY, SEED = 80_000, 20, 0.8, 7
CELL_FEAT, NET_FEAT, MAP_SIZE, CNN_HW, MASK_NNZ = 36, 3, 128, 512, 96
PRIOR_SHARE = 0.1  # share of each net level's drivers moved to prior rows
REQUESTS = 3
# H100 SXM peak rates (dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPS, WARMUP = 10, 2
SPIN_CYCLES_PER_MS = 2_000_000  # about the H100's SM clock
DEVICE = "cuda:0"
D = 128  # the walk's row width (out_dim)
# kernel: (source, TPU kernel or JAX op it replaces, design of its row)
KERNEL_INFO = {
    "gather_rows": ("prtp_tpu_torch/csrc/gather_rows.cu",
                    "scripts/gather_roofline.py:142", "prior_rows"),
    "softmax_sum": ("prtp_tpu_torch/csrc/softmax_sum.cu",
                    "prtp_tpu/ops/fused_gnn.py:72", "headline"),
    "local_mean": ("prtp_tpu_torch/csrc/local_mean.cu",
                   "prtp_tpu/ops/fused_gnn.py:194", "headline"),
}


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call with a cold L2: before each call a 128 MB
    buffer is overwritten (the card's L2 holds 50 MB), then a spin kernel
    holds the stream for about ``queue_ms`` while the host enqueues the
    call, so the CUDA events around it bracket device work only, not the
    host's launch overhead. ``queue_ms=0`` times the call as launched,
    host gaps included."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                 device=device)

    def ms(self, fn, queue_ms=0.5) -> float:
        torch = self.torch
        for _ in range(WARMUP):
            fn()
        pairs = []
        for _ in range(REPS):
            self.flush.zero_()
            if queue_ms:
                torch.cuda._sleep(int(queue_ms * SPIN_CYCLES_PER_MS))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / REPS


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class KernelRecord:
    """Sums one kernel's numbers over the calls of one forward of one
    design."""

    def __init__(self, name, design):
        self.name, self.design = name, design
        self.source, self.replaces, _ = KERNEL_INFO[name]
        self.ms = self.plain_ms = 0.0
        self.library_ms = None
        self.bytes = self.ops = 0.0
        self.max_abs_err = 0.0
        self.calls = 0
        self.floor_ms = None
        self.launches = {}

    def add(self, ms, plain_ms, library_ms, nbytes, ops, err):
        self.ms += ms
        self.plain_ms += plain_ms
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms
        self.bytes += nbytes
        self.ops += ops
        self.max_abs_err = max(self.max_abs_err, err)
        self.calls += 1

    def summary(self) -> str:
        b = bound(self.bytes, self.ops)[0]
        return (f"{self.name} ({self.design}): {self.calls} calls, "
                f"{self.ms:.4f} ms per forward; less {self.calls} x floor "
                f"{self.floor_ms:.4f} ms: {self.ms - self.calls * self.floor_ms:.4f}"
                f" ms; bound {b:.4f} ms; plain {self.plain_ms:.4f} ms; "
                f"library {self.library_ms}")

    def as_json(self):
        bound_ms, bound_by = bound(self.bytes, self.ops)
        return {"name": self.name, "ok": True, "route": "cuda",
                "source": self.source, "replaces": self.replaces,
                "launches": sum(self.launches.values()),
                "launches_by_design": self.launches,
                "design": self.design, "calls_per_forward": self.calls,
                "max_abs_err": self.max_abs_err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": self.library_ms,
                "floor_ms": self.floor_ms,
                "ms_less_floor": self.ms - self.calls * self.floor_ms}


def launches_per_forward(graph) -> dict:
    """Each kernel's launches in one walk of ``graph``: the prior-row
    gather only for pairs with prior rows, the cell reduce for pairs
    k > 0, the net mean for every pair."""
    return {
        "gather_rows": sum(
            1 for k in range(graph.num_pairs)
            if graph.gather_rows[k].numel() > graph.cell_mail[k].numel()),
        "softmax_sum": graph.num_pairs - 1,
        "local_mean": graph.num_pairs,
    }


def check_kernels(torch, F, graph, dev, timer, design):
    """Phase 3: every kernel against its plain version at the walk's
    shapes on ``graph``, with a random state ``h``. Bytes count what a
    call must move: the distinct valid rows it reads, its indices and
    its output. Returns ``{name: KernelRecord}``."""
    from prtp_tpu_torch.ops.fused_gnn import (local_mean, local_mean_plain,
                                              softmax_sum, softmax_sum_plain)
    from prtp_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    gen = torch.Generator(device=dev).manual_seed(SEED)
    num_rows = graph.num_rows
    h = torch.randn((num_rows + 1, D), generator=gen, device=dev)
    row_b = D * 4
    recs = {name: KernelRecord(name, design) for name in KERNEL_INFO}
    for k in range(graph.num_pairs):
        cell_mail = graph.cell_mail[k]
        pn_c, md_c = cell_mail.shape
        # ---- gather_rows: the prior rows only, exact ----
        prior_rows = graph.gather_rows[k][pn_c * md_c:]
        prior = gather_rows_plain(h, prior_rows)
        if prior_rows.numel():
            out = gather_rows(h, prior_rows)
            torch.cuda.synchronize()
            if not torch.equal(out, prior):
                raise AssertionError(f"gather_rows differs at pair {k}")
            nbytes = (torch.unique(prior_rows).numel() * row_b
                      + prior_rows.numel() * (row_b + 4))
            ms = timer.ms(lambda: gather_rows(h, prior_rows))
            pms = timer.ms(lambda: gather_rows_plain(h, prior_rows))
            lms = timer.ms(lambda: torch.index_select(h, 0, prior_rows))
            recs["gather_rows"].add(ms, pms, lms, nbytes, 0.0, 0.0)
            log(f"  gather_rows pair {k}: {prior_rows.numel()} prior rows x "
                f"{D} f32  kernel {ms:.4f} ms  plain {pms:.4f}  index_select "
                f"{lms:.4f}  bound {bound(nbytes, 0)[0]:.4f}  exact")
        # ---- softmax_sum: the cell mailbox from h, row 0 all-invalid ----
        if k > 0:
            idx = cell_mail.clone()
            idx[0] = num_rows
            out = softmax_sum(h, idx, num_rows)
            want = softmax_sum_plain(h, idx, num_rows)
            err = float((out - want).abs().max())
            if not (torch.allclose(out, want, rtol=1e-5, atol=1e-6)
                    and bool(torch.isfinite(out).all())
                    and not bool(out[0].any())):
                raise AssertionError(f"softmax_sum differs at pair {k}: "
                                     f"max abs err {err}")
            used = idx[idx != num_rows]
            nbytes = (torch.unique(used).numel() * row_b + idx.numel() * 4
                      + pn_c * row_b)
            ops = 6.0 * used.numel() * D
            ms = timer.ms(lambda: softmax_sum(h, idx, num_rows))
            pms = timer.ms(lambda: softmax_sum_plain(h, idx, num_rows))
            recs["softmax_sum"].add(ms, pms, None, nbytes, ops, err)
            log(f"  softmax_sum pair {k}: ({pn_c}, {md_c}) of {D} f32, "
                f"{used.numel()} valid slots  kernel {ms:.4f} ms  plain "
                f"{pms:.4f}  bound {bound(nbytes, ops)[0]:.4f}  "
                f"({nbytes / ms / 1e9:.3f} TB/s)  max abs err {err:.3g}")
        # ---- local_mean: new | prior, row 0 all-invalid ----
        new = torch.randn((pn_c, D), generator=gen, device=dev)
        num_valid = pn_c + prior.shape[0]
        idx_n = graph.net_local_idx[k].clone()
        idx_n[0] = num_valid
        out = local_mean(new, prior, idx_n)
        want = local_mean_plain(new, prior, idx_n)
        # the library yardstick needs the [new | prior | 0] buffer, built
        # outside its timed call
        buf = torch.cat([new, prior, new.new_zeros((1, D))])
        idx_l = idx_n.long()
        lib = F.embedding_bag(idx_l, buf, mode="mean", padding_idx=num_valid)
        err = float((out - want).abs().max())
        if not (torch.allclose(out, want, rtol=1e-5, atol=1e-6)
                and torch.allclose(lib, want, rtol=1e-5, atol=1e-6)
                and not bool(out[0].any())):
            raise AssertionError(f"local_mean differs at pair {k}: max abs "
                                 f"err {err}")
        used = idx_n[idx_n < num_valid]
        nbytes = (torch.unique(used).numel() * row_b + idx_n.numel() * 4
                  + idx_n.shape[0] * row_b)
        ops = float(used.numel() * D)
        ms = timer.ms(lambda: local_mean(new, prior, idx_n))
        pms = timer.ms(lambda: local_mean_plain(new, prior, idx_n))
        lms = timer.ms(lambda: F.embedding_bag(idx_l, buf, mode="mean",
                                               padding_idx=num_valid))
        recs["local_mean"].add(ms, pms, lms, nbytes, ops, err)
        log(f"  local_mean pair {k}: {tuple(idx_n.shape)} from {pn_c} new + "
            f"{prior.shape[0]} prior rows  kernel {ms:.4f} ms  plain "
            f"{pms:.4f}  embedding_bag {lms:.4f}  bound "
            f"{bound(nbytes, ops)[0]:.4f}  max abs err {err:.3g}")
    return recs


def call_floors(torch, graph, dev, timer) -> dict:
    """Each kernel timed on a one-row call with the phase's timer: what a
    call costs whatever its size."""
    from prtp_tpu_torch.ops.fused_gnn import local_mean, softmax_sum
    from prtp_tpu_torch.ops.gather import gather_rows

    h = torch.randn((graph.num_rows + 1, D), device=dev)
    one_row = graph.cell_mail[1][:1]
    new = torch.randn((1, D), device=dev)
    idx_n = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    return {
        "gather_rows": timer.ms(lambda: gather_rows(h, one_row[0, :1])),
        "softmax_sum": timer.ms(
            lambda: softmax_sum(h, one_row, graph.num_rows)),
        "local_mean": timer.ms(lambda: local_mean(new, new[:0], idx_n)),
    }


def check_edge_shapes(torch, dev):
    """The kernels' other code paths, which the headline does not reach,
    each against its plain version: every vector width of the gather
    (row sizes and a misaligned base pointer); for the reductions one
    slot, long mailboxes (k > 8: the generic path), rows of D % 4 != 0
    and misaligned views (the scalar path), narrow and wide rows, no
    prior rows, all-invalid rows, a NaN in a valid slot, empty inputs."""
    from prtp_tpu_torch.ops.fused_gnn import (local_mean, local_mean_plain,
                                              softmax_sum, softmax_sum_plain)
    from prtp_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rows(n, d, misaligned=False):
        """(n, d) float32 rows; misaligned: a contiguous view 4 bytes off
        16-byte alignment."""
        if misaligned:
            return randn(n * d + 1)[1:].view(n, d)
        return randn(n, d) * 4

    def mailbox(p, k, invalid):
        """(p, k) int32 slots in [0, invalid]; about a third invalid, row
        0 all-invalid."""
        idx = torch.randint(0, invalid, (p, k), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[torch.rand((p, k), generator=gen, device=dev) < 0.35] = invalid
        if p:
            idx[0] = invalid
        return idx

    def same(out, want, p, nan_at=None):
        ok = (out.shape == want.shape
              and torch.allclose(out, want, rtol=1e-5, atol=1e-6,
                                 equal_nan=True)
              and (p == 0 or not bool(out[0].any())))
        if nan_at is None:
            return ok and bool(torch.isfinite(out).all())
        return ok and bool(out[nan_at].isnan())

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 3, 20, 128, 300):
            for offset in (0, 1):  # 1: base pointer off 16-byte alignment
                h = randn(1000 * d + offset).to(dtype)[offset:].view(1000, d)
                for m in (0, 777):
                    idx = torch.randint(0, 1000, (m,), generator=gen,
                                        device=dev, dtype=torch.int32)
                    if not torch.equal(gather_rows(h, idx),
                                       gather_rows_plain(h, idx)):
                        raise AssertionError(f"gather_rows differs: {dtype} "
                                             f"d={d} offset={offset} m={m}")
                    cases += 1
    # softmax_sum: (P, K, D, rows of h, case)
    for p, k, d, r, case in ((0, 4, 128, 50, "empty"),
                             (300, 1, 20, 500, "k=1, 5 lanes a row"),
                             (300, 2, 4, 500, "D=4, 16 rows a warp"),
                             (300, 8, 300, 900, "k=8, 75 float4s a row"),
                             (300, 11, 128, 900, "k>8"),
                             (50, 40, 7, 200, "k>8, D%4!=0"),
                             (300, 3, 7, 500, "D%4!=0"),
                             (300, 4, 128, 500, "misaligned h"),
                             (300, 4, 128, 500, "NaN")):
        h = rows(r, d, misaligned=case == "misaligned h")
        idx = mailbox(p, k, r - 1)
        nan_at = None
        if case == "NaN":
            idx[1, 0] = 5
            h[5, 2] = float("nan")
            nan_at = (1, 2)
        out, want = softmax_sum(h, idx, r - 1), softmax_sum_plain(h, idx, r - 1)
        if not same(out, want, p, nan_at):
            raise AssertionError(f"softmax_sum differs at {(p, k, d)} {case}")
        cases += 1
    # local_mean: (P, K, D, new rows, prior rows, case)
    for p, k, d, n, n_prior, case in (
            (0, 1, 128, 10, 0, "empty"),
            (300, 1, 128, 200, 0, "k=1, no prior rows"),
            (300, 1, 128, 200, 60, "k=1"),
            (300, 5, 20, 60, 30, "k=5, 5 lanes a row"),
            (300, 1, 300, 40, 0, "k=1, 75 float4s a row"),
            (300, 3, 7, 50, 20, "D%4!=0"),
            (64, 33, 128, 300, 200, "k>8"),
            (64, 33, 7, 300, 0, "k>8, D%4!=0, no prior rows"),
            (300, 2, 128, 50, 20, "misaligned new"),
            (300, 2, 128, 50, 20, "misaligned prior"),
            (300, 2, 128, 50, 20, "NaN")):
        new = rows(n, d, misaligned=case == "misaligned new")
        prior = rows(n_prior, d, misaligned=case == "misaligned prior")
        idx = mailbox(p, k, n + n_prior)
        nan_at = None
        if case == "NaN":
            idx[1, 0] = 3
            new[3, 2] = float("nan")
            nan_at = (1, 2)
        out = local_mean(new, prior, idx)
        want = local_mean_plain(new, prior, idx)
        if not same(out, want, p, nan_at):
            raise AssertionError(f"local_mean differs at {(p, k, d, n, n_prior)}"
                                 f" {case}")
        cases += 1
    log(f"  edge shapes: {cases} cases of the three kernels match their "
        "plain versions (gather exact; reductions rtol 1e-5, atol 1e-6, "
        "NaN where the plain version has it)")


def gather_probe(torch, dev, timer):
    """The TPU probe's shapes (scripts/gather_roofline.py): 160,000 x 128
    bf16 rows, 129,202 random indices."""
    from prtp_tpu_torch.ops.gather import gather_rows
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((160_000, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    idx = torch.randint(0, 160_000, (129_202,), generator=gen, device=dev,
                        dtype=torch.int32)
    out = gather_rows(h, idx)
    if not torch.equal(out, torch.index_select(h, 0, idx)):
        raise AssertionError("gather_rows differs at the probe's shapes")
    nbytes = (torch.unique(idx).numel() + idx.numel()) * 256 + idx.numel() * 4
    ms = timer.ms(lambda: gather_rows(h, idx))
    lms = timer.ms(lambda: torch.index_select(h, 0, idx))
    log(f"  gather_rows probe: 129202 x 128 bf16 from 160000 rows  kernel "
        f"{ms:.4f} ms  index_select {lms:.4f}  bound "
        f"{bound(nbytes, 0)[0]:.4f}  ({nbytes / ms / 1e6:.1f} GB/s)  exact")


def serve(torch, np, model, model_cpu, parsed, design, per_forward,
          requests):
    """Phase 4 for one design: ``requests`` evaluation requests on the
    card with the launch counters zeroed just before and read just after
    (each must equal ``requests`` x its per-forward count, and every
    kernel of the walk must have run), then the same model on the CPU.
    Returns the launch counts."""
    from prtp_tpu_torch.ops import KERNELS
    from prtp_tpu_torch.test import evaluate_design

    torch.cuda.synchronize()
    for kern in KERNELS:
        kern.launches = 0
    outs = []
    for req in range(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, mets = evaluate_design(model, parsed, device=DEVICE,
                                      case_idx=req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs.append(preds)
        log(f"  {design} request {req}: wall {wall * 1e3:.2f} ms (pack "
            f"{mets['pack_s'] * 1e3:.2f} ms, evaluate "
            f"{mets['runtime'] * 1e3:.2f} ms)  loss {mets['loss']:.6f}  "
            f"r2 {mets['r2']:.6f}  tp {mets['tp']:.0f} fp {mets['fp']:.0f} "
            f"tn {mets['tn']:.0f} fn {mets['fn']:.0f}")
    counts = {kern.__name__: kern.launches for kern in KERNELS}
    log(f"  {design}: launches in {requests} request(s): {counts}; per "
        f"forward expected {per_forward}")
    for name, n in per_forward.items():
        if counts[name] != requests * n:
            raise AssertionError(f"{design}: {name} launched {counts[name]} "
                                 f"times, expected {requests * n}")
        if n == 0 and name != "gather_rows":
            raise AssertionError(f"{design}: {name} is not on the walk")
    num_paths = int(parsed["num_paths"])
    for preds in outs:
        if preds.shape != (num_paths,) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"bad predictions {preds.shape}")
    t0 = time.perf_counter()
    preds_cpu, mets_cpu = evaluate_design(model_cpu, parsed, device="cpu",
                                          case_idx=requests)
    log(f"  {design} on the cpu (plain versions): "
        f"{time.perf_counter() - t0:.2f} s  loss {mets_cpu['loss']:.6f}  "
        f"r2 {mets_cpu['r2']:.6f}")
    for req, preds in enumerate(outs):
        diff = float(np.abs(preds - preds_cpu).max())
        np.testing.assert_allclose(preds, preds_cpu, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{design} request {req} vs cpu")
        log(f"  {design} request {req} vs cpu: max abs diff {diff:.3g} "
            "(rtol/atol 1e-4): ok")
    return counts


def device_kernels(torch, fn):
    """Device time (us) and count of each kernel name in one run of
    ``fn`` under torch.profiler (warm L2)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us(), cnt + 1)
    return by_name


def log_port_kernels(by_name, what):
    """Every kernel of the port by name, summed over its instantiations."""
    for name in KERNEL_INFO:
        hits = [v for k, v in by_name.items() if f"{name}_kernel" in k]
        tot = sum(t for t, _ in hits)
        cnt = sum(c for _, c in hits)
        log(f"    {what}: {name}: {tot / 1e3:.4f} ms x{cnt}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.nn.functional as F
    from prtp_tpu_torch.data.random_design import (bench_level_sizes,
                                                   make_random_design,
                                                   with_prior_net_drivers)
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.ops import _build
    from prtp_tpu_torch.test import evaluate, pad_batch

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    # ---- phase 1: the card ----
    smi = card_line()
    log(smi)
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN convolutions (float32 slice)")

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    report = _build.build()
    log(f"phase 2: built {len(report)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, info in report.items():
        usage = [ln.strip() for ln in info["log"].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        log(f"  {name}: {info['seconds']:.1f} s; " + " | ".join(usage))

    # ---- phase 3: designs, pack, kernels against plain versions ----
    t0 = time.perf_counter()
    sizes = bench_level_sizes(NODES, LEVELS, decay=DECAY)
    parsed = {"headline": make_random_design(
        sizes, cell_feat_dim=CELL_FEAT, net_feat_dim=NET_FEAT,
        map_size=MAP_SIZE, cnn_hw=CNN_HW, mask_nnz_per_path=MASK_NNZ,
        seed=SEED)}
    parsed["prior_rows"] = with_prior_net_drivers(
        parsed["headline"], share=PRIOR_SHARE, seed=SEED)
    graphs = {name: pack_design(p, map_size=MAP_SIZE, device=dev).graph
              for name, p in parsed.items()}
    per_forward = {name: launches_per_forward(g)
                   for name, g in graphs.items()}
    p0 = parsed["headline"]
    n_edges = len(p0["cell_edges"][0]) + len(p0["net_edges"][0])
    log(f"phase 3: headline design {p0['num_nodes']} nodes, {n_edges} edges, "
        f"{graphs['headline'].num_pairs} level pairs, {p0['num_paths']} "
        f"paths; the prior-row design moves {PRIOR_SHARE:.0%} of each net "
        f"level's drivers below the pair; both built and packed in "
        f"{time.perf_counter() - t0:.2f} s")
    if per_forward["prior_rows"]["gather_rows"] == 0:
        raise AssertionError("the prior-row design has no prior rows")
    timer = Timer(torch, dev)
    recs = {}
    for name, g in graphs.items():
        log(f"  -- {name} --")
        recs[name] = check_kernels(torch, F, g, dev, timer, name)
    floors = call_floors(torch, graphs["headline"], dev, timer)
    log("  per-call floor (one-row call, same timer): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in floors.items()))
    records = []
    for name, (_src, _rep, design) in KERNEL_INFO.items():
        rec = recs[design][name]
        rec.floor_ms = floors[name]
        rec.max_abs_err = max(r[name].max_abs_err for r in recs.values())
        records.append(rec)
        log(f"  {rec.summary()}")
    check_edge_shapes(torch, dev)
    gather_probe(torch, dev, timer)
    del timer, graphs

    # ---- phase 4: the slice ----
    log("phase 4: full-width PathModel, 3 evaluation requests on the "
        "headline and 1 on the prior-row design")
    model_cpu = PathModel(CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
                          generator=torch.Generator().manual_seed(SEED))
    model = copy.deepcopy(model_cpu).to(dev)
    launches = {name: serve(torch, np, model, model_cpu, p, name,
                            per_forward[name], REQUESTS if name == "headline"
                            else 1)
                for name, p in parsed.items()}
    for rec in records:
        rec.launches = {name: c[rec.name] for name, c in launches.items()}

    # ---- phase 5: where one request's time goes ----
    designs = {name: pack_design(p, map_size=MAP_SIZE, device=dev)
               for name, p in parsed.items()}
    design = designs["headline"]
    num_paths = int(p0["num_paths"])
    pids, mask = pad_batch(np.arange(num_paths), num_paths, dev)
    timer = Timer(torch, dev)
    with torch.no_grad():
        parts = {
            "forward": lambda: model(design, pids),
            "walk": lambda: model.gnn(design.graph),
            "walk (prior-row design)":
                lambda: model.gnn(designs["prior_rows"].graph),
            "LayoutNet": lambda: model.cnn(design.cnn_input),
        }
        for name, fn in parts.items():
            dev_ms = timer.ms(fn, queue_ms=50)
            launched_ms = timer.ms(fn, queue_ms=0)
            log(f"phase 5: {name}: device time {dev_ms:.3f} ms; as "
                f"launched (host gaps included) {launched_ms:.3f} ms")
    del timer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate(model, design, pids, mask)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_kernels(torch, lambda: evaluate(model, design, pids,
                                                     mask))
    if not by_name:
        raise AssertionError("torch.profiler recorded no device kernels")
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3
    log(f"  evaluate: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} "
        f"ms (torch.profiler), idle share {1 - busy_ms / wall_ms:.3f}; "
        f"{sum(c for _, c in by_name.values())} kernel launches")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (tot, cnt) in top:
        log(f"    {tot / 1e3:8.3f} ms  x{cnt:<4d} {name[:90]}")
    log("  the port's kernels in one walk (torch.profiler, warm L2):")
    with torch.no_grad():
        for name, d in designs.items():
            log_port_kernels(device_kernels(torch, lambda: model.gnn(d.graph)),
                             name)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for rec in records:
        log(f"  {rec.name}: launches {rec.launches}; {rec.summary()}")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": [rec.as_json() for rec in records]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
