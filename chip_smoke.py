#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (prtp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (nonzero exit) on any error:

1. Print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions; turn TF32 off for matmuls and convolutions (the slice
   is float32).
2. Build every CUDA kernel of the path from ``prtp_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once.
3. Build and pack two designs: the bench headline (80k nodes, 20
   levels, seed 7), whose net drivers all lie in the pair's own cell
   level, and the same design with 10% of each net level's drivers moved
   to an earlier cell level (prior rows). On each, hold every kernel
   against its plain PyTorch version on the card at every shape the walk
   and its backward give it (an all-invalid mailbox row added), and
   ``flat_adam`` at the full model's parameter count (step t = 2),
   timing kernel, plain version, and the one PyTorch call that computes
   the same function where there is one. Then each kernel's per-call
   floor (a one-row call, same timer), the kernels' other code paths at
   edge shapes, the programmatic-launch hazard check (the two backward
   kernels launched right after a PyTorch kernel, and right after a
   kernel that lets them start at once, that writes their NaN-filled
   inputs must match their plain versions), and the row gather at the
   TPU probe's shapes (160,000 x 128 bf16, 129,202 rows).
4. The slice: the full-width float32 regression fusion model, random
   weights from a seed, answers three evaluation requests on the
   headline and one on the prior-row design through ``evaluate_design``;
   the launch counters, zeroed just before each design's requests, must
   show every kernel of that design's walk ran as often as its tables
   say; the predictions must match the same model and design on the CPU
   (plain versions) at rtol/atol 1e-4.
5. Where one request's and one train step's time goes: device time of
   the forward, the walk and LayoutNet, of a train step and of the walk's
   backward at the bench's batch (CUDA events), the device's busy and
   idle share of an evaluate call and of a train step, and each kernel's
   in-walk and in-step time and count (torch.profiler).
6. Training: the same model from the same random init, flat Adam at lr
   1e-3, through ``trainer.train_step``/``train_steps``: (a) one epoch of
   the headline's 597 paths in batches of 128 (numpy seed 0: 5 steps,
   the last padded), (b) 3 steps on the prior-row design, (c) 10 steps
   on the bench's fixed batch of all 597 paths, whose loss must fall.
   The launch counters, zeroed just before each run, must show each
   kernel as often per step as the tables say. The same steps on the CPU
   (plain versions) must give the first step's gradients leaf by leaf
   within 1e-3 x the leaf's largest |g| and every loss within rtol 1e-3.
   A LayoutNet max-pool window whose winner differs between the card
   and the CPU (a near tie that rounding resolves another way; at most
   16 a pool, counted) moves the weight gradient of each conv above it
   by more than rounding: those convs are held to 1e-2 x max |g|.

7. The CLIs, as a user runs them, through the port: ``synthetic --big``
   (2048 paths, 8 stages, 3 groups: about 102k cells and 260k pins, a
   2x512x512 raster), ``generate`` (the native rasterizer must load),
   ``train.main`` at the default full width and batch 1350 for one epoch
   (2 steps, a validation after each, a save), ``train.main`` again
   (it must resume), ``test.main`` on the card and on the CPU from the
   same checkpoint (loss, R2 and predictions at rtol/atol 1e-4, equal
   ``predict_critical``). Launch counters are zeroed just before each
   CLI run on the card: each kernel must match the run's steps and
   validations, ``gather_rows`` 0 times (a parsed design has no prior
   rows). Prints generate's seconds, each train run's wall seconds,
   steps, time a step as launched and validations, and the test CLI's
   ``runtime``, each with the card's name and power limit.

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
LR = 1e-3  # phase 6: flat Adam's learning rate
TRAIN_BATCH, EPOCH_SEED, PRIOR_STEPS, FIXED_STEPS = 128, 0, 3, 10
GRAD_TOL, LOSS_RTOL = 1e-3, 1e-3  # card vs cpu, phase 6
# card vs cpu, phase 6: a conv above a max-pool window whose winner differs
FLIP_TOL, MAX_FLIPS = 1e-2, 16
# H100 SXM peak rates (dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPS, WARMUP = 10, 2
# phase 7: the big stress design of prtp_tpu_torch.data.synthetic --big
CLI_DESIGN, CLI_PATHS, CLI_STAGES = "big", 2048, 8
HAZARD_REPS = 20  # phase 3: launches right after a writer of the inputs
SPIN_CYCLES_PER_MS = 2_000_000  # about the H100's SM clock
# phase 3's hazard check: a writer that lets a programmatic dependent
# launch after it start at once (griddepcontrol.launch_dependents), then
# spins and only then copies src into dst. A test fixture, not a kernel
# of the port.
EARLY_WRITER_SPIN_MS = 0.1
EARLY_WRITER_CU = r"""
#include <cuda_runtime.h>

__global__ void early_writer(float* dst, const float* src, long long n,
                             long long cycles) {
  asm volatile("griddepcontrol.launch_dependents;");
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += step)
    dst[i] = src[i];
}

extern "C" int early_writer_launch(void* dst, const void* src, long long n,
                                   long long cycles, void* stream) {
  early_writer<<<132, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(dst), static_cast<const float*>(src), n, cycles);
  return static_cast<int>(cudaGetLastError());
}
"""
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
    "softmax_sum_bwd": ("prtp_tpu_torch/csrc/softmax_sum_bwd.cu",
                        "prtp_tpu/ops/fused_gnn.py:302", "headline"),
    "mailbox_scatter": ("prtp_tpu_torch/csrc/mailbox_scatter.cu",
                        "prtp_tpu/ops/fused_gnn.py:312", "headline"),
    "flat_adam": ("prtp_tpu_torch/csrc/flat_adam.cu",
                  "prtp_tpu/trainer.py:81", "headline"),
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
    """Sums one kernel's numbers over the calls of one pass of one
    design: a forward (the forward kernels), a backward (the walk's
    backward kernels) or a step (flat_adam). ``launches`` maps each main
    path run (``serve <design>``, ``train ...``) to the kernel's count;
    the JSON line gives their sum and the serving runs' sum."""

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
                f"{self.ms:.4f} ms per pass; less {self.calls} x floor "
                f"{self.floor_ms:.4f} ms: {self.ms - self.calls * self.floor_ms:.4f}"
                f" ms; bound {b:.4f} ms; plain {self.plain_ms:.4f} ms; "
                f"library {self.library_ms}")

    def as_json(self):
        bound_ms, bound_by = bound(self.bytes, self.ops)
        return {"name": self.name, "ok": True, "route": "cuda",
                "source": self.source, "replaces": self.replaces,
                "launches": sum(self.launches.values()),
                "launches_serving": sum(n for run, n in self.launches.items()
                                        if run.startswith("serve")),
                "launches_by_run": self.launches,
                "design": self.design, "calls_per_pass": self.calls,
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


def launches_per_step(graph) -> dict:
    """Each kernel's launches in one train step on ``graph``: the
    forward's, the backward's (``softmax_sum`` again, to recompute f; the
    cell cotangent for pairs k > 0; a scatter for each non-empty intra
    and merged table) and one flat Adam update."""
    fwd = launches_per_forward(graph)
    p = graph.num_pairs
    return {
        "gather_rows": fwd["gather_rows"],
        "softmax_sum": 2 * (p - 1),
        "local_mean": p,
        "softmax_sum_bwd": p - 1,
        "mailbox_scatter": sum(
            (graph.intra_rows[k].numel() > 0)
            + (graph.merged_rows[k].numel() > 0) for k in range(p)),
        "flat_adam": 1,
    }


def scatter_bytes(torch, rows, pos, n_cell, md_n, has_cell, row_b):
    """Bytes one mailbox_scatter call must move: each entry's index and
    source row (a cell position's own row, unless there is no cell
    cotangent; a net position's d_pre_n row and count, shared by its
    mailbox's slots), each segment's row index and offset, and the
    destination rows read and written."""
    net_rows = torch.unique((pos[pos >= n_cell].long() - n_cell) // md_n)
    n_cell_src = int((pos < n_cell).sum()) if has_cell else 0
    return ((n_cell_src + net_rows.numel()) * row_b + net_rows.numel() * 4
            + pos.numel() * 4 + rows.numel() * (2 * row_b + 8) + 4)


def check_backward_kernels(torch, graph, dev, timer, design):
    """Phase 3, backward: softmax_sum_bwd and mailbox_scatter against
    their plain versions at every shape the walk's backward gives them
    on ``graph``, with a random state, cotangents and counts as the
    backward computes them. The scatters update a copy of a random
    ``dest`` in place. Returns ``{name: KernelRecord}``."""
    from prtp_tpu_torch.ops.fused_gnn import (mailbox_scatter,
                                              mailbox_scatter_plain,
                                              softmax_sum_bwd,
                                              softmax_sum_bwd_plain,
                                              softmax_sum_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    num_rows = graph.num_rows
    row_b = D * 4
    h = torch.randn((num_rows + 1, D), generator=gen, device=dev)
    dh = torch.randn((num_rows + 1, D), generator=gen, device=dev)
    recs = {name: KernelRecord(name, design)
            for name in ("softmax_sum_bwd", "mailbox_scatter")}

    def scatter_case(what, k, dest, rows, seg_off, pos, d_mail_c, d_pre_n,
                     cnt_n, md_n, n_cell):
        args = (rows, seg_off, pos, d_mail_c, d_pre_n, cnt_n, md_n, n_cell)
        got, want = dest.clone(), dest.clone()
        mailbox_scatter(got, *args)
        mailbox_scatter_plain(want, *args)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"mailbox_scatter ({what}) differs at pair "
                                 f"{k}: max abs err {err}")
        nbytes = scatter_bytes(torch, rows, pos, n_cell, md_n,
                               d_mail_c is not None, row_b)
        ops = float(pos.numel() * D)
        # the library yardstick: index_add_ of the per-entry contributions
        # into dest, both prebuilt outside its timed call (the net
        # cotangent divided and gathered, each entry's destination row):
        # it sums in atomic order and builds nothing
        cell = (d_mail_c if d_mail_c is not None
                else dest.new_zeros((n_cell, D)))
        contrib = torch.cat([cell, (d_pre_n / cnt_n[:, None])
                             .repeat_interleave(md_n, dim=0)])[pos.long()]
        entry_rows = rows.long().repeat_interleave(
            (seg_off[1:] - seg_off[:-1]).long())
        work, work_p, work_l = dest.clone(), dest.clone(), dest.clone()
        ms = timer.ms(lambda: mailbox_scatter(work, *args))
        pms = timer.ms(lambda: mailbox_scatter_plain(work_p, *args))
        lms = timer.ms(lambda: work_l.index_add_(0, entry_rows, contrib))
        recs["mailbox_scatter"].add(ms, pms, lms, nbytes, ops, err)
        log(f"  mailbox_scatter {what} pair {k}: {pos.numel()} entries into "
            f"{rows.numel()} rows  kernel {ms:.4f} ms  plain {pms:.4f}  "
            f"index_add_ of prebuilt contributions (atomic order, builds "
            f"nothing) {lms:.4f}  bound {bound(nbytes, ops)[0]:.4f}  max abs "
            f"err {err:.3g}")

    for k in range(graph.num_pairs):
        cell_mail, net_mail = graph.cell_mail[k], graph.net_mail[k]
        pn_c, md_c = cell_mail.shape
        pn_n, md_n = net_mail.shape
        d_pre_n = torch.randn((pn_n, D), generator=gen, device=dev)
        cnt_n = graph.net_cnt[k]
        # ---- softmax_sum_bwd: the cell mailbox, row 0 all-invalid ----
        d_mail_c = None
        if k > 0:
            idx = cell_mail.clone()
            idx[0] = num_rows
            f = softmax_sum_plain(h, idx, num_rows)
            d_f = torch.randn((pn_c, D), generator=gen, device=dev)
            # the kernel writes valid slots only (invalid rows undefined)
            valid = (idx != num_rows).reshape(-1)
            out = softmax_sum_bwd(h, idx, num_rows, f, d_f)[valid]
            want = softmax_sum_bwd_plain(h, idx, num_rows, f, d_f)[valid]
            err = float((out - want).abs().max())
            if not (torch.allclose(out, want, rtol=1e-5, atol=1e-6)
                    and bool(torch.isfinite(out).all())):
                raise AssertionError(f"softmax_sum_bwd differs at pair {k}: "
                                     f"max abs err {err}")
            used = idx[idx != num_rows]
            nbytes = (torch.unique(used).numel() * row_b + idx.numel() * 4
                      + 2 * pn_c * row_b + used.numel() * row_b)
            ops = 10.0 * used.numel() * D
            ms = timer.ms(lambda: softmax_sum_bwd(h, idx, num_rows, f, d_f))
            pms = timer.ms(lambda: softmax_sum_bwd_plain(h, idx, num_rows, f,
                                                         d_f))
            recs["softmax_sum_bwd"].add(ms, pms, None, nbytes, ops, err)
            log(f"  softmax_sum_bwd pair {k}: ({pn_c}, {md_c}) of {D} f32, "
                f"{used.numel()} valid slots  kernel {ms:.4f} ms  plain "
                f"{pms:.4f}  bound {bound(nbytes, ops)[0]:.4f}  "
                f"({nbytes / ms / 1e9:.3f} TB/s)  max abs err {err:.3g}")
            d_mail_c = torch.randn((pn_c * md_c, D), generator=gen,
                                   device=dev)
        # ---- mailbox_scatter: the intra and the merged call sites ----
        if graph.intra_rows[k].numel():
            scatter_case("intra", k, dh[graph.cell_off[k]:
                                        graph.cell_off[k] + pn_c],
                         graph.intra_rows[k], graph.intra_seg_off[k],
                         graph.intra_pos[k], None, d_pre_n, cnt_n, md_n, 0)
        if graph.merged_rows[k].numel():
            scatter_case("merged", k, dh, graph.merged_rows[k],
                         graph.merged_seg_off[k], graph.merged_pos[k],
                         d_mail_c, d_pre_n, cnt_n, md_n, pn_c * md_c)
    return recs


def adam_close(torch, got, want, what):
    """flat_adam's (p, g, mu, nu) against the plain version's, each within
    rtol 1e-6 and atol 1e-6 x the vector's largest value: the plain
    version on the card divides by the bias corrections as PyTorch's CUDA
    division by a scalar does, by a multiply with the reciprocal, an ulp
    off a true division; and b1 * mu against (1 - b1) * g can cancel to a
    value far smaller than its operands' rounding. Returns the max abs
    error; logs each vector's worst element."""
    err = 0.0
    for name, a, b in zip(("p", "g", "mu", "nu"), got, want):
        diff = (a - b).abs()
        if not diff.numel():
            continue
        i = int(diff.argmax())
        err = max(err, float(diff[i]))
        scale = float(b.abs().max())
        if float(diff[i]):
            log(f"    {what}: {name} max abs err {float(diff[i]):.3g} at "
                f"{float(a[i])!r} (plain {float(b[i])!r}); max |{name}| "
                f"{scale:.3g}")
        if not torch.allclose(a, b, rtol=1e-6, atol=1e-6 * scale):
            raise AssertionError(f"{what}: {name} differs: max abs err "
                                 f"{float(diff[i])}")
    return err


def check_flat_adam(torch, n, dev, timer):
    """Phase 3, optimizer: flat_adam against its plain version on random
    vectors of the full model's parameter count at step t = 2 (positive
    second moments), with weight decay, and fused ``torch.optim.Adam``
    (``fused=True``, never called by the port) on the same tensors as the
    library yardstick. Returns a KernelRecord."""
    from prtp_tpu_torch.ops.adam import flat_adam, flat_adam_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    p, g, mu = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    nu = torch.rand(n, generator=gen, device=dev) * 1e-2
    hyper = (LR, 0.9, 0.999, 1e-8, 1e-4, 2)
    got = [t.clone() for t in (p, g, mu, nu)]
    want = [t.clone() for t in (p, g, mu, nu)]
    flat_adam(*got, *hyper)
    flat_adam_plain(*want, *hyper)
    err = adam_close(torch, got, want, "flat_adam at the model's size")
    rec = KernelRecord("flat_adam", "headline")
    work = [t.clone() for t in (p, g, mu, nu)]
    work_p = [t.clone() for t in (p, g, mu, nu)]
    ms = timer.ms(lambda: flat_adam(*work, *hyper))
    pms = timer.ms(lambda: flat_adam_plain(*work_p, *hyper))
    q = p.clone().requires_grad_()
    q.grad = g.clone()
    lib = torch.optim.Adam([q], lr=LR, weight_decay=1e-4, fused=True)
    lms = timer.ms(lib.step)
    nbytes, ops = 28.0 * n, 15.0 * n
    rec.add(ms, pms, lms, nbytes, ops, err)
    log(f"  flat_adam: {n} parameters, t = 2  kernel {ms:.4f} ms  plain "
        f"{pms:.4f}  Adam(fused=True) {lms:.4f}  bound "
        f"{bound(nbytes, ops)[0]:.4f}  ({nbytes / ms / 1e9:.3f} TB/s)  max abs "
        f"err {err:.3g}")
    return rec


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
    from prtp_tpu_torch.ops.adam import flat_adam
    from prtp_tpu_torch.ops.fused_gnn import (local_mean, mailbox_scatter,
                                              softmax_sum, softmax_sum_bwd)
    from prtp_tpu_torch.ops.gather import gather_rows

    h = torch.randn((graph.num_rows + 1, D), device=dev)
    one_row = graph.cell_mail[1][:1]
    new = torch.randn((1, D), device=dev)
    idx_n = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    seg_off = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    one = torch.ones(1, device=dev)
    vec = [torch.rand(1, device=dev) for _ in range(4)]
    return {
        "gather_rows": timer.ms(lambda: gather_rows(h, one_row[0, :1])),
        "softmax_sum": timer.ms(
            lambda: softmax_sum(h, one_row, graph.num_rows)),
        "local_mean": timer.ms(lambda: local_mean(new, new[:0], idx_n)),
        "softmax_sum_bwd": timer.ms(
            lambda: softmax_sum_bwd(h, one_row, graph.num_rows, new, new)),
        "mailbox_scatter": timer.ms(
            lambda: mailbox_scatter(h, zero, seg_off, zero, None, new, one,
                                    1, 0)),
        "flat_adam": timer.ms(
            lambda: flat_adam(*vec, LR, 0.9, 0.999, 1e-8, 0.0, 2)),
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


def check_backward_edge_shapes(torch, dev):
    """The new kernels' other code paths against their plain versions:
    for softmax_sum_bwd one slot, k > 8 (the generic path), D % 4 != 0
    and a misaligned h (the scalar path), narrow and wide rows, an empty
    mailbox, all-invalid rows and a NaN in a valid slot; for
    mailbox_scatter an empty table, no cell cotangent with cell
    positions (pair 0), several net slots a row, long segments, segments
    of 1 to 13 entries, one-entry segments only, D % 4 != 0 (0 segments
    too) and a misaligned dest (against the plain version on the CPU);
    for flat_adam lengths with a tail, a misaligned vector and no weight
    decay."""
    from prtp_tpu_torch.ops.adam import flat_adam, flat_adam_plain
    from prtp_tpu_torch.ops.fused_gnn import (mailbox_scatter,
                                              mailbox_scatter_plain,
                                              softmax_sum_bwd,
                                              softmax_sum_bwd_plain,
                                              softmax_sum_plain)

    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rows(n, d, misaligned=False):
        if misaligned:
            return randn(n * d + 1)[1:].view(n, d)
        return randn(n, d) * 4

    cases = 0
    # softmax_sum_bwd: (P, K, D, rows of h, case)
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
        idx = torch.randint(0, r - 1, (p, k), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[torch.rand((p, k), generator=gen, device=dev) < 0.35] = r - 1
        if p:
            idx[0] = r - 1
        if case == "NaN":
            idx[1, 0] = 5
            h[5, 2] = float("nan")
        f = softmax_sum_plain(h, idx, r - 1)
        d_f = randn(p, d)
        out = softmax_sum_bwd(h, idx, r - 1, f, d_f)
        want = softmax_sum_bwd_plain(h, idx, r - 1, f, d_f)
        shape_ok = out.shape == want.shape
        valid = (idx != r - 1).reshape(-1)  # invalid rows are undefined
        out, want = out[valid], want[valid]
        ok = shape_ok and torch.allclose(out, want, rtol=1e-5, atol=1e-6,
                                         equal_nan=True)
        if case == "NaN":
            ok = ok and bool(out[int(valid[:k].sum()), 2].isnan())
        else:
            ok = ok and bool(torch.isfinite(out).all())
        if not ok:
            raise AssertionError(f"softmax_sum_bwd differs at {(p, k, d)} "
                                 f"{case}")
        cases += 1
    # mailbox_scatter: (n_cell, pn_n, md_n, dest rows, D, entries, case)
    for n_cell, pn_n, md_n, n_rows, d, n_ent, case in (
            (40, 20, 1, 30, 128, 0, "empty"),
            (0, 200, 1, 150, 128, 200, "intra, no cell positions"),
            (60, 50, 1, 40, 128, 100, "pair 0: no cell cotangent"),
            (300, 100, 3, 200, 128, 500, "3 net slots a row"),
            (300, 100, 2, 4, 128, 400, "long segments"),
            (100, 50, 2, 80, 128, 31, "segments of 1, 4, 5, 8 and 13 entries"),
            (100, 50, 2, 80, 128, 60, "every segment one entry"),
            (100, 50, 2, 80, 7, 120, "D%4!=0"),
            (100, 50, 2, 80, 7, 0, "0 segments, D%4!=0"),
            (100, 50, 2, 80, 20, 120, "D=20, 8 lanes a segment, 5 busy"),
            (100, 50, 2, 80, 300, 120, "D=300"),
            (100, 50, 2, 80, 128, 120, "misaligned dest")):
        n_pos = n_cell + pn_n * md_n
        pos = torch.randperm(n_pos, generator=gen, device=dev)[:n_ent]
        if case.startswith("segments of"):
            dest_row = torch.tensor([2, 10, 11, 40, 79], device=dev)
            dest_row = dest_row.repeat_interleave(
                torch.tensor([1, 4, 5, 8, 13], device=dev))
        elif case.startswith("every segment"):
            dest_row = torch.randperm(n_rows, generator=gen,
                                      device=dev)[:n_ent]
        else:
            dest_row = torch.randint(0, n_rows, (pos.numel(),),
                                     generator=gen, device=dev)
        order = torch.argsort(dest_row, stable=True)
        pos, dest_row = pos[order].int(), dest_row[order]
        uniq, counts = torch.unique_consecutive(dest_row, return_counts=True)
        seg_off = torch.zeros(uniq.numel() + 1, dtype=torch.int32, device=dev)
        seg_off[1:] = torch.cumsum(counts, 0)
        d_mail_c = None if case.startswith("pair 0") else randn(n_cell, d)
        cnt = torch.randint(1, md_n + 1, (pn_n,), generator=gen,
                            device=dev).float()
        args = (uniq.int(), seg_off, pos, d_mail_c, randn(pn_n, d), cnt,
                md_n, n_cell)
        dest = rows(n_rows, d, misaligned=case == "misaligned dest")
        got = dest.clone()
        if case == "misaligned dest":
            got = randn(n_rows * d + 1)[1:].view(n_rows, d)
            got.copy_(dest)
        mailbox_scatter(got, *args)
        # the plain version on the CPU: CUDA's index_add_ sums a segment in
        # atomic order, which long segments show; the CPU's sums it in
        # the kernel's order
        want = dest.cpu()
        mailbox_scatter_plain(want, *(a.cpu() if torch.is_tensor(a) else a
                                      for a in args))
        if not torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"mailbox_scatter differs: {case}: max abs "
                                 f"err {float((got.cpu() - want).abs().max())}")
        cases += 1
    # flat_adam: (length, misaligned, weight decay)
    for n, misaligned, wd in ((1, False, 0.0), (3, False, 1e-2),
                              (1001, False, 1e-2), (4096, False, 0.0),
                              (1001, True, 0.0)):
        vecs = []
        for i in range(4):
            v = rows(1, n, misaligned).view(n)
            vecs.append(v.abs() * 1e-2 if i == 3 else v)
        got = [v.clone() for v in vecs]
        want = [v.clone() for v in vecs]
        if misaligned:
            got = [randn(n + 1)[1:] for _ in range(4)]
            for a, b in zip(got, vecs):
                a.copy_(b)
        flat_adam(*got, LR, 0.9, 0.999, 1e-8, wd, 3)
        flat_adam_plain(*want, LR, 0.9, 0.999, 1e-8, wd, 3)
        adam_close(torch, got, want,
                   f"flat_adam n={n} misaligned={misaligned} wd={wd}")
        cases += 1
    log(f"  backward edge shapes: {cases} cases of the three new kernels "
        "match their plain versions (rtol 1e-5, atol 1e-6; flat_adam rtol "
        "1e-6, atol 1e-6 x max; NaN where the plain version has it)")


def start_early_writer_build():
    """Phase 2: start ``nvcc`` on EARLY_WRITER_CU, beside the port's
    builds, into the port's (git-ignored) build directory. Returns what
    :func:`load_early_writer` takes."""
    from prtp_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "early_writer.cu"
    src.write_text(EARLY_WRITER_CU)
    target = _build.BUILD_DIR / "libearly_writer.so"
    proc = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(target), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, target


def load_early_writer(build):
    """``early_writer_launch`` of the library :func:`start_early_writer_build`
    compiles; raises with the compiler's output if the build failed."""
    import ctypes

    proc, target = build
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"early_writer build failed:\n{out}")
    fn = ctypes.CDLL(str(target)).early_writer_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_programmatic_hazard(torch, graph, dev, early_writer, pair=1):
    """Phase 3, programmatic dependent launch: softmax_sum_bwd and both
    mailbox_scatter calls at one pair's shapes of ``graph``, each launched
    right after a kernel that writes every input the kernel may read only
    after its wait (f and d_f; dest, d_pre_n and d_mail_c), all NaN
    before. Two writers: an elementwise PyTorch kernel (``torch.mul`` by
    1), as on the main path, where the launch after it may start only as
    its blocks exit; and ``early_writer`` (EARLY_WRITER_CU), which lets
    the launch after it start at once and writes only after a spin, so
    that any read before the wait finds NaN. A spin kernel holds the
    stream while the host enqueues writer and kernel. Each of HAZARD_REPS
    results a writer must match the plain version on the written values
    (rtol 1e-5, atol 1e-6)."""
    from prtp_tpu_torch.ops.fused_gnn import (mailbox_scatter,
                                              mailbox_scatter_plain,
                                              softmax_sum_bwd,
                                              softmax_sum_bwd_plain,
                                              softmax_sum_plain)

    def write_early(buf, src):
        err = early_writer(buf.data_ptr(), src.data_ptr(), buf.numel(),
                           int(EARLY_WRITER_SPIN_MS * SPIN_CYCLES_PER_MS),
                           torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"early_writer launch failed: cuda error {err}")

    writers = {"torch.mul": lambda buf, src: torch.mul(src, 1.0, out=buf),
               "early_writer": write_early}
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    num_rows = graph.num_rows
    cell_mail = graph.cell_mail[pair]
    pn_c, md_c = cell_mail.shape
    pn_n, md_n = graph.net_mail[pair].shape
    h = torch.randn((num_rows + 1, D), generator=gen, device=dev)

    def staged(vals):
        """NaN-filled views of one buffer, shaped as ``vals``, the flat
        values, and the buffer: one writer launch fills them all."""
        src = torch.cat([v.reshape(-1) for v in vals])
        buf = torch.full_like(src, float("nan"))
        views, at = [], 0
        for v in vals:
            views.append(buf[at: at + v.numel()].view(v.shape))
            at += v.numel()
        return views, src, buf

    failed = []

    def after_writer(what, call, buf, src, want):
        """For each writer, HAZARD_REPS launches of ``call``, each right
        after the writer fills ``buf`` from ``src``; logs the elements
        that differ from ``want`` in each launch."""
        for writer, write in writers.items():
            bad = []
            for _ in range(HAZARD_REPS):
                buf.fill_(float("nan"))
                torch.cuda._sleep(int(0.2 * SPIN_CYCLES_PER_MS))
                write(buf, src)
                bad.append((~torch.isclose(call(), want, rtol=1e-5,
                                           atol=1e-6)).sum())
            bad = [int(b) for b in bad]
            log(f"  programmatic launch: {what} right after {writer}: "
                f"elements off the plain version in each of {HAZARD_REPS} "
                f"launches {bad}")
            if any(bad):
                failed.append(f"{what} after {writer}")

    f = softmax_sum_plain(h, cell_mail, num_rows)
    d_f = torch.randn((pn_c, D), generator=gen, device=dev)
    (f_v, d_f_v), src, buf = staged([f, d_f])
    valid = (cell_mail != num_rows).reshape(-1)
    after_writer("softmax_sum_bwd",
                 lambda: softmax_sum_bwd(h, cell_mail, num_rows, f_v,
                                         d_f_v)[valid], buf, src,
                 softmax_sum_bwd_plain(h, cell_mail, num_rows, f, d_f)[valid])
    d_pre_n = torch.randn((pn_n, D), generator=gen, device=dev)
    d_mail_c = torch.randn((pn_c * md_c, D), generator=gen, device=dev)
    sites = {
        "intra": (torch.randn((pn_c, D), generator=gen, device=dev),
                  graph.intra_rows[pair], graph.intra_seg_off[pair],
                  graph.intra_pos[pair], False, 0),
        "merged": (torch.randn((num_rows + 1, D), generator=gen, device=dev),
                   graph.merged_rows[pair], graph.merged_seg_off[pair],
                   graph.merged_pos[pair], True, pn_c * md_c),
    }
    for site, (dest, rows, seg_off, pos, with_cell, n_cell) in sites.items():
        (dest_v, d_pre_v, d_mail_v), src, buf = staged(
            [dest, d_pre_n, d_mail_c])
        tail = (graph.net_cnt[pair], md_n, n_cell)

        def scatter():
            mailbox_scatter(dest_v, rows, seg_off, pos,
                            d_mail_v if with_cell else None, d_pre_v, *tail)
            return dest_v

        want = dest.clone()
        mailbox_scatter_plain(want, rows, seg_off, pos,
                              d_mail_c if with_cell else None, d_pre_n, *tail)
        after_writer(f"mailbox_scatter ({site})", scatter, buf, src, want)
    if failed:
        raise AssertionError("launched right after the kernel that writes "
                             "its inputs, a kernel differs from its plain "
                             f"version: {failed}")
    log(f"  programmatic launch: softmax_sum_bwd and mailbox_scatter (intra, "
        f"merged) at pair {pair} match their plain versions right after each "
        "writer (rtol 1e-5, atol 1e-6)")


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


def _zero_launches():
    from prtp_tpu_torch.ops import KERNELS
    for kern in KERNELS:
        kern.launches = 0


def _read_launches() -> dict:
    from prtp_tpu_torch.ops import KERNELS
    return {kern.__name__: kern.launches for kern in KERNELS}


def serve(torch, np, model, model_cpu, parsed, design, per_forward,
          requests):
    """Phase 4 for one design: ``requests`` evaluation requests on the
    card with the launch counters zeroed just before and read just after
    (each must equal ``requests`` x its per-forward count, and every
    kernel of the walk must have run), then the same model on the CPU.
    Returns the launch counts."""
    from prtp_tpu_torch.test import evaluate_design

    torch.cuda.synchronize()
    _zero_launches()
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
    counts = _read_launches()
    log(f"  {design}: launches in {requests} request(s): {counts}; per "
        f"forward expected {per_forward}")
    for name, n in per_forward.items():
        if counts[name] != requests * n:
            raise AssertionError(f"{design}: {name} launched {counts[name]} "
                                 f"times, expected {requests * n}")
        if n == 0 and name != "gather_rows":
            raise AssertionError(f"{design}: {name} is not on the walk")
    for name, n in counts.items():
        if name not in per_forward and n:
            raise AssertionError(f"{design}: {name} launched {n} times in "
                                 "evaluation, which runs no backward")
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


def train_run(torch, state, design, batches, what, per_step=None):
    """Phase 6: one run of train steps through ``train_step`` (the first,
    whose gradients stay in ``.grad``) and ``train_steps`` (the rest).
    With ``per_step`` (on the card) the launch counters are zeroed just
    before the run and read just after, and each kernel must have run
    ``len(batches)`` x its per-step count. Returns (losses, the first
    step's gradients on the CPU, counts)."""
    import numpy as np
    from prtp_tpu_torch.trainer import train_step, train_steps

    on_card = per_step is not None
    if on_card:
        torch.cuda.synchronize()
        _zero_launches()
    t0 = time.perf_counter()
    first = train_step(state, design, *batches[0])
    grads = {k: p.grad.detach().to("cpu", copy=True)
             for k, p in state.model.named_parameters()}
    rest = train_steps(state, design, batches[1:]) if len(batches) > 1 else {}
    losses = [float(first["loss"])] + [float(x) for x in rest.get("loss", [])]
    wall = time.perf_counter() - t0
    counts = _read_launches()
    log(f"  {what} ({'card' if on_card else 'cpu, plain versions'}): "
        f"{len(batches)} steps in {wall:.3f} s; losses "
        + ", ".join(f"{x:.6f}" for x in losses))
    if on_card:
        log(f"  {what}: launches {counts}; per step expected {per_step}")
        for name, n in per_step.items():
            if counts[name] != len(batches) * n:
                raise AssertionError(f"{what}: {name} launched {counts[name]}"
                                     f" times, expected {len(batches) * n}")
            if n == 0 and name != "gather_rows":
                raise AssertionError(f"{what}: {name} is not on the step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: a loss is not finite: {losses}")
    return losses, grads, counts


def pool_winner_flips(torch, cnn_cpu, cnn_card, x_cpu, dev) -> dict:
    """LayoutNet's two max pools at the same weights and raster on the
    card and on the CPU: the windows (channels included) whose winner
    differs, counted where the window's max is positive (a window of ReLU
    zeros passes no gradient). Where two values nearly tie, rounding that
    differs by an ulp can pick another winner; the window's whole
    gradient then goes to another element, which moves the weight
    gradients of the convs above that pool by far more than rounding.
    Returns ``{conv: flipped windows in the pool after it}``."""
    import torch.nn.functional as F
    from prtp_tpu_torch.ops.pool import pool_2x2

    def winners(a):
        n, c, h, w = a.shape
        win = a.reshape(n, c, h // 2, 2, w // 2, 2).permute(
            0, 1, 2, 4, 3, 5).reshape(-1, 4)
        return win.argmax(dim=1).cpu(), (win.amax(dim=1) > 0).cpu()

    flips = {}
    a, b = x_cpu, x_cpu.to(dev)
    with torch.no_grad():
        for conv in ("Conv_0", "Conv_1"):
            a = F.relu(getattr(cnn_cpu, conv)(a))
            b = F.relu(getattr(cnn_card, conv)(b))
            (wa, live), (wb, _) = winners(a), winners(b)
            flips[conv] = int(((wa != wb) & live).sum())
            a, b = pool_2x2(a, "max"), pool_2x2(b, "max")
    return flips


def compare_runs(torch, what, card, cpu, flips):
    """The card's run against the CPU's: the first step's gradients leaf
    by leaf within GRAD_TOL x the leaf's largest |g|, every loss within
    LOSS_RTOL. A LayoutNet conv above a pool with winners that differ
    (``flips``, at most MAX_FLIPS a pool) is held to FLIP_TOL instead."""
    import numpy as np
    (l_card, g_card, _), (l_cpu, g_cpu, _) = card, cpu
    if max(flips.values()) > MAX_FLIPS:
        raise AssertionError(f"{what}: {flips} max-pool winners differ from "
                             f"the cpu's (allowed {MAX_FLIPS} a pool)")
    above = {"cnn.Conv_0.": flips["Conv_0"] + flips["Conv_1"],
             "cnn.Conv_1.": flips["Conv_1"]}
    worst, worst_flip = 0.0, 0.0
    for key, want in g_cpu.items():
        scale = float(want.abs().max())
        diff = float((g_card[key] - want).abs().max())
        rel = diff / scale if scale else diff
        flipped = any(key.startswith(k) and n for k, n in above.items())
        if flipped:
            worst_flip = max(worst_flip, rel)
        else:
            worst = max(worst, rel)
        if diff > (FLIP_TOL if flipped else GRAD_TOL) * scale:
            raise AssertionError(f"{what}: gradient of {key} differs from "
                                 f"the cpu's by {diff} (its max |g| {scale})")
    np.testing.assert_allclose(l_card, l_cpu, rtol=LOSS_RTOL,
                               err_msg=f"{what}: losses vs cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    log(f"  {what} vs cpu: first-step gradients within {worst:.3g} x each "
        f"leaf's max |g| (allowed {GRAD_TOL}); convs above a flipped pool "
        f"window within {worst_flip:.3g} (allowed {FLIP_TOL}); losses "
        f"within rtol {rel:.3g} (allowed {LOSS_RTOL}): ok")


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


def time_train_step(torch, model_cpu, design, dev):
    """Phase 5, training: at the bench's batch (all 597 headline paths),
    one train step's device time (queue pre-filled) and as-launched time,
    the walk backward's device time, the device's busy and idle share of
    a step, its top kernels, each port kernel's in-step time and count
    (torch.profiler) and the step's peak memory; LayoutNet's forward and
    backward. The step runs on a copy of the init with flat Adam."""
    import numpy as np
    from prtp_tpu_torch.trainer import (init_state, make_optimizer,
                                        pad_batch, train_step)

    state = init_state(copy.deepcopy(model_cpu),
                       make_optimizer(LR), DEVICE)
    num_paths = design.num_paths
    ids, mask = pad_batch(np.random.default_rng(0).permutation(num_paths),
                          num_paths, dev)

    def step():
        train_step(state, design, ids, mask)

    timer = Timer(torch, dev)
    dev_ms = timer.ms(step, queue_ms=200)
    launched_ms = timer.ms(step, queue_ms=0)
    log(f"phase 5: train step ({num_paths} paths): device time {dev_ms:.3f} "
        f"ms; as launched (host gaps included) {launched_ms:.3f} ms")
    gnn = state.model.gnn
    params = list(gnn.parameters())
    hf = gnn(design.graph)
    g = torch.randn_like(hf)

    def walk_backward():
        torch.autograd.grad(hf, params, g, retain_graph=True)

    dev_ms = timer.ms(walk_backward, queue_ms=100)
    launched_ms = timer.ms(walk_backward, queue_ms=0)
    log(f"phase 5: walk backward: device time {dev_ms:.3f} ms; as launched "
        f"{launched_ms:.3f} ms")
    cnn = state.model.cnn
    cnn_params = list(cnn.parameters())
    cot = torch.randn((1, 1, MAP_SIZE, MAP_SIZE), device=dev)

    def cnn_fwd_bwd():
        torch.autograd.grad(cnn(design.cnn_input), cnn_params, cot)

    log(f"phase 5: LayoutNet forward + backward: device time "
        f"{timer.ms(cnn_fwd_bwd, queue_ms=20):.3f} ms")
    del timer, hf, g
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    by_name = device_kernels(torch, step)
    if not by_name:
        raise AssertionError("torch.profiler recorded no device kernels")
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3
    log(f"  train step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"(torch.profiler), idle share {1 - busy_ms / wall_ms:.3f}; "
        f"{sum(c for _, c in by_name.values())} kernel launches; peak memory "
        f"{peak / 2 ** 30:.3f} GiB")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (tot, cnt) in top:
        log(f"    {tot / 1e3:8.3f} ms  x{cnt:<4d} {name[:90]}")
    log("  the port's kernels in one train step (torch.profiler, warm L2; "
        "the span of a programmatic launch starts early and holds its wait):")
    log_port_kernels(by_name, "train step")


class _Timed:
    """Wraps ``fn`` so each call is timed on the host between two
    ``torch.cuda.synchronize()``; ``calls`` keeps (seconds, args,
    result)."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls = torch, fn, []

    def __call__(self, *args, **kwargs):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        self.torch.cuda.synchronize()
        self.calls.append((time.perf_counter() - t0, args, out))
        return out


def cli_phase(torch, np, dev, smi) -> dict:
    """Phase 7: the user's four CLIs through the port, on the card, in a
    temporary directory. Synthesizes the big stress design, generates its
    dataset (the native rasterizer must load), trains at full width
    (``train.main``), resumes, evaluates (``test.main``) and evaluates
    again on the CPU from the same checkpoint. The launch counters are
    zeroed just before each CLI run on the card and read just after: each
    kernel must have run as often as the steps and validations say.
    Returns each run's counts."""
    import tempfile
    from prtp_tpu_torch import test as test_mod
    from prtp_tpu_torch import train as train_mod
    from prtp_tpu_torch.data import generate, synthetic
    from prtp_tpu_torch.data.dataset import load_design_npz
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.native import native_available

    launches = {}
    with tempfile.TemporaryDirectory(prefix="prtp_cli_") as tmp:
        raw, data, mdl = (os.path.join(tmp, d)
                          for d in ("raw", "data", "mdl"))
        t0 = time.perf_counter()
        synthetic.main(["--out", raw, "--big", "--designs", CLI_DESIGN,
                        "--num_paths", str(CLI_PATHS),
                        "--depth", str(CLI_STAGES)])
        log(f"phase 7: synthetic --big ({CLI_PATHS} paths, {CLI_STAGES} "
            f"stages, 3 groups): {time.perf_counter() - t0:.2f} s on the "
            "host")
        t0 = time.perf_counter()
        generate.main(["--rawdata_path", raw, "--data_save_path", data])
        gen_s = time.perf_counter() - t0
        if not native_available():
            raise AssertionError("generate ran without the native rasterizer")
        parsed = load_design_npz(os.path.join(data, f"{CLI_DESIGN}.npz"))
        graph = pack_design(parsed, map_size=MAP_SIZE, device=dev).graph
        per_step, per_fwd = launches_per_step(graph), launches_per_forward(
            graph)
        n_pins = int(parsed["num_nodes"])
        log(f"phase 7: generate: {gen_s:.2f} s on the host (native "
            f"rasterizer); {n_pins} pins, {graph.num_pairs} level pairs, "
            f"{parsed['num_paths']} paths, raster "
            f"{tuple(parsed['cnn_input'].shape)}  [{smi}]")
        if per_step["gather_rows"]:
            raise AssertionError("the parsed design has prior rows")
        del graph
        torch.cuda.empty_cache()

        args = ["--data_save_path", data, "--model_saving_dir", mdl,
                "--num_epoch", "1"]
        for run in ("train CLI", "train CLI resume"):
            steps = _Timed(torch, train_mod.train_steps)
            validate = _Timed(torch, train_mod.validate)
            train_mod.train_steps, train_mod.validate = steps, validate
            try:
                _zero_launches()
                t0 = time.perf_counter()
                state = train_mod.main(args, device=DEVICE)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                train_mod.train_steps = steps.fn
                train_mod.validate = validate.fn
            counts = launches[run] = _read_launches()
            n_steps = sum(len(a[2]) for _s, a, _o in steps.calls)
            n_val = len(validate.calls)
            step_s = sum(s for s, _a, _o in steps.calls) / n_steps
            val_s = [s for s, _a, _o in validate.calls]
            log(f"phase 7: {run}: {wall:.2f} s wall, {n_steps} steps of "
                f"batch 1350 ({step_s * 1e3:.2f} ms a step as launched, "
                f"chunks {[round(s * 1e3, 2) for s, _a, _o in steps.calls]}"
                " ms),"
                f" {n_val} validations ("
                + ", ".join(f"{s * 1e3:.2f}" for s in val_s)
                + f" ms); state step {state.step}  [{smi}]")
            log(f"  {run}: launches {counts}")
            for name, n in counts.items():
                want = n_steps * per_step[name] + n_val * per_fwd.get(name, 0)
                if n != want:
                    raise AssertionError(f"{run}: {name} launched {n} times, "
                                         f"expected {want}")
                if name != "gather_rows" and not n:
                    raise AssertionError(f"{run}: {name} did not launch")
            if n_val < 2:
                raise AssertionError(f"{run}: {n_val} validations")
        with open(os.path.join(mdl, "stdout.log")) as f:
            log_text = f.read()
        with open(os.path.join(mdl, "seed.txt")) as f:
            seeds = f.read()
        if ("Loading the model and hyper-parameters" not in log_text
                or "Saving model" not in log_text or seeds != "9294" * 2):
            raise AssertionError(f"the second train CLI run did not resume "
                                 f"(seed.txt {seeds!r})")

        test_args = ["--data_save_path", data, "--model_saving_dir", mdl]
        crit_path = os.path.join(mdl, "predict_critical",
                                 f"{CLI_DESIGN}.json")
        results = []
        for where in (DEVICE, "cpu"):
            ev = _Timed(torch, test_mod.evaluate_design)
            test_mod.evaluate_design = ev
            try:
                if where != "cpu":
                    _zero_launches()
                t0 = time.perf_counter()
                res, _f1, _r2, preds = test_mod.main(test_args, device=where)
                wall = time.perf_counter() - t0
            finally:
                test_mod.evaluate_design = ev.fn
            if where != "cpu":
                counts = launches["test CLI"] = _read_launches()
                if counts != {k: per_fwd.get(k, 0) for k in counts}:
                    raise AssertionError(f"test CLI: launches {counts}, "
                                         f"expected {per_fwd}")
            with open(crit_path) as f:
                results.append((res[0], preds[CLI_DESIGN], json.load(f)))
            mets = ev.calls[0][2][1]
            log(f"phase 7: test CLI on {where}: {wall:.2f} s wall; runtime "
                f"{mets['runtime'] * 1e3:.2f} ms (pack "
                f"{mets['pack_s'] * 1e3:.2f} ms)  [{smi}]")
        (row, preds, crit), (row_cpu, preds_cpu, crit_cpu) = results
        if preds.shape != (int(parsed["num_paths"]),) or not np.all(
                np.isfinite(preds)):
            raise AssertionError(f"test CLI: bad predictions {preds.shape}")
        np.testing.assert_allclose(row[0], row_cpu[0], rtol=1e-4, atol=1e-4,
                                   err_msg="test CLI loss")
        arrival = np.asarray(parsed["arrival_time"])[np.asarray(
            parsed["path_endpoint"], np.int64)]
        if np.ptp(arrival) > 0:
            np.testing.assert_allclose(row[1], row_cpu[1], rtol=1e-4,
                                       atol=1e-4, err_msg="test CLI r2")
        else:
            # every path has the same arc count, so every arrival time is
            # equal: R2 divides by SS_tot, a float32 rounding residue of
            # the mean that depends on the order of the sum
            log(f"  R2 not compared: all {arrival.size} arrival times are "
                f"{arrival[0]}, so SS_tot is a rounding residue")
        np.testing.assert_allclose(preds, preds_cpu, rtol=1e-4, atol=1e-4,
                                   err_msg="test CLI predictions vs cpu")
        if crit != crit_cpu:
            raise AssertionError("predict_critical differs from the cpu's")
        log(f"phase 7: test CLI card vs cpu: loss {row[0]:.6f} / "
            f"{row_cpu[0]:.6f}, r2 {row[1]:.6f} / {row_cpu[1]:.6f}, "
            f"predictions within "
            f"{float(np.abs(preds - preds_cpu).max()):.3g} (rtol/atol "
            f"1e-4), {len(crit)} predicted critical on both: ok")
    return launches


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
    from prtp_tpu_torch.test import evaluate
    from prtp_tpu_torch.trainer import (batch_count, init_state,
                                        iterate_batches, make_optimizer,
                                        pad_batch)

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    tx = make_optimizer(LR)
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
    writer_build = start_early_writer_build()
    try:
        report = _build.build()
    except BaseException:
        writer_build[0].kill()
        writer_build[0].wait()
        raise
    early_writer = load_early_writer(writer_build)
    log(f"phase 2: built {len(report)} kernel libraries and the hazard "
        f"check's writer in {time.perf_counter() - t0:.1f} s")
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
    per_step = {name: launches_per_step(g) for name, g in graphs.items()}
    model_cpu = PathModel(CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
                          generator=torch.Generator().manual_seed(SEED))
    timer = Timer(torch, dev)
    recs = {}
    for name, g in graphs.items():
        log(f"  -- {name} --")
        recs[name] = check_kernels(torch, F, g, dev, timer, name)
        recs[name].update(check_backward_kernels(torch, g, dev, timer, name))
    recs["headline"]["flat_adam"] = check_flat_adam(
        torch, sum(p.numel() for p in model_cpu.parameters()), dev, timer)
    floors = call_floors(torch, graphs["headline"], dev, timer)
    log("  per-call floor (one-row call, same timer): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in floors.items()))
    records = []
    for name, (_src, _rep, design) in KERNEL_INFO.items():
        rec = recs[design][name]
        rec.floor_ms = floors[name]
        rec.max_abs_err = max(r[name].max_abs_err for r in recs.values()
                              if name in r)
        records.append(rec)
        log(f"  {rec.summary()}")
    check_edge_shapes(torch, dev)
    check_backward_edge_shapes(torch, dev)
    check_programmatic_hazard(torch, graphs["headline"], dev, early_writer)
    gather_probe(torch, dev, timer)
    del timer, graphs

    # ---- phase 4: the slice ----
    log("phase 4: full-width PathModel, 3 evaluation requests on the "
        "headline and 1 on the prior-row design")
    model = copy.deepcopy(model_cpu).to(dev)
    launches = {f"serve {name}": serve(torch, np, model, model_cpu, p, name,
                                       per_forward[name],
                                       REQUESTS if name == "headline" else 1)
                for name, p in parsed.items()}

    # ---- phase 5: where one request's and one train step's time goes ----
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
    time_train_step(torch, model_cpu, design, dev)

    # ---- phase 6: training ----
    log(f"phase 6: full-width PathModel from the same init (seed {SEED}), "
        f"flat Adam at lr {LR}, on the card and on the cpu")
    del designs, design, model
    torch.cuda.empty_cache()
    cpu_designs = {name: pack_design(p, map_size=MAP_SIZE, device="cpu")
                   for name, p in parsed.items()}
    card_designs = {name: pack_design(p, map_size=MAP_SIZE, device=dev)
                    for name, p in parsed.items()}
    fixed = np.random.default_rng(0).permutation(num_paths)  # bench.py:308
    flips = {name: pool_winner_flips(torch, model_cpu.cnn,
                                     copy.deepcopy(model_cpu.cnn).to(dev),
                                     d.cnn_input, dev)
             for name, d in cpu_designs.items()}
    log(f"  LayoutNet max-pool windows whose winner differs, card vs cpu, "
        f"at the init: {flips}")
    runs = {
        "train headline epoch": ("headline", lambda d: list(iterate_batches(
            np.arange(num_paths), TRAIN_BATCH,
            np.random.default_rng(EPOCH_SEED), device=d))),
        "train prior_rows": ("prior_rows", lambda d: list(iterate_batches(
            np.arange(int(parsed["prior_rows"]["num_paths"])), TRAIN_BATCH,
            np.random.default_rng(EPOCH_SEED), device=d))[:PRIOR_STEPS]),
        "train headline fixed batch": ("headline", lambda d: [
            pad_batch(fixed, num_paths, d)] * FIXED_STEPS),
    }
    for what, (name, batches_on) in runs.items():
        batches = batches_on(dev)
        if what.endswith("epoch"):
            valid = [int(m.sum()) for _i, m in batches]
            log(f"  {what}: {len(batches)} batches of {TRAIN_BATCH}, valid "
                f"{valid}")
            if len(batches) != batch_count(num_paths, TRAIN_BATCH, False):
                raise AssertionError(f"{what}: {len(batches)} batches")
        card = train_run(torch, init_state(copy.deepcopy(model_cpu), tx,
                                           DEVICE),
                         card_designs[name], batches, what, per_step[name])
        launches[what] = card[2]
        cpu = train_run(torch, init_state(copy.deepcopy(model_cpu), tx,
                                          "cpu"),
                        cpu_designs[name], batches_on("cpu"), what)
        compare_runs(torch, what, card, cpu, flips[name])
        if what.endswith("fixed batch") and not card[0][-1] < card[0][0]:
            raise AssertionError(f"{what}: the loss did not fall: {card[0]}")

    # ---- phase 7: the CLIs ----
    del cpu_designs, card_designs
    torch.cuda.empty_cache()
    launches.update(cli_phase(torch, np, dev, smi))
    for rec in records:
        rec.launches = {what: c[rec.name] for what, c in launches.items()}
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
