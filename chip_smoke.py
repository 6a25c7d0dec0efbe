#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (prtp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (nonzero exit) on any error:

1. Print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions; turn TF32 off for matmuls and convolutions (the slice
   is float32).
2. Build every CUDA kernel of the path from ``prtp_tpu_torch/csrc``.
3. Build and pack the bench headline design (80k nodes, 20 levels,
   seed 7) and hold each kernel against its plain PyTorch version on the
   card at every shape the walk gives it (an all-invalid mailbox row
   added), timing kernel, plain version, and the one PyTorch call that
   computes the same function where there is one. Then the kernels'
   other code paths at edge shapes, and the row gather at the TPU probe's
   shapes (160,000 x 128 bf16, 129,202 rows).
4. The slice: the full-width float32 regression fusion model, random
   weights from a seed, answers three evaluation requests over all 597
   paths through ``evaluate_design``; the launch counters (zeroed just
   before) must show every kernel ran; the predictions must match the
   same model and design on the CPU (plain versions) at rtol/atol 1e-4.
5. Where one request's time goes: device time of the forward, the walk
   and LayoutNet (CUDA events), and the device's busy and idle share of
   an evaluate call (torch.profiler).

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
REQUESTS = 3
# H100 SXM peak rates (dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPS, WARMUP = 10, 2
SPIN_CYCLES_PER_MS = 2_000_000  # about the H100's SM clock
DEVICE = "cuda:0"


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
    """Sums one kernel's numbers over the calls of one forward."""

    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.ms = self.plain_ms = 0.0
        self.library_ms = None
        self.bytes = self.ops = 0.0
        self.max_abs_err = 0.0
        self.launches = None

    def add(self, ms, plain_ms, library_ms, nbytes, ops, err):
        self.ms += ms
        self.plain_ms += plain_ms
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms
        self.bytes += nbytes
        self.ops += ops
        self.max_abs_err = max(self.max_abs_err, err)

    def as_json(self):
        bound_ms, bound_by = bound(self.bytes, self.ops)
        return {"name": self.name, "ok": True, "route": "cuda",
                "source": self.source, "replaces": self.replaces,
                "launches": self.launches,
                "launches_per_request": self.launches // REQUESTS,
                "max_abs_err": self.max_abs_err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": self.library_ms}


def check_kernels(torch, F, graph, dev, timer):
    """Phase 3: every kernel against its plain version at the walk's
    shapes. Returns the three KernelRecords."""
    from prtp_tpu_torch.ops.fused_gnn import (local_mean, local_mean_plain,
                                              softmax_sum, softmax_sum_plain)
    from prtp_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    d = 128
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = torch.randn((graph.num_rows + 1, d), generator=gen, device=dev)
    rec_g = KernelRecord("gather_rows", "prtp_tpu_torch/csrc/gather_rows.cu",
                         "scripts/gather_roofline.py:142")
    rec_s = KernelRecord("softmax_sum", "prtp_tpu_torch/csrc/softmax_sum.cu",
                         "prtp_tpu/ops/fused_gnn.py:72")
    rec_m = KernelRecord("local_mean", "prtp_tpu_torch/csrc/local_mean.cu",
                         "prtp_tpu/ops/fused_gnn.py:194")
    for k in range(graph.num_pairs):
        pn_c, md_c = graph.cell_mail[k].shape
        idx = graph.gather_rows[k]
        gat = gather_rows_plain(h, idx)
        # ---- gather_rows: exact equality ----
        if k > 0 or idx.shape[0] > pn_c * md_c:
            out = gather_rows(h, idx)
            torch.cuda.synchronize()
            if not torch.equal(out, gat):
                raise AssertionError(f"gather_rows differs at pair {k}")
            row_b = d * h.element_size()
            nbytes = (torch.unique(idx).numel() * row_b
                      + idx.numel() * (row_b + 4))
            ms = timer.ms(lambda: gather_rows(h, idx))
            pms = timer.ms(lambda: gather_rows_plain(h, idx))
            lms = timer.ms(lambda: torch.index_select(h, 0, idx))
            rec_g.add(ms, pms, lms, nbytes, 0.0, 0.0)
            log(f"  gather_rows pair {k}: {idx.numel()} x {d} f32  kernel "
                f"{ms:.4f} ms  plain {pms:.4f}  index_select {lms:.4f}  "
                f"bound {bound(nbytes, 0)[0]:.4f}  exact")
        # ---- softmax_sum: the cell mailbox, row 0 made all-invalid ----
        if k > 0:
            m = gat[: pn_c * md_c].view(pn_c, md_c, d)
            valid = graph.cell_mail[k] != graph.num_rows
            valid[0] = False
            out = softmax_sum(m, valid)
            want = softmax_sum_plain(m, valid)
            err = float((out - want).abs().max())
            if not (torch.allclose(out, want, rtol=1e-5, atol=1e-6)
                    and bool(torch.isfinite(out).all())
                    and not bool(out[0].any())):
                raise AssertionError(f"softmax_sum differs at pair {k}: "
                                     f"max abs err {err}")
            nbytes = m.numel() * 4 + valid.numel() + pn_c * d * 4
            ops = 6.0 * m.numel()
            ms = timer.ms(lambda: softmax_sum(m, valid))
            pms = timer.ms(lambda: softmax_sum_plain(m, valid))
            rec_s.add(ms, pms, None, nbytes, ops, err)
            log(f"  softmax_sum pair {k}: ({pn_c}, {md_c}, {d})  kernel "
                f"{ms:.4f} ms  plain {pms:.4f}  bound "
                f"{bound(nbytes, ops)[0]:.4f}  max abs err {err:.3g}")
        # ---- local_mean: [new | prior | 0], row 0 made all-invalid ----
        new = torch.randn((pn_c, d), generator=gen, device=dev)
        prior = gat[pn_c * md_c:]
        buf = torch.cat([new, prior, new.new_zeros((1, d))])
        num_valid = pn_c + prior.shape[0]
        idx_n = graph.net_local_idx[k].clone()
        idx_n[0] = num_valid
        out = local_mean(buf, idx_n, num_valid)
        want = local_mean_plain(buf, idx_n, num_valid)
        lib = F.embedding_bag(idx_n.long(), buf, mode="mean",
                              padding_idx=num_valid)
        err = float((out - want).abs().max())
        if not (torch.allclose(out, want, rtol=1e-5, atol=1e-6)
                and torch.allclose(lib, want, rtol=1e-5, atol=1e-6)
                and not bool(out[0].any())):
            raise AssertionError(f"local_mean differs at pair {k}: max abs "
                                 f"err {err}")
        used = idx_n[idx_n < num_valid]
        nbytes = (torch.unique(used).numel() * d * 4 + idx_n.numel() * 4
                  + idx_n.shape[0] * d * 4)
        ops = float(idx_n.numel() * d)
        idx_l = idx_n.long()
        ms = timer.ms(lambda: local_mean(buf, idx_n, num_valid))
        pms = timer.ms(lambda: local_mean_plain(buf, idx_n, num_valid))
        lms = timer.ms(lambda: F.embedding_bag(idx_l, buf, mode="mean",
                                               padding_idx=num_valid))
        rec_m.add(ms, pms, lms, nbytes, ops, err)
        log(f"  local_mean pair {k}: {tuple(idx_n.shape)} from "
            f"{buf.shape[0]} rows  kernel {ms:.4f} ms  plain {pms:.4f}  "
            f"embedding_bag {lms:.4f}  bound {bound(nbytes, ops)[0]:.4f}  "
            f"max abs err {err:.3g}")
    return rec_g, rec_s, rec_m


def check_edge_shapes(torch, dev):
    """The kernels' other code paths, which the headline does not reach:
    every vector width of the gather (row sizes and a misaligned base
    pointer), long mailboxes (the generic softmax path), narrow and wide
    rows, and empty inputs — each against its plain version."""
    from prtp_tpu_torch.ops.fused_gnn import (local_mean, local_mean_plain,
                                              softmax_sum, softmax_sum_plain)
    from prtp_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 3, 20, 128, 300):
            for offset in (0, 1):  # 1: base pointer off 16-byte alignment
                h = randn(1000 * d + offset).to(dtype)[offset:].view(1000, d)
                for m in (0, 777):
                    idx = ints(1000, m)
                    if not torch.equal(gather_rows(h, idx),
                                       gather_rows_plain(h, idx)):
                        raise AssertionError(f"gather_rows differs: {dtype} "
                                             f"d={d} offset={offset} m={m}")
                    cases += 1
    for p, md, d in ((0, 4, 128), (300, 1, 20), (300, 8, 300), (300, 11, 128),
                     (50, 40, 7)):
        m = randn(p, md, d) * 4
        valid = torch.rand((p, md), generator=gen, device=dev) < 0.6
        if p:
            valid[0] = False
        out, want = softmax_sum(m, valid), softmax_sum_plain(m, valid)
        if not (torch.allclose(out, want, rtol=1e-5, atol=1e-6)
                and bool(torch.isfinite(out).all())):
            raise AssertionError(f"softmax_sum differs at {(p, md, d)}")
        cases += 1
    for p, md, d, n in ((0, 1, 128, 10), (300, 5, 20, 90), (300, 1, 300, 40),
                        (64, 33, 128, 500)):
        buf = torch.cat([randn(n, d), torch.zeros((1, d), device=dev)])
        idx = ints(n + 1, p, md)
        if p:
            idx[0] = n
        out, want = local_mean(buf, idx, n), local_mean_plain(buf, idx, n)
        if not torch.allclose(out, want, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"local_mean differs at {(p, md, d, n)}")
        cases += 1
    log(f"  edge shapes: {cases} cases of the three kernels match their "
        "plain versions (gather exact; reductions rtol 1e-5, atol 1e-6)")


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
                                                   make_random_design)
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.ops import KERNELS, _build
    from prtp_tpu_torch.test import evaluate, evaluate_design, pad_batch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
                 if "registers" in ln or "spill" in ln]
        log(f"  {name}: {info['seconds']:.1f} s; " + " | ".join(usage))

    # ---- phase 3: design, pack, kernels against plain versions ----
    t0 = time.perf_counter()
    sizes = bench_level_sizes(NODES, LEVELS, decay=DECAY)
    parsed = make_random_design(sizes, cell_feat_dim=CELL_FEAT,
                                net_feat_dim=NET_FEAT, map_size=MAP_SIZE,
                                cnn_hw=CNN_HW, mask_nnz_per_path=MASK_NNZ,
                                seed=SEED)
    design = pack_design(parsed, map_size=MAP_SIZE, device=dev)
    graph = design.graph
    n_edges = len(parsed["cell_edges"][0]) + len(parsed["net_edges"][0])
    log(f"phase 3: design {parsed['num_nodes']} nodes, {n_edges} edges, "
        f"{graph.num_pairs} level pairs, {parsed['num_paths']} paths; built "
        f"and packed in {time.perf_counter() - t0:.2f} s")
    timer = Timer(torch, dev)
    records = check_kernels(torch, F, graph, dev, timer)
    check_edge_shapes(torch, dev)
    gather_probe(torch, dev, timer)
    del timer

    # ---- phase 4: the slice ----
    log("phase 4: full-width PathModel, 3 evaluation requests")
    model_cpu = PathModel(CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
                          generator=torch.Generator().manual_seed(SEED))
    model = copy.deepcopy(model_cpu).to(dev)
    per_forward = {
        "gather_rows": sum(
            1 for k in range(graph.num_pairs)
            if k > 0 or graph.gather_rows[k].shape[0]
            > graph.cell_mail[k].numel()),
        "softmax_sum": graph.num_pairs - 1,
        "local_mean": graph.num_pairs,
    }
    del design, graph
    torch.cuda.synchronize()
    for kern in KERNELS:
        kern.launches = 0
    outs = []
    for req in range(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, mets = evaluate_design(model, parsed, device=dev,
                                      case_idx=req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs.append(preds)
        log(f"  request {req}: wall {wall * 1e3:.2f} ms (pack "
            f"{mets['pack_s'] * 1e3:.2f} ms, evaluate "
            f"{mets['runtime'] * 1e3:.2f} ms)  loss {mets['loss']:.6f}  "
            f"r2 {mets['r2']:.6f}  tp {mets['tp']:.0f} fp {mets['fp']:.0f} "
            f"tn {mets['tn']:.0f} fn {mets['fn']:.0f}")
    counts = {kern.__name__: kern.launches for kern in KERNELS}
    log(f"  launches in the 3 requests: {counts}; per forward expected "
        f"{per_forward}")
    for rec in records:
        if counts[rec.name] != REQUESTS * per_forward[rec.name]:
            raise AssertionError(f"{rec.name}: {counts[rec.name]} launches, "
                                 f"expected {REQUESTS * per_forward[rec.name]}")
        rec.launches = counts[rec.name]
    num_paths = int(parsed["num_paths"])
    for preds in outs:
        if preds.shape != (num_paths,) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"bad predictions {preds.shape}")
    log("  reference: the same model and design on the CPU (plain versions)")
    t0 = time.perf_counter()
    preds_cpu, mets_cpu = evaluate_design(model_cpu, parsed, device="cpu",
                                          case_idx=REQUESTS)
    log(f"  cpu request: {time.perf_counter() - t0:.2f} s  loss "
        f"{mets_cpu['loss']:.6f}  r2 {mets_cpu['r2']:.6f}")
    for req, preds in enumerate(outs):
        diff = float(np.abs(preds - preds_cpu).max())
        np.testing.assert_allclose(preds, preds_cpu, rtol=1e-4, atol=1e-4,
                                   err_msg=f"request {req} vs cpu")
        log(f"  request {req} vs cpu: max abs diff {diff:.3g} (rtol/atol "
            "1e-4): ok")

    # ---- phase 5: where one request's time goes ----
    design = pack_design(parsed, map_size=MAP_SIZE, device=dev)
    pids, mask = pad_batch(np.arange(num_paths), num_paths, dev)
    timer = Timer(torch, dev)
    with torch.no_grad():
        parts = {
            "forward": lambda: model(design, pids),
            "walk": lambda: model.gnn(design.graph),
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        evaluate(model, design, pids, mask)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us(), cnt + 1)
    if by_name:
        busy_ms = sum(t for t, _ in by_name.values()) / 1e3
        log(f"  evaluate: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} "
            f"ms (torch.profiler), idle share {1 - busy_ms / wall_ms:.3f}; "
            f"{sum(c for _, c in by_name.values())} kernel launches")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        for name, (tot, cnt) in top:
            log(f"    {tot / 1e3:8.3f} ms  x{cnt:<4d} {name[:90]}")
    else:
        log(f"  evaluate: wall {wall_ms:.3f} ms; device busy not measured "
            "(torch.profiler recorded no device kernels)")
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for rec in records:
        log(f"  {rec.name}: {rec.launches // REQUESTS} launches per request, "
            f"{rec.ms:.4f} ms per forward against a bound of "
            f"{bound(rec.bytes, rec.ops)[0]:.4f} ms")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": [rec.as_json() for rec in records]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
