"""Training driver.

Port of ``prtp_tpu/train.py``: CLI parity with the reference ``python
train.py`` (``src/train.py``). The same flags (``options.py``), the same
loop (epochs over designs over shuffled padded path batches, validate
every ``--val_interval`` batches and at each design's end, a
save-on-best-validation checkpoint), the same printed lines, letter for
letter; on :mod:`prtp_tpu_torch.trainer`'s eager train step. A chunk of
``--steps_per_dispatch`` batches is one ``trainer.train_steps`` call
whose metrics are read once. What only XLA needed (bucket shapes, scan
groups, the abstract init) is gone. With ``--dp`` / ``--mesh_shape N``
the steps are data-parallel (``parallel/dp.py``): the batch size is
rounded up to a multiple of the ranks, every rank draws the same
shuffled batches and takes its block, validation runs on every rank's
replicated state, and only rank 0 writes the log, the config, the seed
file and the checkpoints. Without a process group the CLI starts the
ranks itself (``parallel.run_ranks``: rank r on ``cuda:r``); under
torchrun or ``PRTP_COORDINATOR`` (``parallel.maybe_initialize``) it
joins the group. With ``--merge_designs`` the
train designs form one super-graph (``graph.merge_parsed_designs``),
trained on grouped ``(K, batch)`` batches as the unit
``"+".join(train_designs)``; validation stays per design.

Usage:
    python -m prtp_tpu_torch.train --data_save_path ... --model_saving_dir ...

``main(argv, device="cuda")`` runs on the card (``--gpu`` picks which)
in float32: it turns TF32 off for the process (:func:`use_float32`), as
the JAX reference computes. ``--compute_dtype bfloat16`` runs the model
in JAX's mixed precision (``models/fusion.py``) on designs packed in
bf16; the parameters, Adam's moments, the loss and the metrics stay
float32. Tests pass ``device="cpu"``. Without a card it raises.
"""

from __future__ import annotations

import os
import random
import sys

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from .data.dataset import (get_design_list, load_design_shapes,
                           load_single_design)
from .graph import (merge_parsed_designs, pack_design, scan_level_rows,
                    scan_pair_rows)
from .models.fusion import model_from_options
from .options import get_options
from .parallel import is_main_process, maybe_initialize, requested_ranks
from .parallel import run_ranks
from .parallel.dp import broadcast_state, dp_train_steps
from .test import evaluate
from .trainer import (DesignCache, batch_count, init_state, iterate_batches,
                      iterate_grouped_batches, make_optimizer, pad_batch,
                      train_steps)
from .utils import checkpoint as ckpt
from .utils import metrics as M
from .utils.tee import StderrTee, StdoutTee

_METRICS = ("loss", "r2", "tp", "fp", "tn", "fn")


def next_val_trigger(bidx: int, num_batch: int, val_interval: int) -> int:
    """Smallest batch index >= bidx at which the reference validates:
    ``b % val_interval == 0 or b == num_batch - 1``
    (src/train.py:566-568)."""
    vi = max(int(val_interval), 1)
    next_multiple = ((bidx + vi - 1) // vi) * vi
    return min(next_multiple, num_batch - 1)


def _load(usage, options, design):
    return load_single_design(
        usage, options.data_save_path, design,
        os_rate=options.os_rate, feat_reduce=options.feat_reduce,
        if_norm=options.norm)


def _read(mets) -> list:
    """The metrics of ``_METRICS`` as host lists (or floats), in one
    device read."""
    return torch.stack([mets[k] for k in _METRICS]).tolist()


def eval_rounding(options, val_designs) -> str:
    """The bf16 rounding of validation's walk, by JAX's rule
    (``prtp_tpu/train.py:154-206``): its fused exact walk (``"fused"``)
    only under ``--exact_levels`` with at most one validation design;
    otherwise JAX packs validation for its padded scan (or, with
    ``--scan_groups``, its grouped packing), whose pair-step MLPs round
    as flax's ``MLP(dtype=bfloat16)`` compiled (``"scan"``)."""
    if options.exact_levels and len(val_designs) <= 1:
        return "fused"
    return "scan"


def train_rounding(options) -> str:
    """The bf16 rounding of the train steps' walk, by JAX's rule
    (``prtp_tpu/train.py:154-171``): its fused exact walk (``"fused"``)
    only under ``--exact_levels``; otherwise JAX packs for its padded scan
    (or, with ``--scan_groups``, its grouped scan), whose pair-step MLPs
    round, forward and backward, as flax's ``MLP(dtype=bfloat16)``
    compiled (``"scan"``). In float32 the two are one function."""
    return "fused" if options.exact_levels else "scan"


def train_scan_rows(options, parsed, bucket=None):
    """The level rows of the scan JAX's train steps run ``parsed``
    through, which the bf16 bias gradients of the scan rounding sum
    (``graph.scan_pair_rows``): under ``--scan_groups`` N > 1, or 0
    (auto), the design's own grouped scan; else its padded scan, at
    ``bucket`` (the padded rows of every design, JAX's bucket) or its own
    rows. None (the packer's default) when the steps take the fused
    rounding, which reads none."""
    if train_rounding(options) != "scan":
        return None
    return scan_pair_rows(parsed, max(0, options.scan_groups), bucket=bucket)


def validate(options, val_designs, cache_val, model, device):
    """Per-design validation on the persisted val split; one padded batch
    per design (reference validate(), src/train.py:137-291), the walk in
    :func:`eval_rounding`'s rounding."""
    rounding = eval_rounding(options, val_designs)
    overall = dict(loss=0.0, r2=0.0, acc=0.0, recall=0.0, precision=0.0,
                   f1=0.0)
    res = []
    n_cases = 0
    print("validate:")
    for case_idx, design in enumerate(val_designs):
        if case_idx + 1 < len(val_designs):
            # one-ahead pipeline: pack the next design while the device
            # evaluates this one
            nxt = val_designs[case_idx + 1]
            cache_val.prefetch(nxt, lambda d=nxt: _load("test", options, d))
        pack, parsed = cache_val.get(
            design, lambda d=design: _load("test", options, d))
        ids = np.asarray(parsed["path_ids"], np.int64)
        if len(ids) == 0:
            # tiny designs can yield an empty val split (1/5 of <5 paths);
            # the reference would crash on an empty DataLoader here
            print(f"\tcase {case_idx} \t(empty val split, skipped)")
            continue
        n_cases += 1
        pids, mask = pad_batch(ids, max(pack.num_paths, len(ids), 1), device)
        _preds, mets = evaluate(model, pack, pids, mask, options.task,
                                rounding)
        loss, r2, tp, fp, tn, fn = _read(mets)
        acc, recall, precision, f1 = M.classification_metrics(tp, fp, tn, fn)
        for k, v in zip(("loss", "r2", "acc", "recall", "precision", "f1"),
                        (loss, r2, acc, recall, precision, f1)):
            overall[k] += v
        print(f"\tcase {case_idx} \tl:{loss:.3f}, r2:{r2:.3f}, "
              f"rc:{recall:.3f}, F1:{f1:.3f}")
        res.append([loss, r2, acc, recall, precision, f1])
    n = max(n_cases, 1)
    for k in overall:
        overall[k] /= n
    print(f"\toverall r2:{overall['r2']:.3f}, rc:{overall['recall']:.3f}, "
          f"F1:{overall['f1']:.3f}")
    return res, overall["f1"], overall["r2"]


def train(options, seed, device="cuda", mesh=None):
    """The train loop; ``mesh`` (``parallel.Mesh``) makes its steps
    data-parallel over the ranks of a process group."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    print(options.data_save_path)

    # feat_reduce shrinks the declared dims (reference src/train.py:407-408);
    # config.json records them, the model takes its widths from the data
    options.cell_feat_dim -= options.feat_reduce[0]
    options.net_feat_dim -= options.feat_reduce[1]

    if mesh is not None:
        # every padded batch is exactly --batch_size long; round it up to
        # a multiple of the ranks (pad rows carry zero loss weight)
        options.batch_size = -(-options.batch_size // mesh.size) * mesh.size
        print(f"--- data-parallel mesh: {mesh.size} x {dev.type} devices, "
              f"batch_size {options.batch_size}")

    train_designs = get_design_list(options.data_save_path, "train")
    val_designs = get_design_list(options.data_save_path, "test")
    print("--- train designs: ", train_designs)
    print("--- test designs: ", val_designs)

    # the feature tables and the raster in the compute dtype, as JAX's
    # train CLI packs them (its test CLI packs float32 and casts)
    pack_dtype = (torch.bfloat16 if options.compute_dtype == "bfloat16"
                  else torch.float32)
    rounding = train_rounding(options)
    # JAX pads every design's levels to one bucket for its padded scan
    # unless --scan_groups (prtp_tpu/train.py:154-176); a merged
    # super-graph is packed alone
    bucket = None
    if (rounding == "scan" and options.scan_groups == 1
            and not options.merge_designs):
        bucket = scan_level_rows(
            [load_design_shapes(os.path.join(options.data_save_path,
                                             f"{d}.npz"))
             for d in sorted(set(train_designs) | set(val_designs))])

    def packer(parsed, bucket=bucket):
        return pack_design(parsed, map_size=options.map_size, device=dev,
                           compute_dtype=pack_dtype,
                           scan_rows=train_scan_rows(options, parsed, bucket))

    cache_tr = DesignCache(packer)
    cache_val = DesignCache(packer)
    try:
        if options.merge_designs:
            # ONE super-graph over all train designs (disjoint union per
            # level, grouped path batches); validation stays per design:
            # the parameters do not depend on the designs
            first = merge_parsed_designs(
                [_load("train", options, d) for d in train_designs])
            merged_pack = packer(first, None)
            design_units = ["+".join(train_designs)]
        else:
            _pack, first = cache_tr.get(
                train_designs[0],
                lambda: _load("train", options, train_designs[0]))
            design_units = train_designs
        model = model_from_options(options, first["cell_feat"].shape[1],
                                   first["net_feat"].shape[1],
                                   first["cnn_input"].shape[-3])

        config = {k: v for k, v in vars(options).items()}
        resume = ckpt.checkpoint_exists(options.model_saving_dir)
        if mesh is not None:  # every rank looks before rank 0 writes
            dist.barrier(group=mesh.group)
        if resume:
            saved_cfg = ckpt.load_config(options.model_saving_dir)
            # resume-with-overrides (reference src/train.py:123-126)
            if not options.change_lr and "learning_rate" in saved_cfg:
                options.learning_rate = float(saved_cfg["learning_rate"])
            if not options.change_alpha and "alpha" in saved_cfg:
                options.alpha = float(saved_cfg["alpha"])
            tx = make_optimizer(options.learning_rate, options.weight_decay)
            state, _cfg = ckpt.load_checkpoint(options.model_saving_dir,
                                               init_state(model, tx, dev))
            print("----------------Loading the model and hyper-parameters"
                  "----------------")
        else:
            tx = make_optimizer(options.learning_rate, options.weight_decay)
            state = init_state(model, tx, dev)
            os.makedirs(options.model_saving_dir, exist_ok=True)
            ckpt.save_checkpoint(options.model_saving_dir, state, config)
            print("creating model in:", options.model_saving_dir)
        if mesh is not None:
            broadcast_state(state, mesh)

        if is_main_process():
            with open(os.path.join(options.model_saving_dir, "seed.txt"),
                      "a") as f:
                f.write(str(seed))

        print("Hyperparameters are listed as follows:")
        print(options)
        print("seed:", seed)

        max_f1 = float(state.best_f1)
        max_r2 = float(state.best_r2)
        total_steps = 0
        spd = max(options.steps_per_dispatch, 1)
        print("----------------Start training---------------")
        # double-buffered input pipeline: the first validation design packs
        # in the background (the reference validates at batch 0,
        # src/train.py:566) and validate() pipelines the rest one-ahead
        if val_designs:
            cache_val.prefetch(
                val_designs[0],
                lambda d=val_designs[0]: _load("test", options, d))
        for epoch in range(options.num_epoch):
            for unit_idx, design in enumerate(design_units):
                if options.merge_designs:
                    pack, universes = merged_pack, first["path_ids_per_design"]
                    num_batch = max(batch_count(len(u), options.batch_size,
                                                False) for u in universes)
                    batches = list(iterate_grouped_batches(
                        universes, options.batch_size, rng, device=dev))
                else:
                    pack, parsed = cache_tr.get(
                        design, lambda d=design: _load("train", options, d))
                    if len(train_designs) > 1:
                        # pack the next design while this one trains
                        nxt = train_designs[(unit_idx + 1)
                                            % len(train_designs)]
                        cache_tr.prefetch(
                            nxt, lambda d=nxt: _load("train", options, d))
                    ids = parsed["path_ids"]
                    num_batch = batch_count(len(ids), options.batch_size,
                                            options.droplast)
                    batches = list(iterate_batches(
                        ids, options.batch_size, rng,
                        drop_last=options.droplast, device=dev))
                bidx = 0
                while bidx < len(batches):
                    # strict validation cadence: a chunk never runs past a
                    # validation trigger — it ends exactly ON the triggering
                    # batch, as the reference's every-val_interval policy
                    # does (src/train.py:566-568)
                    take = min(spd, next_val_trigger(
                        bidx, num_batch, options.val_interval) - bidx + 1)
                    if options.max_steps:
                        # keep --max_steps a hard cap: never run more steps
                        # than remain under it
                        take = min(take,
                                   max(options.max_steps - total_steps, 1))
                    chunk = batches[bidx: bidx + take]
                    losses, r2s, tps, fps, tns, fns = _read(
                        train_steps(state, pack, chunk, options.task,
                                    rounding) if mesh is None else
                        dp_train_steps(state, pack, chunk, mesh,
                                       options.task, rounding))
                    for j in range(len(chunk)):
                        _acc, recall, _prec, f1 = M.classification_metrics(
                            tps[j], fps[j], tns[j], fns[j])
                        print(f"e{epoch},{design},b{bidx + j}/{num_batch}, "
                              f"l:{losses[j]:.3f}, r2:{r2s[j]:.3f}, "
                              f"r:{recall:.3f}, F1:{f1:.3f}")
                    total_steps += len(chunk)
                    end_idx = bidx + len(chunk) - 1
                    should_validate = (
                        end_idx % options.val_interval == 0
                        or end_idx == num_batch - 1)
                    bidx = end_idx + 1
                    if should_validate:
                        _res, val_f1, val_r2 = validate(
                            options, val_designs, cache_val, state.model, dev)
                        if options.task == "cls":
                            improved = val_f1 > max_f1
                        elif options.task == "reg":
                            improved = val_r2 > max_r2
                        else:
                            raise AssertionError(f"bad task {options.task}")
                        if improved:
                            max_f1, max_r2 = val_f1, val_r2
                            state.best_f1, state.best_r2 = max_f1, max_r2
                            print("Saving model.... ",
                                  options.model_saving_dir)
                            ckpt.save_checkpoint(options.model_saving_dir,
                                                 state, config)
                            print("Model successfully saved")
                    if options.max_steps and total_steps >= options.max_steps:
                        print(f"max_steps {options.max_steps} reached")
                        return state
        return state
    finally:
        cache_tr.close()
        cache_val.close()


def select_device(options, device="cuda") -> torch.device:
    """Honor the reference's ``--gpu`` device index (src/options.py):
    ``cuda:<gpu>``, validated loudly instead of silently ignored, and
    made the current card (the kernels launch on its stream)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        if options.gpu:
            raise SystemExit(f"--gpu {options.gpu} names a CUDA card, but "
                             f"the device is {dev}")
        return dev
    index = options.gpu if options.gpu else (dev.index or 0)
    n = torch.cuda.device_count()
    if index < 0 or index >= n:
        raise SystemExit(f"--gpu {index}: only {n} visible CUDA card(s) "
                         f"(indices 0..{n - 1})")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def use_float32() -> None:
    """Compute float32 matmuls and cuDNN convolutions in float32, not
    TF32 (PyTorch's default for convolutions): the precision that the
    port's parity checks hold. Process-wide, so only the CLIs call it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _profiled_train(options, seed, dev, mesh=None):
    """``train`` under torch.profiler; the trace goes to
    ``<profile_dir>/trace.json`` (rank 0's under ``--dp``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(options.profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        state = train(options, seed, dev, mesh)
    if is_main_process():
        prof.export_chrome_trace(os.path.join(options.profile_dir,
                                              "trace.json"))
    return state


def _run(options, mesh, dev):
    """One process's train CLI on ``dev``: float32, the seeds, the
    logs (rank 0's), the loop."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    use_float32()
    seed = options.seed
    random.seed(seed)
    np.random.seed(seed)
    os.makedirs(options.model_saving_dir, exist_ok=True)
    stdout_f = os.path.join(options.model_saving_dir, "stdout.log")
    stderr_f = os.path.join(options.model_saving_dir, "stderr.log")
    # analogue of th.autograd.set_detect_anomaly(True) (src/train.py:452);
    # restored on exit
    with StdoutTee(stdout_f), StderrTee(stderr_f), \
            torch.autograd.set_detect_anomaly(options.debug_nans):
        if options.profile_dir:
            return _profiled_train(options, seed, dev, mesh)
        return train(options, seed, dev, mesh)


def main(argv=None, device="cuda", backend=None):
    """The train CLI. Returns the final
    :class:`~prtp_tpu_torch.trainer.TrainState`, or None where it
    started its data-parallel ranks as processes of their own.

    ``--dp`` / ``--mesh_shape N`` train on N ranks
    (``parallel.run_ranks``; ``backend`` picks the process group's,
    NCCL for CUDA and gloo for the CPU by default); ``--gpu`` is refused
    with them, since rank r drives card r."""
    options = get_options(argv)
    resolve_device(device)
    maybe_initialize(device, backend)
    world = requested_ranks(options, device)
    if world is not None and options.gpu:
        raise SystemExit(f"--gpu {options.gpu} with --dp: each data-parallel"
                         " rank drives its own card (rank r on cuda:r)")
    if options.preprocess:
        if is_main_process():
            from .data import generate
            generate.main(argv)
        if dist.is_initialized():
            dist.barrier()
    if world is None:
        return _run(options, None, select_device(options, device))
    return run_ranks(_run, options, device, backend)


if __name__ == "__main__":
    main(sys.argv[1:])
