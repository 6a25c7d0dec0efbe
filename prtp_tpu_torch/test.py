"""Evaluation: the serving path and the evaluation CLI of the port.

Port of ``prtp_tpu/test.py`` and of ``prtp_tpu/trainer.py``'s
``make_eval_step``, for both tasks (the loss, the metrics and
``pad_batch`` live in ``trainer.py``). :func:`evaluate` runs the model
in eval mode (the U-Net's BatchNorm on its running averages) over a
batch of paths of a packed design and returns predictions and metrics;
:func:`evaluate_design` packs one parsed design, evaluates all of its
paths and prints the per-level R²/MAPE lines (regression only) and the
case lines in the JAX driver's formats.

The CLI (:func:`main`, CLI parity with the reference ``python test.py``,
``src/test.py``) computes in float32 (TF32 off) or, with
``--compute_dtype bfloat16``, in the model's mixed precision on designs
packed in float32 (as JAX's test CLI packs them), the walk's pair-step
MLPs rounded as JAX's padded scan rounds them (``rounding="scan"``: JAX's
test CLI always evaluates through it), loads the trained torch
checkpoint, evaluates every design of the test list over all of its
paths and, for regression, saves a relative-error vs level scatter plot
per design to ``visual/{case}.png`` (``:244-249``) and the
predicted-critical path ids to ``predict_critical/{design}.json``; it
appends the overall metric row to ``predict.txt`` (``:315-317``). With
``--dp`` / ``--mesh_shape N`` each design's paths, rounded up to a
multiple of the N ranks, are evaluated data-parallel
(``parallel.dp.dp_evaluate``) and only rank 0 writes those files.

Usage:
    python -m prtp_tpu_torch.test --data_save_path ... --model_saving_dir ...
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .data.dataset import get_design_list, load_design_npz
from .graph import pack_design
from .models.fusion import model_from_options
from .options import get_options
from .parallel import (is_main_process, maybe_initialize, requested_ranks,
                       run_ranks)
from .parallel.dp import dp_evaluate
from .trainer import (init_state, make_optimizer, pad_batch,
                      task_loss_and_metrics)
from .utils import checkpoint as ckpt
from .utils import metrics as M
from .utils.tee import main_process_stdout

__all__ = ["evaluate", "evaluate_design", "load_model_state", "main",
           "pad_batch", "test"]


@torch.no_grad()
def evaluate(model, design, path_ids, mask, task: str = "reg",
             rounding: str | None = None):
    """(preds, metrics) of ``task`` for a batch of path ids, the model in
    eval mode, its walk in bf16 ``rounding`` (:class:`~prtp_tpu_torch.
    models.fusion.PathModel`); metrics are 0-d tensors."""
    model.eval()
    preds = model(design, path_ids, rounding=rounding)
    return preds, task_loss_and_metrics(task, preds, design, path_ids,
                                         mask)[1]


def evaluate_design(model, parsed, device="cuda", case_idx: int = 0,
                    task: str = "reg", rounding: str = "scan", mesh=None):
    """Pack ``parsed`` on ``device``, evaluate all of its paths and print
    the JAX driver's case lines, after the per-level lines for
    ``task="reg"``. A bf16 model's walk rounds as ``rounding`` says; the
    default is the test CLI's, JAX's padded scan (``"scan"``), which
    JAX's test CLI always evaluates through. With ``mesh``
    (``parallel.Mesh``) the paths, padded to a multiple of its ranks, are
    evaluated data-parallel, and every rank gets all predictions.

    Returns ``(preds, metrics)``: numpy predictions of every path, and
    host floats (``loss, r2, tp, fp, tn, fn, acc, recall, precision,
    f1``, ``runtime`` = evaluation seconds, ``pack_s`` = packing
    seconds)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    design = pack_design(parsed, map_size=model.map_size, device=dev,
                         segment=model.gnn_reduce == "segment")
    pack_s = time.perf_counter() - t0
    num_paths = int(parsed["num_paths"])
    start = time.perf_counter()
    cap = design.num_paths
    if mesh is not None:
        cap = -(-cap // mesh.size) * mesh.size
    pids, mask = pad_batch(np.arange(num_paths), cap, dev)
    if mesh is None:
        preds_t, mets_t = evaluate(model, design, pids, mask, task, rounding)
    else:
        preds_t, mets_t = dp_evaluate(model, design, pids, mask, mesh, task,
                                      rounding)
    preds = preds_t.cpu().numpy()[:num_paths]
    mets = {k: float(v) for k, v in mets_t.items()}
    runtime = time.perf_counter() - start

    if task == "reg":
        _print_levels(parsed, preds)
    acc, recall, precision, f1 = M.classification_metrics(
        mets["tp"], mets["fp"], mets["tn"], mets["fn"])
    print(f"case {case_idx}, runtime: {runtime}")
    print(f"\ttp: {int(mets['tp'])}  fp: {int(mets['fp'])} "
          f" fn: {int(mets['fn'])}  tn: {int(mets['tn'])} "
          f" precision: {round(precision, 3)}")
    print(f"\tloss:{mets['loss']:.3f}, r2:{mets['r2']:.3f}, acc:{acc:.3f}, "
          f"recall:{recall:.3f}, F1 score:{f1:.3f}")
    mets.update(acc=acc, recall=recall, precision=precision, f1=f1,
                runtime=runtime, pack_s=pack_s)
    return preds, mets


def _print_levels(parsed, preds):
    """Per-level R² and MAPE (reference src/test.py:211-216)."""
    levels = np.asarray(parsed["path2level"])
    endpoint = np.asarray(parsed["path_endpoint"], np.int64)
    arrival = torch.from_numpy(np.asarray(parsed["arrival_time"],
                                          np.float32)[endpoint])
    preds_cpu = torch.from_numpy(preds)
    for lvl in np.unique(levels):
        sel = torch.from_numpy(levels == lvl)
        if int(sel.sum()) >= 2:
            r2_l = float(M.r2_score(preds_cpu[sel], arrival[sel]))
            mape_l = float(M.mape(preds_cpu[sel], arrival[sel]))
            print(f"level {lvl}: #={int(sel.sum())}, r2={r2_l}, "
                  f"mape={mape_l}")


def load_model_state(options, sample_parsed, device="cuda"):
    """Restore the checkpoint (must exist — reference src/test.py:37)
    into a model whose feature widths and raster channels are
    ``sample_parsed``'s. Returns (model, state, config)."""
    if not ckpt.checkpoint_exists(options.model_saving_dir):
        raise FileNotFoundError(f"no checkpoint in {options.model_saving_dir}")
    model = model_from_options(options, sample_parsed["cell_feat"].shape[1],
                               sample_parsed["net_feat"].shape[1],
                               sample_parsed["cnn_input"].shape[0])
    state = init_state(model, make_optimizer(options.learning_rate,
                                             options.weight_decay), device)
    state, config = ckpt.load_checkpoint(options.model_saving_dir, state)
    return model, state, config


def _feat_adjusted(parsed, options):
    if options.feat_reduce is not None:
        if options.feat_reduce[1] != 0:
            parsed["net_feat"] = parsed["net_feat"][:, :-options.feat_reduce[1]]
        if options.feat_reduce[0] != 0:
            parsed["cell_feat"] = parsed["cell_feat"][:, :-options.feat_reduce[0]]
    if options.norm:
        from .data.dataset import min_max_norm
        parsed["cell_feat"] = min_max_norm(parsed["cell_feat"],
                                           parsed["num_ctypes"])
    return parsed


def test(options, designs, device="cuda", mesh=None):
    """Evaluate all paths of each design (reference test(), :124-318),
    data-parallel over ``mesh``'s ranks if given (only rank 0 writes).

    Returns ``(res, overall_f1, overall_r2, preds)``: ``res`` one metric
    row ``[loss, r2, acc, recall, precision, f1]`` per design, ``preds``
    each design's numpy predictions."""
    dev = resolve_device(device)
    res_save_path = os.path.join(options.model_saving_dir, "predict.txt")
    overall = dict(loss=0.0, r2=0.0, acc=0.0, recall=0.0, precision=0.0,
                   f1=0.0)
    res = []
    preds_by_design = {}

    parsed_all = [_feat_adjusted(load_design_npz(
        os.path.join(options.data_save_path, f"{d}.npz")), options)
        for d in designs]
    model, _state, _config = load_model_state(options, parsed_all[0], dev)

    for case_idx, (design, parsed) in enumerate(zip(designs, parsed_all)):
        # prints the per-level diagnostics (reg) and the case lines
        preds, mets = evaluate_design(model, parsed, dev, case_idx,
                                      options.task, mesh=mesh)
        preds_by_design[design] = preds
        if options.task == "reg" and is_main_process():
            levels = parsed["path2level"]
            arrival = parsed["arrival_time"][parsed["path_endpoint"]]
            _plot_relative_error(options, case_idx, levels, preds, arrival)
            # predicted-critical path ids (capability of the reference's
            # predict_critical dumps, src/test.py:408-411, JSON not pickle)
            required = parsed["required_time"][parsed["path_endpoint"]]
            pred_crit = np.nonzero(required - preds < 0)[0].tolist()
            crit_dir = os.path.join(options.model_saving_dir,
                                    "predict_critical")
            os.makedirs(crit_dir, exist_ok=True)
            with open(os.path.join(crit_dir, f"{design}.json"), "w") as f:
                json.dump(pred_crit, f)
        row = [mets[k] for k in ("loss", "r2", "acc", "recall", "precision",
                                 "f1")]
        for k, v in zip(("loss", "r2", "acc", "recall", "precision", "f1"),
                        row):
            overall[k] += v
        res.append(row)

    n = max(len(designs), 1)
    for k in overall:
        overall[k] /= n
    print("overall val")
    print(f"\tloss:{overall['loss']:.3f}, r2:{overall['r2']:.3f}, "
          f"acc:{overall['acc']:.3f}, recall:{overall['recall']:.3f}, "
          f"F1 score:{overall['f1']:.3f}")
    if is_main_process():
        with open(res_save_path, "a") as f:
            f.write("{:.3f} {:.3f} {:.3f} {:.3f} {:.3f} {:.3f}\n".format(
                overall["loss"], overall["r2"], overall["acc"],
                overall["recall"], overall["precision"], overall["f1"]))
    return res, overall["f1"], overall["r2"], preds_by_design


def _plot_relative_error(options, case_idx, levels, preds, arrival):
    """Scatter of relative error vs topo level -> visual/{case}.png
    (reference src/test.py:244-249). Soft dependency on matplotlib,
    imported here and not with the module."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    rel = (preds - arrival) / np.where(arrival == 0, 1.0, arrival)
    plt.scatter(levels, rel)
    out_dir = os.path.join(options.model_saving_dir, "visual")
    os.makedirs(out_dir, exist_ok=True)
    plt.savefig(os.path.join(out_dir, f"{case_idx}.png"))
    plt.close()


def _run(options, mesh, dev):
    """One process's evaluation CLI on ``dev``, in float32 and
    deterministic algorithms; only rank 0 prints."""
    from .train import use_deterministic, use_float32

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    use_float32()
    designs = get_design_list(options.data_save_path, "test")
    with use_deterministic(), main_process_stdout():
        return test(options, designs, dev, mesh)


def main(argv=None, device="cuda", backend=None):
    """The evaluation CLI, in float32 (TF32 off for the process) and
    deterministic algorithms (``train.use_deterministic``); returns
    :func:`test`'s result, or None where it started its data-parallel
    ranks (``--dp`` / ``--mesh_shape``, as the train CLI does) as
    processes of their own."""
    from .train import select_device

    options = get_options(argv)
    resolve_device(device)
    maybe_initialize(device, backend)
    options.cell_feat_dim -= options.feat_reduce[0]
    options.net_feat_dim -= options.feat_reduce[1]
    world = requested_ranks(options, device)
    if world is None:
        return _run(options, None, select_device(options, device))
    if options.gpu:
        raise SystemExit(f"--gpu {options.gpu} with --dp: each data-parallel"
                         " rank drives its own card (rank r on cuda:r)")
    return run_ranks(_run, options, device, backend)


if __name__ == "__main__":
    main(sys.argv[1:])
