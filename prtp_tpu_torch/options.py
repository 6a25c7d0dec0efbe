"""CLI flag surface.

A copy of ``prtp_tpu/options.py``: the same flags, types and defaults,
so that an experiment script runs unchanged against either package. One
default differs: ``--compile_cache_dir`` is ``""``, since the port has
no XLA compile cache.

Flags fall in two groups here:

- **Accepted no-ops**: flags that only shape XLA's work or
  pick what the port always does. ``--exact_levels`` (the port always
  packs exact levels; with bf16 it picks the train steps' rounding, and
  with the validation design count validation's, as in JAX:
  ``train.train_rounding``, ``train.eval_rounding``),
  ``--scan_groups`` (in the bf16 scan rounding it picks the rows that
  the train steps' bias gradients sum, JAX's grouped scan's:
  ``graph.scan_pair_rows``), ``--gnn_unroll``,
  ``--compile_cache_dir``, ``--pallas`` and ``--flat_adam`` (flat Adam is
  the port's only optimizer); and, as in the JAX package, the
  reference's commented-out ``--balanced``, ``--data_info_txt`` and
  ``--data_usage``.
- Everything else is honored as the JAX package honors it; ``--dp``
  and ``--mesh_shape`` run the CLIs data-parallel over one process a
  card (``parallel/``).
"""

import argparse


def get_options(args=None):
    parser = argparse.ArgumentParser(
        description="pre-routing timing prediction (PyTorch/CUDA port)"
    )
    # --- parity flags (reference src/options.py:6-51) ---
    parser.add_argument("--learning_rate", type=float, default=1e-3,
                        help="the learning rate for training. Type: float.")
    parser.add_argument("--batch_size", type=int, default=1350,
                        help="the number of samples in each training batch. Type: int")
    parser.add_argument("--num_epoch", type=int, default=1000,
                        help="number of epoches that the training procedure runs. Type: int")
    parser.add_argument("--in_dim", type=int, default=512,
                        help="the dimension of the input feature. Type: int")
    parser.add_argument("--out_dim", type=int, default=128,
                        help="the dimension of the output embedding. Type: int")
    parser.add_argument("--cell_feat_dim", type=int, default=42,
                        help="the dimension of the cell feature. Type: int")
    parser.add_argument("--net_feat_dim", type=int, default=3,
                        help="the dimension of the net feature. Type: int")
    parser.add_argument("--hidden_dim", type=int, default=256,
                        help="the dimension of the intermediate GNN layers. Type: int")
    parser.add_argument("--cnn_input_dim", type=int, default=512)
    parser.add_argument("--cnn_outdim", type=int, default=128)
    parser.add_argument("--map_size", type=int, default=128)
    parser.add_argument("--gcn_dropout", type=float, default=0,
                        help="dropout rate for GNN layers. Type: float")
    parser.add_argument("--mlp_dropout", type=float, default=0,
                        help="dropout rate for mlp. Type: float")
    parser.add_argument("--weight_decay", type=float, default=0,
                        help="weight decay. Type: float")
    parser.add_argument("--model_saving_dir", type=str,
                        default="../models/asap7-designs",
                        help="the directory to save the trained model. Type: str")
    parser.add_argument("--preprocess", action="store_true",
                        help="run the preprocess procedure (dataset generation + "
                             "model init) instead of normal training")
    parser.add_argument("--n_fcn", type=int, default=3,
                        help="the number of fully connected layers of the mlp. Type: int")
    parser.add_argument("--alpha", type=float, default=1.0,
                        help="the weight of the cost-sensitive learning. Type: float")
    parser.add_argument("--change_lr", action="store_true",
                        help="override the checkpointed learning rate on resume")
    parser.add_argument("--change_alpha", action="store_true",
                        help="override the checkpointed alpha on resume")
    parser.add_argument("--gpu", type=int, default=0,
                        help="index of the CUDA card. Type: int")
    parser.add_argument("--nlabels", type=int, default=1,
                        help="number of prediction classes. Type: int")
    parser.add_argument("--os_rate", type=int, default=1,
                        help="the oversampling rate. Type: int")
    parser.add_argument("--beta", type=float, default=0.5,
                        help="threshold for binary classification to trade off "
                             "recall and precision. Type: float")
    parser.add_argument("--data_save_path", type=str,
                        default="../datasets/asap7-designs",
                        help="the directory that contains the dataset. Type: str")
    parser.add_argument("--rawdata_path", type=str, default="../rawdata/example")
    parser.add_argument("--predict_path", type=str,
                        default="../prediction/example",
                        help="the directory used to save the prediction result. Type: str")
    parser.add_argument("--droplast", action="store_true")
    parser.add_argument("--feat_reduce", type=int, nargs="+", default=[6, 1])
    parser.add_argument("--no_cnn", action="store_true")
    parser.add_argument("--no_gnn", action="store_true")
    parser.add_argument("--masking", type=str, default="critical")
    parser.add_argument("--design", type=str)
    parser.add_argument("--unet", action="store_true",
                        help="use the U-Net architecture for the layout "
                             "branch")
    parser.add_argument("--pooling", type=str, default="max",
                        help="the pooling type for layoutnet")
    parser.add_argument("--norm", action="store_true",
                        help="min-max normalize the input features")
    parser.add_argument("--task", type=str, default="reg",
                        help="classification or regression task, valid: "
                             "['cls','reg']")
    parser.add_argument("--attn", action="store_true",
                        help="apply the attention mechanism in the GNN")
    parser.add_argument("--num_heads", type=int, default=1,
                        help="the number of heads for the attention mechanism "
                             "(must divide --out_dim)")
    # Commented-out in the reference (src/options.py:31,37-38) but part
    # of its historical CLI surface — accepted here as no-ops so older
    # experiment scripts that still pass them don't crash argparse.
    parser.add_argument("--balanced", action="store_true",
                        help="accepted for script compatibility; no-op "
                             "(commented out in the reference)")
    parser.add_argument("--data_info_txt", type=str, default=None,
                        help="accepted for script compatibility; no-op "
                             "(commented out in the reference)")
    parser.add_argument("--data_usage", type=str, default=None,
                        help="accepted for script compatibility; no-op "
                             "(commented out in the reference)")

    # --- the JAX package's additions (not in the reference) ---
    ext = parser.add_argument_group(
        "additions", "the JAX package's additions; those that only shape "
        "XLA's work are accepted no-ops here")
    ext.add_argument("--mesh_shape", type=int, nargs="+", default=None,
                     help="data-parallel mesh shape: --mesh_shape N runs N "
                          "ranks, one a CUDA card (1-D only). Default: all "
                          "visible cards")
    ext.add_argument("--dp", action="store_true",
                     help="data parallelism over the path batch, one "
                          "process a card (torch.distributed)")
    ext.add_argument("--compute_dtype", type=str, default="float32",
                     choices=["float32", "bfloat16"],
                     help="dtype for GNN/CNN activations")
    ext.add_argument("--merge_designs", action="store_true",
                     help="train on ONE super-graph merging all train "
                          "designs")
    ext.add_argument("--compile_cache_dir", type=str, default="",
                     help="no-op: the port has no XLA compile cache")
    ext.add_argument("--pallas", action="store_true",
                     help="no-op (deprecated in the JAX package too)")
    ext.add_argument("--exact_levels", action="store_true",
                     help="no-op: the port always packs each design with "
                          "its true per-level shapes")
    ext.add_argument("--scan_groups", type=int, default=1,
                     help="groups of lax.scan over level pairs; the port "
                          "walks the levels eagerly, and in bf16 sums the "
                          "bias gradients over the grouped scan's rows")
    ext.add_argument("--flat_adam", action="store_true",
                     help="no-op: Adam over one flat parameter vector is "
                          "the port's only optimizer")
    ext.add_argument("--gnn_unroll", type=int, default=1,
                     help="no-op: lax.scan unroll factor over level pairs")
    ext.add_argument("--seed", type=int, default=9294,
                     help="RNG seed (reference hardcodes 9294 at src/train.py:596)")
    ext.add_argument("--max_steps", type=int, default=None,
                     help="optional hard cap on optimizer steps (smoke tests)")
    ext.add_argument("--val_interval", type=int, default=50,
                     help="validate every N batches (reference: 50, src/train.py:566)")
    ext.add_argument("--steps_per_dispatch", type=int, default=8,
                     help="optimizer steps (distinct shuffled batches) run "
                          "as one trainer.train_steps call whose metrics "
                          "are read once. 1 = strict per-batch steps. "
                          "Validation triggers align to chunk boundaries.")
    ext.add_argument("--debug_nans", action="store_true",
                     help="run training under "
                          "torch.autograd.set_detect_anomaly (the "
                          "reference's src/train.py:452)")
    ext.add_argument("--profile_dir", type=str, default=None,
                     help="write a torch.profiler trace of the train loop "
                          "here (trace.json)")
    ext.add_argument("--preprocess_workers", type=int, default=1,
                     help="parallel worker processes for dataset generation "
                          "(designs are independent; reference is serial)")

    options = parser.parse_args(args)
    if options.task not in ("reg", "cls"):
        raise ValueError(f"--task {options.task!r}: valid are 'cls' and "
                         "'reg'")
    return options
