#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (prtp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--phases N [N ...]]

Without ``--phases`` every phase runs. With it, phases 1 and 2 run, then
only the phases named (3-16; phase 14 steps phase 9's designs, so it
brings 9; phase 15 (c) reads phase 16 (a)'s first card runs, so it
brings those), then the kernels line, of the records of the phases run,
and the last line. Phases, each failing loudly (nonzero exit) on any error:

1. Print the card (``nvidia-smi`` name, power limit and compute mode),
   the torch and CUDA versions; turn TF32 off for matmuls and convolutions (the port's
   float32, as the CLIs set it themselves) for phases 2-6 and 8-16; set
   cuBLAS's deterministic workspace (``CUBLAS_WORKSPACE_CONFIG``) for
   the run, which the CLIs' deterministic scope needs before a
   process's first cuBLAS call.
2. Build every CUDA kernel of the path from ``prtp_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once.
3. Build and pack two designs: the bench headline (80k nodes, 20
   levels, seed 7), whose net drivers all lie in the pair's own cell
   level, and the same design with 10% of each net level's drivers moved
   to an earlier cell level (prior rows). On each, hold every kernel
   against its plain PyTorch version on the card at every shape the walk
   and its backward give it (an all-invalid mailbox row added), and
   ``flat_adam`` at the full model's parameter count (step t = 2), and
   the ``--attn`` kernels (``attn_sum``, ``attn_bwd``) at the headline's
   shapes with 1 and 4 heads, timing kernel, plain version, and the one
   PyTorch call that computes the same function where there is one
   (each time the median of 10 calls, cold L2), and ``attn_bwd`` with
   its persistent grid capped at 132 to 2048 blocks. Then each kernel's
   per-call floor (a one-row call, same timer) and the floor's parts
   (the timer alone, an empty kernel launched plainly and as a
   programmatic dependent launch), the kernels' other code paths at
   edge shapes (the attention kernels with 1 to 64 heads and k 1 to
   11), 20 back-to-back ``attn_bwd`` calls whose grids differ (each
   ``d_w`` the same bits as alone), the programmatic-launch hazard
   check (``softmax_sum_bwd`` and ``mailbox_scatter`` launched right
   after a PyTorch kernel, and right after a kernel that lets them
   start at once, that writes their NaN-filled inputs must match their
   plain versions; ``attn_sum`` right after either writes ``h`` and
   ``attn_bwd`` right after either writes ``d_f`` must equal bit for
   bit a run with a synchronize between; the merged scatter right
   after ``attn_bwd`` must equal its result with a synchronize
   between), and the row gather at the TPU probe's shapes (160,000 x
   128 bf16, 129,202 rows), with ROADMAP rule 2's verdict (at least
   half its bound and no slower than ``index_select``: left alone).
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
   by more than rounding: those convs are held to 1e-2 x max |g|. An
   element of Conv_2's or Conv_3's output whose sign differs (a value
   within rounding of 0; at most 16 a conv, the outputs within 1e-4 of
   their max) passes its gradient through the ReLU (leaky ReLU) on one
   and not the other: the CPU's first step takes the card's branch there
   (the card's value, the gradient straight through), and every leaf is
   held to 1e-3.

7. The CLIs, as a user runs them, through the port, each run with TF32
   turned on just before it (PyTorch's default for cuDNN), so that the
   float32 checked is the CLI's own setting (it must have turned both
   flags off). First the big stress design: ``synthetic --big`` (2048
   paths, 8 stages, 3 groups: about 102k cells and 260k pins, a
   2x512x512 raster), ``generate`` (the native rasterizer must load),
   ``train.main`` at the default full width and batch 1350 for one epoch
   (3 steps: 2,730 ids in batches of 1350; a validation after the first
   and the last, a save), ``train.main`` again (it must resume),
   ``test.main`` on the card and on the CPU from the same checkpoint
   (loss and predictions at rtol/atol 1e-4, equal ``predict_critical``;
   R2 is not compared there: every arrival time of the design is equal,
   so R2 divides by a rounding residue). Then two ``generate_corpus``
   corpora of 3 designs (``--num_paths 48 --depth 5``: depths vary
   across and within designs, a third of the paths critical), the second
   with 3 x 256 x 256 rasters: the train CLI (3 epochs of a step and a
   validation a design) and the test CLI on the card and the CPU from its
   checkpoint for the default regression, ``--task cls --nlabels 2``,
   ``--unet`` and ``--attn --num_heads 2``: predictions, loss and R2 at
   1e-4, the per-level
   R2/MAPE lines at 1e-3 and the confusion counts equal (labels may
   differ only at near ties, counted); ``cls`` must save the best-F1
   model and write no ``visual/`` or ``predict_critical/``. Then
   ``--compute_dtype bfloat16`` on the reg corpus (JAX's default flags:
   its train steps take the padded scan's rounding, forward and
   backward): the train CLI, the
   test CLI on the card and the CPU, and the same checkpoint's test CLI
   in float32 on the card; card against CPU by the bf16 bounds of phase
   8 (predictions within BF16_ULPS bf16 ulps and REL_GAP x their
   distance from float32, loss, R2 and per-level values at BF16_ULPS
   ulps relative). Launch
   counters are zeroed just before each CLI run on the card: each kernel
   must match the run's steps and validation forwards on the designs
   they ran on, ``gather_rows`` 0 times (a parsed design has no prior
   rows). Prints generate's seconds, each train run's wall seconds,
   steps, time a step as launched and validations, and the test CLI's
   ``runtime``, each with the card's name and power limit.
8. The variants at the default model's full width, TF32 off: ``cls``
   (2 logits, cross-entropy) on the headline design, the U-Net on the
   headline graph with a 3 x 256 x 256 raster (map 128), and ``--attn``
   on the headline design with one head (``reg_fusion_attn``) and with
   four (its first 2 paired steps). For each, 3 evaluation
   requests and phase 6's epoch (5 steps of 128, numpy seed 0), card
   against CPU with phase 4's and 6's launch counts and
   tolerances (``cls``: argmax labels equal but at near-tie logits,
   counted). Each of the card's steps starts from the CPU's state before
   it: Adam's update of a near-zero gradient element follows its sign,
   which rounding decides, so free-running steps drift apart (on the
   CPU, cls weights perturbed by 1e-7 give a fifth loss 3e-3 away). The
   U-Net's max-pool windows whose winner differs are counted as
   LayoutNet's are, its BatchNorm running averages held card against CPU
   after each step (rtol 1e-3), and an evaluation in eval
   mode on the CPU's trained weights and averages (1e-4). The U-Net's
   first-step gradients in float64 must agree card against CPU to 1e-8;
   in float32 they may differ by twice their own float32 error against
   float64 (the larger of card and CPU) more: its BatchNorms cancel most
   of their sums over 256 x 256 positions.
   Then the bf16 models (``--compute_dtype bfloat16``): ``bf16`` (the
   headline LayoutNet reg model: 3 requests, the epoch, a timed step),
   ``bf16_unet`` and ``bf16_attn`` (3 requests, 2 steps each), and
   ``bf16_scan`` (the reg model's first 3 steps in the padded scan's
   rounding, ``rounding="scan"``, and its step timed). Card
   against CPU, both bf16: predictions within BF16_ULPS bf16 ulps of
   their largest |value|, first-step gradients within BF16_GRAD_TOL x
   each leaf's max |g|, losses within BF16_LOSS_RTOL; and each mean
   distance at most REL_GAP x the distance of the same bf16 result from
   its weights in float32, measured in the run. The CPU's first step
   takes the card's value at each element of a layout-CNN layer that
   differs (:func:`card_layers`): a bf16 element an ulp apart moves
   pool winners and branches after it. Device time of
   a U-Net forward (eval mode) and forward + backward (train mode), and
   of a train step of each variant at the bench's batch of 597 paths, as
   launched too, with its idle share and largest kernels by name. Last,
   ROADMAP 3d's measurement: the reg step in float32 (TF32 off), in
   float32 with TF32 on and in bf16, in turns, twice, with LayoutNet's
   and the walk's parts and LayoutNet's forward + backward bound in each
   precision (:func:`precision_turns`). Two measurements ride along: each
   bf16 model's first-step gradients, card and CPU each against the
   float32 twin's, at the leaves farthest apart (ROADMAP F3); and the
   U-Net's float32 gradient error against float64 again at the CPU's
   weights after the epoch (G3).
9. The merged super-graph (``--merge_designs``, :func:`merged_phase`)
   at full width, TF32 off, on bench.py's merged point: 8 designs of
   20k nodes (seeds 100-107) merged into one super-graph of 8 x 2 x 512
   x 512 rasters, 256 ids a design (numpy seed 0). 3 grouped evaluation
   requests, card against CPU at 1e-4, and each design's rows against
   the design packed alone; 3 train steps card against CPU by phase 6's
   rules (the flip allowances per raster); one merged step timed against
   the 8 single-design steps on the same paths (device time, as launched,
   idle share, launches); one bf16 forward in the test CLI's rounding
   (phase 8's bf16 bounds); the merged U-Net (8 rasters of 3 x 256 x
   256, BatchNorm over all 8) for 2 steps from the CPU's state, running
   averages at STAT_RTOL. Phase 7 also trains the reg corpus with
   ``--merge_designs`` (train CLI, test CLI card vs CPU), and its bf16
   test CLI evaluates in the padded scan's rounding, as JAX's does.
10. Data parallelism (``--dp``, :func:`dp_phase`) at full width on the
   headline, all 597 paths a step, float32, TF32 off: (a) a process
   group of one rank over NCCL, 3 data-parallel steps against
   ``train_step`` (losses and first-step gradients within 1e-6), its
   step and the 2,727,202-float gradient broadcast timed; (b) two
   processes on ``cuda:0`` over gloo (NCCL refuses two ranks on one
   card), the ids padded to 598, 299 a rank, 3 steps against one rank's
   (1e-5), the ranks' parameter checksums equal after each step, each
   rank's launch counts its own, a step and the broadcast timed on the
   host, then one bf16 step of the same weights (the padded scan's
   rounding) against ``train_step``'s within F4_MEAN x each leaf's
   bf16-to-float32 distance and F4_MAX x its max |g| (F4: the ranks'
   cotangents gathered before any bf16 rounding); not run, and said so,
   where the card's compute mode (phase 1) is exclusive; (c) the train and test CLIs with ``--dp`` on the reg
   corpus against the same runs without it (each printed number within
   a unit of its last digit plus rtol 1e-5). One card shows no speed-up
   over cards, and none is claimed.
11. The segment reduce (``gnn_reduce="segment"``, :func:`segment_phase`)
   and the 2-D ``(dp, gp)`` edge-sharded step, at full width on the
   headline, float32, TF32 off: (a) its three kernels
   (``segment_softmax_sum``, ``segment_mean``, ``segment_softmax_sum_bwd``)
   and its backward's ``mailbox_scatter`` calls against their plain
   versions at every level's shapes, timed (median of 10 cold-L2 calls)
   beside their bytes bound, one-slot floor, plain version and library
   call (``embedding_bag``, ``index_add_``); the softmax forward whole
   and ``partial``, its backward recomputing and stats-reading (the two
   bit for bit against each other), ``segment_mean``'s sums, mean and
   update modes (the update, the walk's net half, also bit for bit
   against the mean kernel and the five PyTorch ops it replaces, whose
   time is printed beside it), each mode's bound; the walk's kernel
   calls back to back; the kernels on the shapes the headline does not
   reach (edge shapes) and launched right after a writer of what they
   read after their wait (programmatic launch hazards); (b) the segment
   reg model: 3 requests card against CPU and against the card's
   mailbox model on the same weights, both models' forward launches, 3
   steps card against CPU by phase 6's bounds, the first step against
   the mailbox model's, its step timed beside the mailbox step; (c)
   ``graph_sharded_train_step``: a (1, 1) mesh over NCCL against
   ``train_step`` (1e-6), and two processes sharing ``cuda:0`` over gloo
   at (1, 2) against it (1e-5; checksums equal, a destination slot split
   across the blocks), the step and its gp all-reduces timed.
12. ``--attn`` under the segment reduce (``gnn_reduce="segment"``,
   ``flag_attn``, :func:`segment_attn_phase`) at full width on the
   headline, float32, TF32 off, with 1 head (``reg_fusion_attn``) and 4:
   (a) its two kernels (``segment_attn_sum``, ``segment_attn_bwd``)
   against their plain versions at every level's shapes, timed (median
   of 10 cold-L2 calls) beside their bytes bound, one-slot floor and
   plain version (no single PyTorch call computes either: no library
   time); the forward whole and ``partial`` (its numerator over its
   denominator bit for bit against the whole output), the backward
   recomputing and stats-reading (bit for bit against each other,
   ``d_w`` too, and ``d_w`` the same in two calls); the kernels on edge
   shapes (empty slots, 1 to 33 edges, 1 to 64 heads, nh = 3 at D = 12,
   D / nh < 4, D % 4 != 0, a misaligned h, a NaN) and launched right
   after a writer of what they read after their wait, each bit for bit
   against a run with a synchronize between; (b) and (c) as phase 11's,
   for the segment ``--attn`` model beside the mailbox ``--attn`` model
   on the same weights.
13. bf16 under the segment reduce (``gnn_reduce="segment"``,
   ``compute_dtype`` bfloat16, :func:`segment_bf16_phase`) at full width
   on the headline, TF32 off: the walk rounds as JAX's padded scan does
   (the only rounding JAX has for the segment reduce), at every entry
   point's default; its kernels are the float32 segment walk's, on the
   same float32 inputs. (b) The reg model: 3 requests card against CPU
   and against the card's bf16 mailbox model in the padded scan's
   rounding on the same weights, by phase 8's bf16 bounds (BF16_ULPS,
   REL_GAP x the distance from the float32 twin measured in the run),
   the forward's launches against the segment walk's tables, 3 paired
   steps card against CPU (BF16_GRAD_TOL, BF16_LOSS_RTOL, REL_GAP) with
   the step's launches, the first step against the mailbox model's,
   one step timed beside the mailbox ``bf16_scan`` step in turns
   (pre-filled, busy, as launched, idle share, launches); (c) the (1, 1)
   NCCL step bit-equal to ``train_step``, and two gloo processes at (1,
   2) within DP_TOL_2 with the ranks' checksums equal. Then ``--attn``
   with 4 heads: 3 requests, 2 paired steps and the (1, 1) bit check.
   (The 1-head float32 ``--attn`` cell stays in phase 12.)
14. The multi-design step (``parallel/multi.py``, ``graph.
   stack_designs``, :func:`multi_phase`) at full width on phase 9's
   designs and weights, TF32 off: (a) 3 requests card against CPU
   (1e-4) and against phase 9's merged ``evaluate`` of the stack's
   super-graph (MULTI_TOL); (b) 3 steps card against CPU by phase 6's
   rules, the step timed beside phase 9's merged and single steps; (c)
   in bf16, 3 requests and 2 paired steps by phase 8's bf16 bounds; (d)
   design-sharded: one NCCL rank against the unsharded step (DP_TOL),
   two gloo processes on ``cuda:0`` with 4 designs each (DP_TOL_2, the
   ranks' checksums equal).
15. The graft-style entry and the results pack (:func:`entry_phase`):
   (a) ``__graft_entry_torch__.entry()``'s forward (the small flagship
   at full width, 32 paths) and the full flagship's
   (``_flagship(small=False)``: 38,912 nodes in 8 levels, 1,350 paths,
   a 2 x 512 x 512 raster), each on the card with the launch counters
   zeroed just before and read just after (each kernel as the walk's
   tables say) and on the CPU (plain versions) at rtol/atol
   FLAGSHIP_TOL, each forward timed (device time, and as launched); (b)
   ``dryrun_multichip(DRYRUN_RANKS)``: on one card a ``(4, 2)`` mesh of
   gloo ranks sharing it, its segment step held against ``train_step``
   on every rank (its match line printed), timed with the processes'
   start; not run, and said so, where the card's compute mode is
   exclusive; (c) :func:`pack_parity`: the train CLI of each of the
   seven configs of ``scripts/results_pack_torch.py`` for PACK_EPOCHS
   epoch on the CPU, as the pack runs it (a child process), against the
   first epoch of phase 16 (a)'s first card run of the config, from the
   same corpus (built once a config's kind; naming phase 15 alone runs
   that card run alone): the weights each run starts from (the
   checkpoint the CLI writes at creation) bit-equal, every step's loss
   and r2 within LOSS_RTOL (r2 as ``1 - r2``), a ``cls`` run's F1s
   equal, and the card's first loss the JAX pack's committed one
   (``results/<config>/summary.json``, read as data: the CLI draws the
   JAX package's weights for ``--seed``), within
   ``results_pack_torch.start_gap``'s rtol; each config's first and last
   loss on both devices printed; the CPU runs timed.
16. The train CLI's runs repeat bit for bit (:func:`repeat_phase`): (a)
   the train CLI of each of the seven pack configs twice on the card,
   REPEAT_EPOCHS epochs, as the pack runs it (a child process; these
   runs and phase 15 (c)'s CPU runs are one pool of PACK_WORKERS,
   :func:`pack_runs`): every step's loss and metrics at full
   precision, the printed batch and validation lines, the final weights
   and flat Adam's moments by their bytes must be equal; a difference
   names the config, the first step and line that differ and the first
   leaf whose bytes differ with its largest gap relative to its max |x|.
   With ``--bisect`` each config's first batch first runs BISECT_REPS
   times in this process, in the CLIs' deterministic scope and without
   it, and the outputs, cotangents and gradients that differ between
   passes are logged. (b) What the scope costs at full width
   (:func:`deterministic_cost`): the headline reg and U-Net train steps
   and LayoutNet's forward + backward, in turns with and without it.

Then one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``. Without a card, or without the package beside it,
the script exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import statistics
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
# card vs cpu, phases 6, 8 and 9: a conv above a max-pool window whose
# winner differs (at most MAX_FLIPS a pool and raster)
FLIP_TOL, MAX_FLIPS = 1e-2, 16
# each max pool of a layout CNN, and the parameter prefixes above it
LAYOUTNET_POOLS = {"Conv_0": ("cnn.Conv_0.",),
                   "Conv_1": ("cnn.Conv_0.", "cnn.Conv_1.")}
# LayoutNet's convs followed by an activation that branches on the sign
# (ReLU, leaky ReLU), and how far the card's outputs may lie from the
# cpu's (x their largest |value|)
SIGN_CONVS, PRE_RTOL = ("Conv_2", "Conv_3"), 1e-4
UNET_POOLS = {"Down_0": ("cnn.DoubleConv_0.",),
              "Down_1": ("cnn.DoubleConv_0.", "cnn.Down_0."),
              "Down_2": ("cnn.DoubleConv_0.", "cnn.Down_0.", "cnn.Down_1."),
              "OutConv_0": ("cnn.",)}
# H100 SXM peak rates (dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S, TF32_OPS_PER_S = 989e12, 495e12  # tensor cores
# bf16 models (--compute_dtype bfloat16), card against cpu, both bf16:
# predictions within BF16_ULPS bf16 ulps of their largest |value|, each
# first-step gradient within BF16_GRAD_TOL x its leaf's max |g|, losses
# within BF16_LOSS_RTOL; and each mean distance at most REL_GAP x the
# mean distance of the same bf16 result from float32 on the same weights,
# measured in the run (the bf16 rounding itself): a rounding at another
# place than on the cpu would move results about that far. The gradient
# bound is 12 bf16 ulps at a leaf's max: a U-Net transposed conv's bias
# sums bf16 cotangents over 8,192 positions after the BatchNorms'
# backward (measured on an H100: 3.0e-2 for the U-Net, 5.3e-3 for
# LayoutNet)
BF16_ULPS, BF16_GRAD_TOL, BF16_LOSS_RTOL, REL_GAP = 4, 5e-2, 2e-3, 0.1
REPS, WARMUP = 10, 2
# phase 7: the big stress design of prtp_tpu_torch.data.synthetic --big
CLI_DESIGN, CLI_PATHS, CLI_STAGES = "big", 2048, 8
# phase 7: the generate_corpus corpora (design i: CORPUS_PATHS + 2i paths,
# CORPUS_DEPTH + i stages)
CORPUS_DESIGNS, CORPUS_PATHS, CORPUS_DEPTH = ("syn_a", "syn_b", "syn_c"), 48, 5
CORPUS_EPOCHS = 3  # a step and a validation a design an epoch
# phases 7 and 8: the U-Net's raster (its map is the side halved: 128)
UNET_CHANNELS, UNET_HW = 3, 256
STAT_RTOL = 1e-3  # phase 8: U-Net running averages, card vs cpu
# phase 8: the paired steps of the 4-head, bf16 U-Net and bf16 --attn
# models (the others run the whole epoch)
SHORT_STEPS = 2
SCAN_STEPS = 3  # phase 8: the bf16 steps in the padded scan's rounding
# phase 9: bench.py's merged point (build_merged_step): MERGED_K designs
# of MERGED_NODES nodes (LEVELS levels, DECAY), seeds MERGED_SEED + k, and
# MERGED_BATCH ids a design drawn with numpy seed 0; MERGED_STEPS train
# steps card vs cpu
MERGED_K, MERGED_NODES, MERGED_SEED, MERGED_BATCH = 8, 20_000, 100, 256
MERGED_STEPS = 3
# phase 14: the multi-design step on phase 9's designs, MULTI_STEPS train
# steps card vs cpu; its predictions against phase 9's merged evaluate of
# the same super-graph within MULTI_TOL x their largest |value| (the same
# kernels on the same tables)
MULTI_STEPS, MULTI_TOL = 3, 1e-6
# phase 10: data parallelism, DP_STEPS steps a run; (a) one rank against
# train_step within DP_TOL, (b) DP_RANKS ranks on one card within DP_TOL_2
DP_STEPS, DP_RANKS = 3, 2
DP_TOL, DP_TOL_2 = 1e-6, 1e-5
DP_CLI_RTOL = 1e-5  # (c): the --dp CLIs' printed values against without
# (b), F4: a bf16 dp step's gradients against one rank's, each leaf within
# F4_MEAN x its bf16-to-float32 distance in mean distance and F4_MAX x its
# max |g| (tests/test_torch_graph_shard.py's bound)
F4_MEAN, F4_MAX = 1e-3, 1e-4
FLAGSHIP_TOL = 1e-4  # phase 15 (a): the flagship forwards, card vs cpu
DRYRUN_RANKS = 8  # phase 15 (b): a (4, 2) mesh
# phase 15 (c): each pack config's train CLI for PACK_EPOCHS on the cpu;
# phases 15 (c) and 16 (a): PACK_WORKERS child processes at once
PACK_EPOCHS, PACK_WORKERS = 1, 4
# phase 16: each pack config's train CLI twice on the card, REPEAT_EPOCHS
# epochs (15 (c) reads run 0's first epoch); --bisect: BISECT_REPS
# forward and backward passes of a batch
REPEAT_EPOCHS, BISECT_REPS = 3, 5
# phase 11: the segment reduce's train steps a run, and the ranks of its
# (1, GP_RANKS) edge-sharded mesh on one card
SEG_STEPS, GP_RANKS = 3, 2
# phase 11 (a): the elementwise kernel before each segment softmax call
# when the walk's calls are timed back to back
CHAIN_ELEMS = 10_000 * 128
HAZARD_REPS = 20  # phase 3: launches right after a writer of the inputs
SPIN_CYCLES_PER_MS = 2_000_000  # about the H100's SM clock
# phase 3's fixtures, not kernels of the port: for the hazard check a
# writer that lets a programmatic dependent launch after it start at
# once (griddepcontrol.launch_dependents), then spins and only then
# copies src into dst; for the floor an empty kernel of one warp,
# launched plainly or as a programmatic dependent launch.
EARLY_WRITER_SPIN_MS = 0.1
FIXTURES_CU = r"""
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

__global__ void empty_kernel() {}

extern "C" int empty_launch(int programmatic, void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = programmatic ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
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
    "attn_sum": ("prtp_tpu_torch/csrc/attn_sum.cu",
                 "prtp_tpu/ops/fused_gnn.py:90", "headline"),
    "attn_bwd": ("prtp_tpu_torch/csrc/attn_bwd.cu",
                 "prtp_tpu/ops/fused_gnn.py:111", "headline"),
    "segment_softmax_sum": ("prtp_tpu_torch/csrc/segment_softmax_sum.cu",
                            "prtp_tpu/ops/segment.py:51", "headline"),
    "segment_mean": ("prtp_tpu_torch/csrc/segment_mean.cu",
                     "prtp_tpu/ops/segment.py:29", "headline"),
    "segment_softmax_sum_bwd": (
        "prtp_tpu_torch/csrc/segment_softmax_sum_bwd.cu",
        "prtp_tpu/models/gnn.py:185", "headline"),
    "segment_attn_sum": ("prtp_tpu_torch/csrc/segment_attn_sum.cu",
                         "prtp_tpu/ops/segment.py:86", "headline"),
    "segment_attn_bwd": ("prtp_tpu_torch/csrc/segment_attn_bwd.cu",
                         "prtp_tpu/models/gnn.py:180", "headline"),
}
# the segment walk's own kernels (phase 11); its backward's scatter is
# the mailbox walk's mailbox_scatter
SEGMENT_KERNELS = ("segment_softmax_sum", "segment_mean",
                   "segment_softmax_sum_bwd")
# the segment walk's --attn cell reduce (phase 12), in place of the first
# and the last of SEGMENT_KERNELS
SEGMENT_ATTN_KERNELS = ("segment_attn_sum", "segment_attn_bwd")
# the kernels' names as torch.profiler shows them, where not <name>_kernel
KERNEL_SYMBOLS = {"segment_attn_sum": ("segment_attn_heads_kernel",
                                       "segment_attn_loop_kernel"),
                  "segment_attn_bwd": ("segment_attn_bwd_heads_kernel",
                                       "segment_attn_bwd_loop_kernel",
                                       "segment_dw_reduce_kernel"),
                  "attn_bwd": ("attn_bwd_rows_kernel",
                               "attn_dw_reduce_kernel")}
# the cell reduce's kernels, without and with --attn
CELL_REDUCE = {False: ("softmax_sum", "softmax_sum_bwd"),
               True: ("attn_sum", "attn_bwd")}
ATTN_HEADS = (1, 4)  # phase 3: the recorded config's head count, and 4


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call with a cold L2, the median of REPS calls:
    before each call a 128 MB buffer is overwritten (the card's L2 holds
    50 MB), then a spin kernel holds the stream for about ``queue_ms``
    while the host enqueues the call, so the CUDA events around it
    bracket device work only, not the host's launch overhead.
    ``queue_ms=0`` times the call as launched, host gaps included."""

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
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def launches_per_forward(graph, attn=False) -> dict:
    """Each kernel's launches in one walk of ``graph``: the prior-row
    gather only for pairs with prior rows, the cell reduce
    (``softmax_sum``, or ``attn_sum`` with ``--attn``; the other 0 times)
    for pairs k > 0, the net mean for every pair."""
    reduce, other = CELL_REDUCE[attn][0], CELL_REDUCE[not attn][0]
    return {
        "gather_rows": sum(
            1 for k in range(graph.num_pairs)
            if graph.gather_rows[k].numel() > graph.cell_mail[k].numel()),
        reduce: graph.num_pairs - 1,
        other: 0,
        "local_mean": graph.num_pairs,
    }


def launches_per_step(graph, attn=False) -> dict:
    """Each kernel's launches in one train step on ``graph``: the
    forward's, the backward's (the cell reduce again, to recompute f and,
    with ``--attn``, alpha; the cell cotangent for pairs k > 0; a scatter
    for each non-empty intra and merged table) and one flat Adam
    update. The other variant's cell kernels run 0 times."""
    fwd = launches_per_forward(graph, attn)
    p = graph.num_pairs
    (reduce, bwd), (other, other_bwd) = CELL_REDUCE[attn], CELL_REDUCE[not attn]
    return {
        "gather_rows": fwd["gather_rows"],
        reduce: 2 * (p - 1),
        other: 0,
        "local_mean": p,
        bwd: p - 1,
        other_bwd: 0,
        "mailbox_scatter": sum(
            (graph.intra_rows[k].numel() > 0)
            + (graph.merged_rows[k].numel() > 0) for k in range(p)),
        "flat_adam": 1,
    }


def may_idle(name, attn=False) -> bool:
    """Whether a run of the mailbox walk may launch kernel ``name`` 0
    times: the prior-row gather (designs without prior rows), the other
    variant's cell kernels, and the segment walk's kernels (phases 11 and
    12)."""
    return (name == "gather_rows" or name in CELL_REDUCE[not attn]
            or name in SEGMENT_KERNELS or name in SEGMENT_ATTN_KERNELS)


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


def attn_close(torch, got, want):
    """The attention kernels against their plain versions: each tensor
    within rtol 1e-5 and atol 1e-5 x its largest |value| (NaN where the
    plain version has it). The scores are float32 dot products over a
    whole row, summed in another order than the plain version's product;
    d_w sums every valid slot of a pair. Returns (ok, max abs error)."""
    def finite_max(t):
        t = t[torch.isfinite(t)].abs()
        return float(t.max()) if t.numel() else 0.0

    if got.shape != want.shape:
        return False, float("inf")
    scale, err = finite_max(want), finite_max(got - want)
    ok = (got.shape == want.shape
          and torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                             equal_nan=True))
    return ok, err


def attn_weights(torch, nh, gen, dev, d=D):
    """A score projection (nh, d) with fc_attn2's init scale (lecun
    normal: std 1/sqrt(d))."""
    return torch.randn((nh, d), generator=gen, device=dev) / d ** 0.5


def check_attn_kernels(torch, graph, dev, timer, design, nh):
    """Phase 3, ``--attn``: attn_sum (with and without alpha) and attn_bwd
    against their plain versions at every shape the walk and its backward
    give them on ``graph`` (the cell mailbox of each pair k > 0, row 0
    all-invalid), with ``nh`` heads, a random state, projection and
    cotangent; attn_bwd twice, d_w bit for bit the same. Times attn_sum
    as the forward calls it (no alpha) and attn_bwd. Bytes count the
    distinct valid rows read, the indices, alpha, d_f and w, and the
    outputs (attn_bwd: the valid slots' rows and d_w); operations the
    products. Returns ``{name: KernelRecord}``."""
    from prtp_tpu_torch.ops.fused_gnn import (attn_bwd, attn_bwd_plain,
                                              attn_sum, attn_sum_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED + 4 + nh)
    num_rows = graph.num_rows
    row_b = D * 4
    h = torch.randn((num_rows + 1, D), generator=gen, device=dev)
    w = attn_weights(torch, nh, gen, dev)
    recs = {name: KernelRecord(name, design)
            for name in ("attn_sum", "attn_bwd")}
    for k in range(1, graph.num_pairs):
        idx = graph.cell_mail[k].clone()
        idx[0] = num_rows
        pn_c, md_c = idx.shape
        out, alpha = attn_sum(h, idx, num_rows, w, with_alpha=True)
        want, want_alpha = attn_sum_plain(h, idx, num_rows, w, True)
        ok_o, err_o = attn_close(torch, out, want)
        ok_a, err_a = attn_close(torch, alpha, want_alpha)
        if not (ok_o and ok_a and bool(torch.isfinite(out).all())
                and not bool(out[0].any()) and torch.equal(
                    attn_sum(h, idx, num_rows, w), out)):
            raise AssertionError(f"attn_sum (nh {nh}) differs at pair {k}: "
                                 f"max abs err {err_o} (alpha {err_a})")
        used = idx[idx != num_rows]
        n_used = used.numel()
        nbytes = (torch.unique(used).numel() * row_b + idx.numel() * 4
                  + w.numel() * 4 + pn_c * row_b)
        ops = 2.0 * n_used * D * (nh + 1)
        ms = timer.ms(lambda: attn_sum(h, idx, num_rows, w))
        pms = timer.ms(lambda: attn_sum_plain(h, idx, num_rows, w))
        recs["attn_sum"].add(ms, pms, None, nbytes, ops, max(err_o, err_a))
        log(f"  attn_sum nh {nh} pair {k}: ({pn_c}, {md_c}) of {D} f32, "
            f"{n_used} valid slots  kernel {ms:.4f} ms  plain {pms:.4f}  "
            f"bound {bound(nbytes, ops)[0]:.4f}  max abs err {err_o:.3g} "
            f"(alpha {err_a:.3g})")
        d_f = torch.randn((pn_c, D), generator=gen, device=dev)
        valid = (idx != num_rows).reshape(-1)
        d_m, d_w = attn_bwd(h, idx, num_rows, w, want_alpha, d_f)
        want_m, want_w = attn_bwd_plain(h, idx, num_rows, w, want_alpha, d_f)
        ok_m, err_m = attn_close(torch, d_m[valid], want_m[valid])
        ok_w, err_w = attn_close(torch, d_w, want_w)
        again = attn_bwd(h, idx, num_rows, w, want_alpha, d_f)[1]
        if not (ok_m and ok_w and bool(torch.isfinite(d_m[valid]).all())
                and torch.equal(again, d_w)):
            raise AssertionError(f"attn_bwd (nh {nh}) differs at pair {k}: "
                                 f"d_mail max abs err {err_m}, d_w {err_w}, "
                                 f"d_w again equal {torch.equal(again, d_w)}")
        nbytes = (torch.unique(used).numel() * row_b + idx.numel() * 4
                  + want_alpha.numel() * 4 + 2 * w.numel() * 4
                  + pn_c * row_b + n_used * row_b)
        ops = 4.0 * n_used * D * (nh + 1)
        ms = timer.ms(lambda: attn_bwd(h, idx, num_rows, w, want_alpha, d_f))
        pms = timer.ms(lambda: attn_bwd_plain(h, idx, num_rows, w,
                                              want_alpha, d_f))
        recs["attn_bwd"].add(ms, pms, None, nbytes, ops, max(err_m, err_w))
        log(f"  attn_bwd nh {nh} pair {k}: {n_used} valid slots  kernel "
            f"{ms:.4f} ms  plain {pms:.4f}  bound "
            f"{bound(nbytes, ops)[0]:.4f}  max abs err {err_m:.3g} (d_w "
            f"{err_w:.3g} of max {float(want_w.abs().max()):.3g}), d_w "
            "deterministic")
    return recs


def attn_bwd_grids(torch, graph, dev, timer, nh, smi,
                   caps=(132, 264, 528, 1056, 2048)):
    """Phase 3: logs attn_bwd's time per backward on ``graph`` (the cell
    mailbox of each pair k > 0) with its persistent grid capped at each of
    ``caps`` blocks (the wrapper's ``_ATTN_BWD_BLOCKS``), the caps taken
    in turns, each pair's time the timer's median."""
    from prtp_tpu_torch.ops import fused_gnn

    gen = torch.Generator(device=dev).manual_seed(SEED + 6 + nh)
    num_rows = graph.num_rows
    h = torch.randn((num_rows + 1, D), generator=gen, device=dev)
    w = attn_weights(torch, nh, gen, dev)
    ms = dict.fromkeys(caps, 0.0)
    default = fused_gnn._ATTN_BWD_BLOCKS
    try:
        for k in range(1, graph.num_pairs):
            idx = graph.cell_mail[k]
            alpha = fused_gnn.attn_sum_plain(h, idx, num_rows, w, True)[1]
            d_f = torch.randn((idx.shape[0], D), generator=gen, device=dev)
            for cap in caps:
                fused_gnn._ATTN_BWD_BLOCKS = cap
                ms[cap] += timer.ms(lambda: fused_gnn.attn_bwd(
                    h, idx, num_rows, w, alpha, d_f))
    finally:
        fused_gnn._ATTN_BWD_BLOCKS = default
    log(f"  attn_bwd nh {nh}, ms a backward by the grid's cap in blocks "
        f"(the wrapper's {default}): "
        + ", ".join(f"{c} {t:.4f}" for c, t in ms.items()) + f"  [{smi}]")


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
    from prtp_tpu_torch.ops.fused_gnn import (attn_bwd, attn_sum, local_mean,
                                              mailbox_scatter, softmax_sum,
                                              softmax_sum_bwd)
    from prtp_tpu_torch.ops.gather import gather_rows

    h = torch.randn((graph.num_rows + 1, D), device=dev)
    one_row = graph.cell_mail[1][:1]
    w = torch.randn((1, D), device=dev)
    alpha = torch.rand((1, one_row.shape[1], 1), device=dev)
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
        "attn_sum": timer.ms(
            lambda: attn_sum(h, one_row, graph.num_rows, w)),
        "attn_bwd": timer.ms(
            lambda: attn_bwd(h, one_row, graph.num_rows, w, alpha, new)),
    }


def fixture_floors(torch, dev, timer, empty_launch) -> dict:
    """What the per-call floor is made of, with the same timer: the two
    events with nothing between them, and the empty kernel (FIXTURES_CU)
    launched plainly and as a programmatic dependent launch. A kernel's
    one-row call less the empty launch is its chain of dependent loads
    and its own work."""
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty(programmatic):
        err = empty_launch(programmatic, stream)
        if err != 0:
            raise RuntimeError(f"empty_launch failed: cuda error {err}")

    return {"nothing between the events": timer.ms(lambda: None),
            "empty kernel": timer.ms(lambda: empty(0)),
            "empty kernel, programmatic launch": timer.ms(lambda: empty(1))}


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


def check_attn_edge_shapes(torch, dev):
    """The attention kernels' other code paths against their plain
    versions (attn_close), alpha and d_w included: the heads-together
    register path at D = 128 with nh 1, 2, 4, 8, 16 and 32 (32 down to 1
    lanes a head) and k 1, 2, 4, 7 and 8; k > 8 (the generic path: k 9
    and 11); nh 64 at D = 128 (Dh 2: a float4 spanning heads, the
    per-head loop), nh 3 at D = 12 and D = 96 (not a power of two), D %
    4 != 0 (the scalar path: D 6 with nh 3, D 7), D = 300 (several
    float4s a lane: the generic path), a
    misaligned h, an empty mailbox, all-invalid rows (row 0 of each), a
    NaN in a valid slot (forward: NaN where the plain version has it),
    and large scores: h in multiples of 1/8 up to 16, integer w up to 3,
    so the scores, up to hundreds, are exact in float32 whatever the
    order of their sum and exp of an unshifted score overflows."""
    from prtp_tpu_torch.ops.fused_gnn import (attn_bwd, attn_bwd_plain,
                                              attn_sum, attn_sum_plain)

    gen = torch.Generator(device=dev).manual_seed(5)
    cases = 0
    # (P, K, D, nh, rows of h, case)
    for p, k, d, nh, r, case in (
            (0, 4, 128, 1, 50, "empty"),
            (300, 11, 128, 1, 900, "k>8"),
            (300, 11, 128, 4, 900, "k>8, nh 4"),
            (300, 4, 128, 1, 900, "nh 1"),
            (300, 4, 128, 2, 900, "nh 2"),
            (300, 4, 128, 8, 900, "nh 8"),
            (300, 4, 128, 16, 900, "nh 16"),
            (300, 4, 128, 32, 900, "nh 32: a lane a head"),
            (300, 8, 128, 32, 900, "nh 32, k=8"),
            (300, 4, 128, 64, 900, "nh 64: Dh 2, a float4 spans heads"),
            (300, 1, 128, 4, 900, "k=1"),
            (300, 2, 128, 4, 900, "k=2"),
            (300, 4, 128, 4, 900, "k=4"),
            (300, 7, 128, 4, 900, "k=7"),
            (300, 8, 128, 4, 900, "k=8"),
            (300, 9, 128, 4, 900, "k=9: the generic path"),
            (300, 8, 128, 1, 900, "k=8, nh 1"),
            (6000, 4, 128, 2, 900, "blocks of several tiles"),
            (5000, 11, 128, 4, 900, "k>8, blocks of several tiles"),
            (300, 4, 12, 3, 900, "D=12, nh 3"),
            (300, 4, 96, 3, 900, "D=96, nh 3"),
            (300, 4, 6, 3, 900, "D=6, nh 3: D%4!=0"),
            (50, 20, 7, 1, 200, "k>8, D=7"),
            (300, 3, 300, 5, 900, "D=300, nh 5"),
            (300, 4, 128, 4, 900, "misaligned h"),
            (300, 4, 128, 1, 900, "large scores"),
            (300, 4, 128, 4, 900, "large scores, nh 4"),
            (300, 4, 128, 2, 900, "NaN")):
        if case.startswith("large"):
            h = torch.randint(-128, 129, (r, d), generator=gen,
                              device=dev).float() / 8
            w = torch.randint(-3, 4, (nh, d), generator=gen,
                              device=dev).float()
        else:
            h = torch.randn(r * d + 1, generator=gen, device=dev)
            h = (h[1:] if case == "misaligned h" else h[:-1]).view(r, d)
            w = attn_weights(torch, nh, gen, dev, d)
        idx = torch.randint(0, r - 1, (p, k), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[torch.rand((p, k), generator=gen, device=dev) < 0.35] = r - 1
        if p:
            idx[0] = r - 1
        if case == "NaN":
            idx[1, 0] = 5
            h[5, 2] = float("nan")
        out, alpha = attn_sum(h, idx, r - 1, w, with_alpha=True)
        want, want_alpha = attn_sum_plain(h, idx, r - 1, w, True)
        ok = all(attn_close(torch, a, b)[0]
                 for a, b in ((out, want), (alpha, want_alpha)))
        if case == "NaN":
            ok = ok and bool(out[1].isnan().any())
        else:
            ok = ok and bool(torch.isfinite(out).all())
        if p:
            ok = ok and not bool(out[0].any()) and not bool(alpha[0].any())
        if case.startswith("large"):
            scores = h[idx[idx != r - 1].long()] @ w.T
            ok = ok and float(scores.abs().max()) > 88  # exp(88.8) overflows
        if not ok:
            raise AssertionError(f"attn_sum differs at {(p, k, d, nh)} {case}")
        if case != "NaN":
            d_f = torch.randn((p, d), generator=gen, device=dev)
            d_m, d_w = attn_bwd(h, idx, r - 1, w, want_alpha, d_f)
            want_m, want_w = attn_bwd_plain(h, idx, r - 1, w, want_alpha, d_f)
            valid = (idx != r - 1).reshape(-1)
            ok_m, err_m = attn_close(torch, d_m[valid], want_m[valid])
            ok_w, err_w = attn_close(torch, d_w, want_w)
            if not (ok_m and ok_w and bool(torch.isfinite(d_w).all())):
                raise AssertionError(f"attn_bwd differs at {(p, k, d, nh)} "
                                     f"{case}: d_mail {err_m}, d_w {err_w}")
        cases += 1
    log(f"  attention edge shapes: {cases} cases of attn_sum and attn_bwd "
        "match their plain versions (rtol 1e-5, atol 1e-5 x max; NaN where "
        "the plain version has it)")


def check_attn_back_to_back(torch, dev, calls=20):
    """attn_bwd's fixed-order d_w: ``calls`` calls back to back on the
    stream, no synchronize between (each kernel a programmatic dependent
    launch right after the one before), cycling through mailboxes whose
    grids differ (1, 10, 50, 75, 750 and 1,056 blocks, the cap), with 1
    and 4 heads. Each call's d_w must have the same bits as the same
    inputs' call run alone before, which must match the plain version
    (attn_close)."""
    from prtp_tpu_torch.ops.fused_gnn import attn_bwd, attn_bwd_plain

    gen = torch.Generator(device=dev).manual_seed(6)
    r = 5000
    h = torch.randn((r, D), generator=gen, device=dev)
    cases = []
    for p, nh in ((4, 1), (40, 4), (200, 1), (300, 4), (20000, 4),
                  (3000, 1)):
        idx = torch.randint(0, r - 1, (p, 4), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[torch.rand((p, 4), generator=gen, device=dev) < 0.35] = r - 1
        w = attn_weights(torch, nh, gen, dev)
        alpha = torch.softmax(torch.randn((p, 4, nh), generator=gen,
                                          device=dev), dim=1)
        alpha[idx == r - 1] = 0.0
        d_f = torch.randn((p, D), generator=gen, device=dev)
        args = (h, idx, r - 1, w, alpha, d_f)
        alone = attn_bwd(*args)[1]
        torch.cuda.synchronize()
        ok, err = attn_close(torch, alone, attn_bwd_plain(*args)[1])
        if not ok:
            raise AssertionError(f"attn_bwd d_w differs from the plain "
                                 f"version at P {p}, nh {nh}: {err}")
        cases.append((args, alone))
    got = [attn_bwd(*cases[i % len(cases)][0])[1] for i in range(calls)]
    torch.cuda.synchronize()
    off = [int((g != cases[i % len(cases)][1]).sum())
           for i, g in enumerate(got)]
    log(f"  attn_bwd back to back: {calls} calls over "
        f"{len(cases)} grids, d_w elements off the lone call's bits in "
        f"each: {off}")
    if any(off):
        raise AssertionError(f"attn_bwd's d_w changed back to back: {off}")


def start_fixture_build():
    """Phase 2: start ``nvcc`` on FIXTURES_CU, beside the port's builds,
    into the port's (git-ignored) build directory. Returns what
    :func:`load_fixtures` takes."""
    from prtp_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "fixtures.cu"
    src.write_text(FIXTURES_CU)
    target = _build.BUILD_DIR / "libfixtures.so"
    proc = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(target), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, target


def load_fixtures(build):
    """``(early_writer_launch, empty_launch)`` of the library
    :func:`start_fixture_build` compiles; raises with the compiler's
    output if the build failed."""
    import ctypes

    proc, target = build
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"fixtures build failed:\n{out}")
    lib = ctypes.CDLL(str(target))
    writer, empty = lib.early_writer_launch, lib.empty_launch
    writer.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]
    empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    writer.restype = empty.restype = ctypes.c_int
    return writer, empty


def hazard_writers(torch, dev, early_writer) -> dict:
    """The two writers of the hazard checks, each ``write(buf, src)``
    (copy src into buf on the stream): ``torch.mul`` by 1 and
    ``early_writer``."""
    def write_early(buf, src):
        err = early_writer(buf.data_ptr(), src.data_ptr(), buf.numel(),
                           int(EARLY_WRITER_SPIN_MS * SPIN_CYCLES_PER_MS),
                           torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"early_writer launch failed: cuda error {err}")

    return {"torch.mul": lambda buf, src: torch.mul(src, 1.0, out=buf),
            "early_writer": write_early}


def staged(torch, vals):
    """NaN-filled views of one buffer, shaped as ``vals``, the flat
    values, and the buffer: one writer launch fills them all."""
    src = torch.cat([v.reshape(-1) for v in vals])
    buf = torch.full_like(src, float("nan"))
    views, at = [], 0
    for v in vals:
        views.append(buf[at: at + v.numel()].view(v.shape))
        at += v.numel()
    return views, src, buf


def after_writers(torch, writers, what, call, buf, src, want) -> list:
    """For each writer of :func:`hazard_writers`, HAZARD_REPS launches of
    ``call``, each right after the writer fills ``buf`` (NaN first) from
    ``src``, a spin kernel holding the stream while the host enqueues
    both; logs the elements that differ from ``want`` (rtol 1e-5, atol
    1e-6) in each launch. Returns the failed ``what after writer``s."""
    failed = []
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
    return failed


def check_programmatic_hazard(torch, graph, dev, early_writer, pair=1):
    """Phase 3, programmatic dependent launch: softmax_sum_bwd and both
    mailbox_scatter calls at one pair's shapes of ``graph``, each launched
    right after a kernel that writes every input the kernel may read only
    after its wait (f and d_f; dest, d_pre_n and d_mail_c), all NaN
    before. Two writers: an elementwise PyTorch kernel (``torch.mul`` by
    1), as on the main path, where the launch after it may start only as
    its blocks exit; and ``early_writer`` (FIXTURES_CU), which lets
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

    writers = hazard_writers(torch, dev, early_writer)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    num_rows = graph.num_rows
    cell_mail = graph.cell_mail[pair]
    pn_c, md_c = cell_mail.shape
    pn_n, md_n = graph.net_mail[pair].shape
    h = torch.randn((num_rows + 1, D), generator=gen, device=dev)
    failed = []

    def after_writer(what, call, buf, src, want):
        failed.extend(after_writers(torch, writers, what, call, buf, src,
                                    want))

    f = softmax_sum_plain(h, cell_mail, num_rows)
    d_f = torch.randn((pn_c, D), generator=gen, device=dev)
    (f_v, d_f_v), src, buf = staged(torch, [f, d_f])
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
            torch, [dest, d_pre_n, d_mail_c])
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


def check_attn_hazard(torch, graph, dev, early_writer, pair=1):
    """Phase 3, programmatic dependent launches and ``--attn``, at one
    pair's shapes of ``graph``, for each head count of ATTN_HEADS:

    - attn_sum (with alpha) right after each writer of
      :func:`hazard_writers` writes the NaN-filled ``h``, and attn_bwd
      right after each writes the NaN-filled ``d_f``: each of HAZARD_REPS
      launches must equal bit for bit a run with a synchronize between
      writer and kernel (a read before the wait would find NaN).
    - The merged mailbox_scatter launched right after attn_bwd, whose
      rows kernel writes the cell cotangent that the scatter reads after
      its wait and whose reduce runs just before the scatter, which reads
      the graph's tables as it drains:
      HAZARD_REPS cotangents d_f, each a new draw, attn_bwd and the
      scatter enqueued back to back behind a spin kernel must equal bit
      for bit the result with a synchronize between the two, run after
      it (so the memory that the unsynchronized run's cotangent takes
      held another draw's); the first synchronized result must match the
      plain versions' (attn_close)."""
    from prtp_tpu_torch.ops.fused_gnn import (attn_bwd, attn_bwd_plain,
                                              attn_sum, attn_sum_plain,
                                              mailbox_scatter,
                                              mailbox_scatter_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    num_rows = graph.num_rows
    cell_mail = graph.cell_mail[pair]
    pn_c, md_c = cell_mail.shape
    pn_n, md_n = graph.net_mail[pair].shape
    tables = (graph.merged_rows[pair], graph.merged_seg_off[pair],
              graph.merged_pos[pair])
    tail = (torch.randn((pn_n, D), generator=gen, device=dev),
            graph.net_cnt[pair], md_n, pn_c * md_c)
    h = torch.randn((num_rows + 1, D), generator=gen, device=dev)
    dest = torch.randn((num_rows + 1, D), generator=gen, device=dev)
    writers = hazard_writers(torch, dev, early_writer)
    h_v = torch.full_like(h, float("nan"))
    d_f = torch.randn((pn_c, D), generator=gen, device=dev)
    d_f_v = torch.full_like(d_f, float("nan"))
    valid = (cell_mail != num_rows).reshape(-1)
    for nh in ATTN_HEADS:
        w = attn_weights(torch, nh, gen, dev)
        alpha = attn_sum_plain(h, cell_mail, num_rows, w, True)[1]

        def fwd():
            return attn_sum(h_v, cell_mail, num_rows, w, with_alpha=True)

        def bwd():
            d_m, d_w = attn_bwd(h, cell_mail, num_rows, w, alpha, d_f_v)
            return d_m[valid], d_w

        kernels = {"attn_sum": (h_v, h, fwd), "attn_bwd": (d_f_v, d_f, bwd)}
        for name, (buf, src, call) in kernels.items():
            for writer, write in writers.items():
                bad = []
                for _ in range(HAZARD_REPS):
                    runs = []
                    for sync in (False, True):
                        buf.fill_(float("nan"))
                        torch.cuda._sleep(int(0.2 * SPIN_CYCLES_PER_MS))
                        write(buf, src)
                        if sync:
                            torch.cuda.synchronize()
                        runs.append(call())
                    bad.append(sum(int((a != b).sum())
                                   for a, b in zip(*runs)))
                log(f"  programmatic launch: {name} (nh {nh}) right after "
                    f"{writer} writes its input: elements off the "
                    f"synchronized run in each of {HAZARD_REPS} launches "
                    f"{bad}")
                if any(bad) or not all(bool(torch.isfinite(t).all())
                                       for t in runs[1]):
                    raise AssertionError(f"{name} (nh {nh}) right after "
                                         f"{writer} differs: {bad}")

        def run(d_f, sync):
            got = dest.clone()
            torch.cuda._sleep(int(0.2 * SPIN_CYCLES_PER_MS))
            d_mail = attn_bwd(h, cell_mail, num_rows, w, alpha, d_f)[0]
            if sync:
                torch.cuda.synchronize()
            mailbox_scatter(got, *tables, d_mail, *tail)
            return got

        bad, err = [], None
        for _ in range(HAZARD_REPS):
            d_f = torch.randn((pn_c, D), generator=gen, device=dev)
            got = run(d_f, False)
            ref = run(d_f, True)
            bad.append(int((got != ref).sum()))
            if err is None:
                want = dest.clone()
                mailbox_scatter_plain(want, *tables, attn_bwd_plain(
                    h, cell_mail, num_rows, w, alpha, d_f)[0], *tail)
                ok, err = attn_close(torch, ref, want)
        log(f"  programmatic launch: mailbox_scatter (merged) right after "
            f"attn_bwd (nh {nh}): elements off the synchronized result in "
            f"each of {HAZARD_REPS} launches {bad}; synchronized vs plain "
            f"versions max abs err {err:.3g}")
        if any(bad) or not ok:
            raise AssertionError(f"mailbox_scatter after attn_bwd (nh {nh}) "
                                 f"differs: {bad}, vs plain {err}")


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
    b_ms = bound(nbytes, 0)[0]
    log(f"  gather_rows probe: 129202 x 128 bf16 from 160000 rows  kernel "
        f"{ms:.4f} ms  index_select {lms:.4f}  bound "
        f"{b_ms:.4f}  ({nbytes / ms / 1e6:.1f} GB/s)  exact")
    kept = b_ms / ms >= 0.5 and ms <= lms
    log(f"  gather_rows rule 2 (at least half its bound, no slower than "
        f"index_select): {b_ms / ms:.0%} of its bound, {lms / ms:.2f}x "
        f"index_select's speed: {'left alone' if kept else 'redesign owed'}")


def _zero_launches():
    from prtp_tpu_torch.ops import KERNELS
    for kern in KERNELS:
        kern.launches = 0


def _read_launches() -> dict:
    from prtp_tpu_torch.ops import KERNELS
    return {kern.__name__: kern.launches for kern in KERNELS}


def check_launches(what, counts, per, n, attn=False):
    """``counts`` of a run of ``n`` forwards or steps against ``per``,
    each kernel's launches in one of them: each kernel of ``per`` exactly
    ``n`` x its count, every one of them on the path (but the prior-row
    gather and the other variant's cell kernels), and none outside."""
    log(f"  {what}: launches {counts}; per call expected {per}")
    for name, k in per.items():
        if counts[name] != n * k:
            raise AssertionError(f"{what}: {name} launched {counts[name]} "
                                 f"times, expected {n * k}")
        if k == 0 and not may_idle(name, attn):
            raise AssertionError(f"{what}: {name} is not on the path")
    for name, k in counts.items():
        if name not in per and k:
            raise AssertionError(f"{what}: {name} launched {k} times, not "
                                 "on this path")


def bf16_ulp(np, x):
    """One bf16 ulp (8 significant bits) at ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def check_bf16(np, what, card, cpu, f32, ulps=BF16_ULPS):
    """A bf16 result on the card against the same on the cpu: at most
    ``ulps`` bf16 ulps of the cpu's largest |value| apart, and their mean
    distance at most REL_GAP x the mean distance of the cpu's bf16 result
    from ``f32``, the same weights' float32 result (the bf16 rounding,
    measured in this run). Returns the largest distance in ulps."""
    card, cpu, f32 = (np.asarray(a, np.float64) for a in (card, cpu, f32))
    ulp = bf16_ulp(np, float(np.abs(cpu).max()))
    worst = float(np.abs(card - cpu).max())
    dist = float(np.abs(card - cpu).mean())
    gap = float(np.abs(cpu - f32).mean())
    log(f"  {what}: card vs cpu (bf16) within {worst / ulp:.3g} bf16 ulps of "
        f"max |value| (allowed {ulps}); mean distance {dist:.3g}, "
        f"{dist / gap:.3g} x the bf16 result's mean distance from float32 "
        f"{gap:.3g} (allowed {REL_GAP})")
    if worst > ulps * ulp or dist > REL_GAP * gap:
        raise AssertionError(f"{what}: bf16 card vs cpu out of bounds")
    return worst / ulp


def serve(torch, np, model, model_cpu, parsed, design, per_forward,
          requests, task="reg", attn=False, f32_model=None):
    """Phase 4 (and 8) for one design: ``requests`` evaluation requests
    on the card with the launch counters zeroed just before and read just
    after (each must equal ``requests`` x its per-forward count, and
    every kernel of the walk must have run), then the same model on the
    CPU: predictions (``cls``: both logits) at rtol/atol 1e-4, and for
    ``cls`` the argmax labels equal except where a path's two logits lie
    within 1e-4 of each other (counted). A bf16 model is held by
    :func:`check_bf16` instead, against ``f32_model`` (its weights in
    float32, on the card), and its near ties are logits within BF16_ULPS
    bf16 ulps. Returns the launch counts."""
    from prtp_tpu_torch.test import evaluate_design

    torch.cuda.synchronize()
    _zero_launches()
    outs = []
    for req in range(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, mets = evaluate_design(model, parsed, device=DEVICE,
                                      case_idx=req, task=task)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs.append(preds)
        log(f"  {design} request {req}: wall {wall * 1e3:.2f} ms (pack "
            f"{mets['pack_s'] * 1e3:.2f} ms, evaluate "
            f"{mets['runtime'] * 1e3:.2f} ms)  loss {mets['loss']:.6f}  "
            f"r2 {mets['r2']:.6f}  tp {mets['tp']:.0f} fp {mets['fp']:.0f} "
            f"tn {mets['tn']:.0f} fn {mets['fn']:.0f}")
    counts = _read_launches()
    check_launches(f"{design}, {requests} request(s)", counts, per_forward,
                   requests, attn)
    num_paths = int(parsed["num_paths"])
    shape = (num_paths,) if task == "reg" else (num_paths, 2)
    for preds in outs:
        if preds.shape != shape or not np.all(np.isfinite(preds)):
            raise AssertionError(f"bad predictions {preds.shape}")
    t0 = time.perf_counter()
    preds_cpu, mets_cpu = evaluate_design(model_cpu, parsed, device="cpu",
                                          case_idx=requests, task=task)
    log(f"  {design} on the cpu (plain versions): "
        f"{time.perf_counter() - t0:.2f} s  loss {mets_cpu['loss']:.6f}  "
        f"r2 {mets_cpu['r2']:.6f}")
    low = f32_model is not None
    near_tol = 1e-4
    if low:
        with contextlib.redirect_stdout(io.StringIO()):
            preds_f32, _m = evaluate_design(f32_model, parsed, DEVICE,
                                            task=task)
        near_tol = BF16_ULPS * bf16_ulp(np, float(np.abs(preds_cpu).max()))
    for req, preds in enumerate(outs):
        if low:
            check_bf16(np, f"{design} request {req}", preds, preds_cpu,
                       preds_f32)
        else:
            diff = float(np.abs(preds - preds_cpu).max())
            np.testing.assert_allclose(preds, preds_cpu, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{design} request "
                                       f"{req} vs cpu")
            log(f"  {design} request {req} vs cpu: max abs diff {diff:.3g} "
                "(rtol/atol 1e-4): ok")
        if task == "cls":
            near = np.abs(preds_cpu[:, 0] - preds_cpu[:, 1]) <= near_tol
            off = preds.argmax(1) != preds_cpu.argmax(1)
            if (off & ~near).any():
                raise AssertionError(
                    f"{design} request {req}: argmax labels differ at "
                    f"{np.nonzero(off & ~near)[0]}")
            log(f"  {design} request {req}: argmax labels equal on the cpu's "
                f"but {int(off.sum())} of {int(near.sum())} rows whose "
                f"logits lie within {near_tol:.3g}")
    return counts


def train_run(torch, state, design, batches, what, per_step=None,
              card=None, step=None):
    """Phase 6: one run of train steps through ``train_step`` (the first,
    whose gradients stay in ``.grad``) and ``train_steps`` (the rest), or
    through ``step(state, design, ids, mask)`` (phase 14's).
    With ``per_step`` (on the card) the launch counters are zeroed just
    before the run and read just after, and each kernel must have run
    ``len(batches)`` x its per-step count. With ``card`` (on the CPU,
    :func:`card_branches`) the first step takes the card's branches.
    Returns (losses, the first step's gradients on the CPU, counts)."""
    import numpy as np
    from prtp_tpu_torch.trainer import train_step, train_steps

    on_card = per_step is not None
    if on_card:
        torch.cuda.synchronize()
        _zero_launches()
    t0 = time.perf_counter()
    with take_card_branches(torch, state.model, card or {}) as taken:
        first = (step or train_step)(state, design, *batches[0])
    if card:
        log(f"  {what} (cpu): first step took the card's branch at {taken}")
    grads = {k: p.grad.detach().to("cpu", copy=True)
             for k, p in state.model.named_parameters()}
    if step is not None:
        rest = {"loss": [step(state, design, *b)["loss"] for b in batches[1:]]}
    else:
        rest = (train_steps(state, design, batches[1:]) if len(batches) > 1
                else {})
    losses = [float(first["loss"])] + [float(x) for x in rest.get("loss", [])]
    wall = time.perf_counter() - t0
    counts = _read_launches()
    log(f"  {what} ({'card' if on_card else 'cpu, plain versions'}): "
        f"{len(batches)} steps in {wall:.3f} s; losses "
        + ", ".join(f"{x:.6f}" for x in losses))
    if on_card:
        check_launches(what, counts, per_step, len(batches))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: a loss is not finite: {losses}")
    return losses, grads, counts


def pool_inputs(cnn, x) -> dict:
    """The input of each max pool of a layout CNN, as a train step's
    forward computes it (the U-Net's BatchNorms on batch statistics; the
    caller runs a copy, whose running averages this moves)."""
    import torch.nn.functional as F
    from prtp_tpu_torch.models.unet import UNet
    from prtp_tpu_torch.ops.pool import pool_2x2

    if isinstance(cnn, UNet):
        x1 = cnn.DoubleConv_0(x)
        x2 = cnn.Down_0(x1)
        x3 = cnn.Down_1(x2)
        up = cnn.Up_2(cnn.Up_1(cnn.Up_0(cnn.Down_2(x3), x3), x2), x1)
        return {"Down_0": x1, "Down_1": x2, "Down_2": x3,
                "OutConv_0": cnn.OutConv_0.Conv_0(up)}
    a = F.relu(cnn.Conv_0(x))
    return {"Conv_0": a, "Conv_1": F.relu(cnn.Conv_1(pool_2x2(a, "max")))}


def pool_winner_flips(torch, cnn_cpu, x_cpu, dev) -> dict:
    """A layout CNN's max pools at the same weights and raster on the card
    and on the CPU, in train mode: the windows (channels included) whose
    winner differs, counted where the window's max is positive (a window
    of ReLU zeros, or of values that the ReLU after the U-Net's OutConv
    pool zeroes, passes no gradient). Where two values nearly tie,
    rounding that differs by an ulp can pick another winner; the window's
    whole gradient then goes to another element, which moves the weight
    gradients of the convs above that pool (LAYOUTNET_POOLS,
    UNET_POOLS) by far more than rounding. Returns ``{pool: flipped
    windows}``."""

    def winners(a):
        n, c, h, w = a.shape
        win = a.reshape(n, c, h // 2, 2, w // 2, 2).permute(
            0, 1, 2, 4, 3, 5).reshape(-1, 4)
        return win.argmax(dim=1).cpu(), (win.amax(dim=1) > 0).cpu()

    cpu, card = copy.deepcopy(cnn_cpu).train(), copy.deepcopy(cnn_cpu).to(dev)
    with torch.no_grad():
        a, b = pool_inputs(cpu, x_cpu), pool_inputs(card.train(),
                                                   x_cpu.to(dev))
    flips = {}
    for pool in a:
        (wa, live), (wb, _) = winners(a[pool]), winners(b[pool])
        flips[pool] = int(((wa != wb) & live).sum())
    return flips


def compare_runs(torch, what, card, cpu, flips, pools=None, f32_err=None,
                 rasters=1):
    """The card's run against the CPU's: the first step's gradients leaf
    by leaf within GRAD_TOL x the leaf's largest |g|, every loss within
    LOSS_RTOL. A conv above a max pool with winners that differ
    (``flips``, at most MAX_FLIPS a pool and raster; ``pools`` maps each
    pool to the parameter prefixes above it) is held to FLIP_TOL instead.
    A leaf in ``f32_err`` (its float32 gradient's distance from float64,
    :func:`unet_f32_error`) may differ by twice that more."""
    import numpy as np
    (l_card, g_card, *_), (l_cpu, g_cpu, *_) = card, cpu
    pools = pools or LAYOUTNET_POOLS
    f32_err = f32_err or {}
    if max(flips.values()) > MAX_FLIPS * rasters:
        raise AssertionError(f"{what}: {flips} max-pool winners differ from "
                             f"the cpu's (allowed {MAX_FLIPS} a pool and "
                             f"raster, {rasters} rasters)")
    worst, worst_flip = (0.0, ""), (0.0, "")
    for key, want in g_cpu.items():
        scale = float(want.abs().max())
        diff = float((g_card[key] - want).abs().max())
        rel = diff / scale if scale else diff
        flipped = any(flips[pool] and key.startswith(above)
                      for pool, above in pools.items())
        if flipped:
            worst_flip = max(worst_flip, (rel, key))
        else:
            worst = max(worst, (rel, key))
        allowed = ((FLIP_TOL if flipped else GRAD_TOL) * scale
                   + 2 * f32_err.get(key, 0.0))
        if diff > allowed:
            raise AssertionError(f"{what}: gradient of {key} differs from "
                                 f"the cpu's by {diff} (its max |g| {scale}"
                                 f", allowed {allowed})")
    np.testing.assert_allclose(l_card, l_cpu, rtol=LOSS_RTOL,
                               err_msg=f"{what}: losses vs cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    log(f"  {what} vs cpu: first-step gradients within {worst[0]:.3g} x "
        f"each leaf's max |g| ({worst[1]}; allowed {GRAD_TOL}"
        + (", plus twice the leaf's float32 error" if f32_err else "")
        + f"); convs above a flipped pool window within {worst_flip[0]:.3g}"
        f" ({worst_flip[1]}; allowed {FLIP_TOL}); losses within rtol "
        f"{rel:.3g} (allowed {LOSS_RTOL}): ok")


def card_branches(torch, cnn_cpu, x_cpu, dev) -> tuple:
    """LayoutNet's SIGN_CONVS outputs (the pre-activations of the ReLU
    after Conv_2 and the leaky ReLU after Conv_3) at the same weights and
    raster on the card and on the CPU. They must agree within PRE_RTOL x
    their largest |value|, and at most MAX_FLIPS elements a conv and
    raster may differ in sign: values within rounding of 0, which card and CPU put
    on either side. At such an element the gradient passes on one and not
    the other (the leaky ReLU's: at another slope), which moves the
    weight gradients of the convs below by far more than rounding; the
    CPU's first train step takes the card's branch there
    (:func:`take_card_branches`). Returns ``{conv: the card's output, on
    the CPU}`` (empty for the U-Net) and ``{conv: sign flips}``."""
    import torch.nn.functional as F
    from prtp_tpu_torch.models.layoutnet import LayoutNet
    from prtp_tpu_torch.ops.pool import pool_2x2

    if not isinstance(cnn_cpu, LayoutNet):
        return {}, {}

    def outputs(cnn, x):
        a = pool_2x2(F.relu(cnn.Conv_0(x)), "max")
        z2 = cnn.Conv_2(pool_2x2(F.relu(cnn.Conv_1(a)), "max"))
        return {"Conv_2": z2, "Conv_3": cnn.Conv_3(F.relu(z2))}

    with torch.no_grad():
        want = outputs(cnn_cpu, x_cpu)
        got = outputs(copy.deepcopy(cnn_cpu).to(dev), x_cpu.to(dev))
    card, flips = {}, {}
    for name in SIGN_CONVS:
        card[name] = got[name].cpu()
        err = float((card[name] - want[name]).abs().max())
        scale = float(want[name].abs().max())
        flips[name] = int(((card[name] > 0) != (want[name] > 0)).sum())
        allowed = MAX_FLIPS * x_cpu.shape[0]
        if err > PRE_RTOL * scale or flips[name] > allowed:
            raise AssertionError(f"LayoutNet {name}'s output on the card "
                                 f"differs from the cpu's by {err} (its max"
                                 f" {scale}), {flips[name]} signs (allowed "
                                 f"{PRE_RTOL} x max, {allowed})")
    return card, flips


def card_layers(torch, np, cnn_cpu, x_cpu, dev) -> tuple:
    """A bf16 layout CNN's layers (each convolution, transposed
    convolution and BatchNorm) at the same weights and raster, in train
    mode, on the card and on the CPU. Sums taken in another order round
    an element of a bf16 output an ulp the other way, and that moves
    the layers after it: a max-pool winner or a ReLU branch can change,
    so the first step's gradients would differ by far more than their
    own rounding. The CPU's first train step takes the card's value at
    every element of these layers that differs
    (:func:`take_card_branches`), so the gradients compare the backward;
    the forward is compared on its own (each layer's output logged
    here, within 2 x BF16_ULPS bf16 ulps of its largest |value|, and the
    predictions by :func:`check_bf16`). Returns ``{layer: the card's
    output, on the CPU}`` and ``{layer: elements that differ}``."""
    from prtp_tpu_torch.models.layoutnet import Conv2d
    from prtp_tpu_torch.models.unet import BatchNorm, ConvTranspose2d

    def outputs(cnn, x):
        got, handles = {}, []
        for name, mod in cnn.named_modules():
            if isinstance(mod, (Conv2d, ConvTranspose2d, BatchNorm)):
                handles.append(mod.register_forward_hook(
                    lambda _m, _i, out, name=name: got.__setitem__(
                        name, out.detach())))
        try:
            cnn(x)
        finally:
            for handle in handles:
                handle.remove()
        return got

    with torch.no_grad():
        want = outputs(copy.deepcopy(cnn_cpu).train(), x_cpu)
        got = outputs(copy.deepcopy(cnn_cpu).to(dev).train(), x_cpu.to(dev))
    card, differ, worst = {}, {}, (-1.0, "")
    for name, w in want.items():
        card[name] = got[name].cpu()
        differ[name] = int((card[name] != w).sum())
        ulp = bf16_ulp(np, float(w.abs().max()))
        worst = max(worst, (float((card[name] - w).abs().max()) / ulp, name))
    log(f"  bf16 layout CNN, card vs cpu in train mode: "
        f"{sum(differ.values())} elements differ in {len(differ)} layers "
        f"({ {k: n for k, n in differ.items() if n} }); at most "
        f"{worst[0]:.3g} bf16 ulps of a layer's max |value| ({worst[1]}; "
        f"allowed {2 * BF16_ULPS})")
    if worst[0] > 2 * BF16_ULPS:
        raise AssertionError(f"bf16 layout CNN: {worst[1]} differs on the "
                             f"card by {worst[0]} ulps")
    return card, differ


@contextlib.contextmanager
def take_card_branches(torch, model, card):
    """While open, the CPU model's LayoutNet takes the card's branch at
    each element of a SIGN_CONVS output whose sign differs from the
    card's (``card``, :func:`card_branches`): the forward uses the card's
    value there (within rounding of the CPU's, both near 0) with the
    gradient passed straight through, so the activation after it passes
    its gradient as on the card. Elsewhere nothing changes. A bf16 layer
    of ``card`` (:func:`card_layers`) takes the card's value at every
    element whose value differs. Yields ``{layer: elements taken}`` of
    the last forward."""
    taken, handles = {}, []

    def hook_for(name):
        def hook(_module, _inputs, out):
            want = card[name]
            if want.shape != out.shape:
                raise AssertionError(f"{name}: output {tuple(out.shape)}, "
                                     f"the card's {tuple(want.shape)}")
            flip = (out != want if want.dtype == torch.bfloat16
                    else (out > 0) != (want > 0))
            taken[name] = int(flip.sum())
            if want.dtype == torch.bfloat16:  # the step exact in float32
                o32 = out.float()
                return (o32 + torch.where(flip, want.float() - o32, 0.0)
                        .detach()).to(out.dtype)
            return out + torch.where(flip, want - out,
                                     torch.zeros_like(out)).detach()
        return hook

    for name in card:
        handles.append(model.cnn.get_submodule(name).register_forward_hook(
            hook_for(name)))
    try:
        yield taken
    finally:
        for handle in handles:
            handle.remove()


def _state_snapshot(state):
    """The model's state_dict and FlatAdam's state, copied to the CPU."""
    opt = state.optimizer
    return ({k: v.to("cpu", copy=True)
             for k, v in state.model.state_dict().items()},
            {"mu": opt.mu.to("cpu", copy=True),
             "nu": opt.nu.to("cpu", copy=True), "count": opt.count})


def _state_restore(state, snap):
    state.model.load_state_dict(snap[0])
    state.optimizer.load_state_dict(snap[1])


def _grads(state):
    return {k: p.grad.detach().to("cpu", copy=True)
            for k, p in state.model.named_parameters()}


def paired_steps(torch, model_cpu, designs, batches, what, per_step, task,
                 attn=False, card=None, rounding=None, step=None):
    """Phase 8: the same steps through ``trainer.train_step`` on the CPU
    and on the card, each card step from the CPU's state before it (its
    parameters, buffers and Adam moments), so that each step's loss is
    compared at the same weights. Adam moves a weight by about LR
    whatever its gradient's size, so the sign of a near-zero gradient
    element, which float32 rounding decides, would otherwise take the two
    runs apart: on the CPU, the cls model's weights perturbed by 1e-7 of
    their value give a fifth loss 3e-3 away. The launch counters are
    zeroed just before the card's steps and read just after: each kernel
    must have run ``len(batches)`` x its per-step count. The CPU's first
    step takes the card's branches ``card`` (:func:`card_branches`). The
    walk runs in the bf16 ``rounding`` (``trainer.train_step``; None: the
    model's reduce's). ``step(state, design, ids, mask)`` replaces
    ``train_step`` (phase 14's).
    Returns ``{where:
    (losses, the first step's gradients, counts, the buffers after each
    step, the state_dict after the last)}``, all on the CPU."""
    import numpy as np
    from prtp_tpu_torch.trainer import init_state, make_optimizer, train_step

    out, befores = {}, []
    for where in ("cpu", DEVICE):
        state = init_state(copy.deepcopy(model_cpu), make_optimizer(LR), where)
        losses, grads, buffers = [], None, []
        if where != "cpu":
            torch.cuda.synchronize()
            _zero_launches()
        t0 = time.perf_counter()
        for t, (ids, mask) in enumerate(batches[where]):
            if where == "cpu":
                befores.append(_state_snapshot(state))
            else:
                _state_restore(state, befores[t])
            branches = card if where == "cpu" and t == 0 else None
            with take_card_branches(torch, state.model,
                                    branches or {}) as taken:
                mets = (step(state, designs[where], ids, mask) if step
                        else train_step(state, designs[where], ids, mask,
                                        task, rounding))
                losses.append(float(mets["loss"]))
            if branches:
                log(f"  {what} (cpu): first step took the card's branch at "
                    f"{taken}")
            if t == 0:
                grads = _grads(state)
            buffers.append({k: b.to("cpu", copy=True)
                            for k, b in state.model.named_buffers()})
        wall = time.perf_counter() - t0
        counts = _read_launches()
        label = ("cpu, plain versions" if where == "cpu"
                 else "card, each step from the cpu's state")
        log(f"  {what} ({label}): {len(losses)} steps in {wall:.3f} s; "
            "losses " + ", ".join(f"{x:.6f}" for x in losses))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{what}: a loss is not finite: {losses}")
        out[where] = (losses, grads, counts, buffers,
                      {k: v.to("cpu", copy=True)
                       for k, v in state.model.state_dict().items()})
    check_launches(what, out[DEVICE][2], per_step, len(batches[DEVICE]), attn)
    return out


def float32_first_step(torch, twin, design, batch, task):
    """The first train step of ``twin`` (a bf16 model's weights in
    float32) on the card: its loss and gradients (on the CPU), the
    float32 side of the bf16 bounds of :func:`compare_bf16_runs`."""
    from prtp_tpu_torch.trainer import init_state, make_optimizer, train_step

    state = init_state(copy.deepcopy(twin), make_optimizer(LR), DEVICE)
    loss = float(train_step(state, design, *batch, task)["loss"])
    return loss, _grads(state)


def compare_bf16_runs(torch, what, card, cpu, f32_first):
    """A bf16 model's runs, the card's against the CPU's (whose first
    step took the card's layout-CNN values, :func:`card_layers`): the
    first step's gradients leaf by leaf within BF16_GRAD_TOL x the leaf's
    max |g|, and each leaf's mean distance at most REL_GAP x the mean
    distance of the CPU's bf16 gradient from the float32 twin's
    (``f32_first``, the same weights and batch on the card); every loss
    within BF16_LOSS_RTOL, and the first within REL_GAP x its distance
    from the float32 twin's loss."""
    import numpy as np
    (l_card, g_card, *_), (l_cpu, g_cpu, *_) = card, cpu
    loss32, g32 = f32_first
    rows, bad, sides = [], [], []
    for key, want in g_cpu.items():
        scale = float(want.abs().max())
        err, off = (g_card[key] - want).abs(), (want - g32[key]).abs()
        gap = float(off.mean())
        rel, dist = float(err.max()) / scale, float(err.mean())
        ratio = dist / gap if gap else (0.0 if dist == 0 else np.inf)
        rows.append((rel, ratio, key, float(off.max()) / scale))
        sides.append((rel, key, float((g_card[key] - g32[key]).abs().max())
                      / scale, float(off.max()) / scale))
        if float(err.max()) > BF16_GRAD_TOL * scale or dist > REL_GAP * gap:
            bad.append(key)
    worst_rel = max(rows)
    worst_ratio = max(rows, key=lambda r: r[1])
    worst_f32 = min(rows, key=lambda r: r[3])
    log(f"  {what} vs cpu (bf16): first-step gradients within "
        f"{worst_rel[0]:.3g} x each leaf's max |g| ({worst_rel[2]}; allowed "
        f"{BF16_GRAD_TOL}); mean distance at most {worst_ratio[1]:.3g} x "
        f"the bf16 gradient's from float32 ({worst_ratio[2]}; allowed "
        f"{REL_GAP}); the bf16 gradients lie at least {worst_f32[3]:.3g} "
        f"x max |g| from float32 ({worst_f32[2]}); by leaf (max / max |g|, "
        "mean / bf16-f32 mean, bf16-f32 max / max |g|): "
        + ", ".join(f"{k} {a:.2g} {b:.2g} {c:.2g}" for a, b, k, c in sorted(
            rows, key=lambda r: -r[1])[:8]))
    log(f"  {what}: each side's first-step bf16 gradient against the float32"
        " twin's, at the leaves farthest card vs cpu (x the leaf's max |g|:"
        " card vs cpu, card vs float32, cpu vs float32): " + ", ".join(
            f"{k} {a:.3g} {b:.3g} {c:.3g}"
            for a, k, b, c in sorted(sides, reverse=True)[:4]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    d0, gap0 = abs(l_card[0] - l_cpu[0]), abs(l_cpu[0] - loss32)
    log(f"  {what} vs cpu (bf16): losses within rtol {rel:.3g} (allowed "
        f"{BF16_LOSS_RTOL}); the first {d0:.3g} apart, its distance from "
        f"the float32 twin's {gap0:.3g} (allowed {REL_GAP} x)")
    if bad:
        raise AssertionError(f"{what}: bf16 gradients of {bad} out of bounds")
    if rel > BF16_LOSS_RTOL or d0 > REL_GAP * gap0:
        raise AssertionError(f"{what}: bf16 losses {l_card} vs cpu {l_cpu}")


def check_running_averages(torch, what, card, cpu):
    """The U-Net's BatchNorm running averages after each step (from the
    same state), card against CPU, within STAT_RTOL x each buffer's
    largest |value|."""
    worst = 0.0
    for t, (got_t, want_t) in enumerate(zip(card, cpu)):
        for key, want in want_t.items():
            if not key.endswith(("running_mean", "running_var")):
                continue
            got, scale = got_t[key], float(want.abs().max())
            worst = max(worst, float((got - want).abs().max()) / scale)
            if not torch.allclose(got, want, rtol=STAT_RTOL,
                                  atol=STAT_RTOL * scale):
                raise AssertionError(f"{what}: {key} after step {t} differs "
                                     "from the cpu's by "
                                     f"{float((got - want).abs().max())}")
    log(f"  {what}: BatchNorm running averages card vs cpu after each step "
        f"within {worst:.3g} x each buffer's max |value| (allowed "
        f"{STAT_RTOL}): ok")


def unet_f32_error(torch, model_cpu, design, batch, task, dev) -> dict:
    """The float32 rounding of the U-Net's first-step gradients: the
    cotangent that the first step's loss gives the U-Net's map on the
    CPU (float32, as the step computes it), then the U-Net's parameter
    gradients for it in float32 and in float64, on the CPU and on the
    card. The two float64 runs must agree to 1e-8 of each leaf's max |g|
    (the card computes the same function). Returns ``{leaf: the larger
    of the CPU's and the card's max |g32 - g64|}``. BatchNorm's backward
    over 256 x 256 positions a channel cancels most of its sums, so these
    reach about a percent of a leaf's max |g|: a bound that card and CPU
    cannot beat against each other."""
    from prtp_tpu_torch.trainer import task_loss_and_metrics

    model = copy.deepcopy(model_cpu).train()
    kept = {}

    def keep(_module, _inputs, out):
        out.retain_grad()
        kept["map"] = out

    handle = model.cnn.register_forward_hook(keep)
    try:
        ids, mask = batch
        loss, _m = task_loss_and_metrics(task, model(design, ids), design,
                                         ids, mask)
        loss.backward()
    finally:
        handle.remove()
    cot = kept["map"].grad
    grads = {}
    for where in ("cpu", dev):
        for dtype in (torch.float32, torch.float64):
            cnn = copy.deepcopy(model_cpu.cnn).to(where, dtype).train()
            out = cnn(design.cnn_input.to(where, dtype))
            grads[where, dtype] = [g.to("cpu", torch.float64) for g in
                                   torch.autograd.grad(
                                       (out * cot.to(where, dtype)).sum(),
                                       list(cnn.parameters()))]
    names = [f"cnn.{name}" for name, _p in model_cpu.cnn.named_parameters()]
    err, worst64 = {}, 0.0
    for i, name in enumerate(names):
        ref = grads["cpu", torch.float64][i]
        scale = float(ref.abs().max())
        d64 = float((grads[dev, torch.float64][i] - ref).abs().max())
        worst64 = max(worst64, d64 / scale)
        if d64 > 1e-8 * scale:
            raise AssertionError(f"U-Net float64 gradient of {name}: card "
                                 f"and cpu differ by {d64} (max |g| {scale})")
        err[name] = max(
            float((grads[w, torch.float32][i]
                   - grads[w, torch.float64][i]).abs().max())
            for w in ("cpu", dev))
    log(f"  U-Net first-step gradients in float64, card vs cpu: within "
        f"{worst64:.3g} x each leaf's max |g| (allowed 1e-8): ok")
    return err


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


def step_timing(torch, dev, fn, queue_ms) -> dict:
    """``fn``'s device time (CUDA events, queue pre-filled for
    ``queue_ms``) and time as launched, then one call's wall time and,
    under torch.profiler, the device's busy time, idle share and kernel
    launches."""
    timer = Timer(torch, dev)
    out = {"device_ms": timer.ms(fn, queue_ms=queue_ms),
           "launched_ms": timer.ms(fn, queue_ms=0)}
    del timer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    out["wall_ms"] = (time.perf_counter() - t0) * 1e3
    by_name = device_kernels(torch, fn)
    if not by_name:
        raise AssertionError("torch.profiler recorded no device kernels")
    out["busy_ms"] = sum(t for t, _ in by_name.values()) / 1e3
    out["idle"] = 1 - out["busy_ms"] / out["wall_ms"]
    out["launches"] = sum(c for _, c in by_name.values())
    out["by_name"] = by_name
    return out


def log_port_kernels(by_name, what):
    """Every kernel of the port by name, summed over its instantiations."""
    for name in KERNEL_INFO:
        symbols = KERNEL_SYMBOLS.get(name, (f"{name}_kernel",))
        # a whole symbol: softmax_sum_kernel is inside
        # segment_softmax_sum_kernel
        hits = [v for k, v in by_name.items()
                if any(re.search(rf"(?<!\w){sym}(?!\w)", k)
                       for sym in symbols)]
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


@contextlib.contextmanager
def timed(torch, module, *names):
    """Wrap the functions ``names`` of ``module`` in :class:`_Timed` for
    the block (callers in the module look them up there at call time);
    yields the wrappers by name."""
    wrappers = {name: _Timed(torch, getattr(module, name)) for name in names}
    for name, w in wrappers.items():
        setattr(module, name, w)
    try:
        yield wrappers
    finally:
        for name, w in wrappers.items():
            setattr(module, name, w.fn)


def tf32_on(torch):
    """TF32 on for matmuls and cuDNN convolutions (cuDNN's is PyTorch's
    default): a CLI run after this is float32 only if the CLI sets it."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def check_float32(torch, run):
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if any(flags):
        raise AssertionError(f"{run}: the CLI left TF32 on (matmul, cuDNN: "
                             f"{flags})")


def cli_train(torch, args, run, smi):
    """One train CLI run (``train.main``) on the card, TF32 on before it.
    The launch counters are zeroed just before and read just after: each
    kernel must match the run's steps and validation forwards on the
    designs they ran on (``gather_rows`` 0 times: a parsed design has no
    prior rows), and the CLI must have turned TF32 off. Returns (state,
    counts, each validation's ``(res, f1, r2)``)."""
    from prtp_tpu_torch import train as train_mod

    steps_fn = "dp_train_steps" if "--dp" in args else "train_steps"
    with timed(torch, train_mod, steps_fn, "validate", "evaluate") as w:
        tf32_on(torch)
        _zero_launches()
        t0 = time.perf_counter()
        state = train_mod.main(args, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _read_launches()
    check_float32(torch, run)
    attn = "--attn" in args
    want = dict.fromkeys(counts, 0)
    for _s, (_st, pack, chunk, *_r), _o in w[steps_fn].calls:
        for name, n in launches_per_step(pack.graph, attn).items():
            want[name] += len(chunk) * n
    for _s, (_m, pack, *_r), _o in w["evaluate"].calls:
        for name, n in launches_per_forward(pack.graph, attn).items():
            want[name] += n
    steps = w[steps_fn].calls
    n_steps = sum(len(a[2]) for _s, a, _o in steps)
    val_ms = [s * 1e3 for s, _a, _o in w["validate"].calls]
    log(f"phase 7: {run}: {wall:.2f} s wall, {n_steps} steps "
        f"({sum(s for s, _a, _o in steps) / n_steps * 1e3:.2f} ms a step as "
        f"launched, chunks {[round(s * 1e3, 2) for s, _a, _o in steps]} ms), "
        f"{len(val_ms)} validations ("
        + ", ".join(f"{ms:.2f}" for ms in val_ms)
        + f" ms); state step {state.step}; TF32 off after it  [{smi}]")
    log(f"  {run}: launches {counts}")
    if want["gather_rows"]:
        raise AssertionError(f"{run}: a parsed design has prior rows")
    for name, n in counts.items():
        if n != want[name]:
            raise AssertionError(f"{run}: {name} launched {n} times, "
                                 f"expected {want[name]}")
        if not may_idle(name, attn) and not n:
            raise AssertionError(f"{run}: {name} did not launch")
    if len(val_ms) < 2:
        raise AssertionError(f"{run}: {len(val_ms)} validations")
    return state, counts, [o for _s, _a, o in w["validate"].calls]


def cli_test(torch, args, where, run, smi):
    """One test CLI run (``test.main``) on ``where``, TF32 on before it,
    its standard output captured. On the card the launch counters, zeroed
    just before, must match its forwards. Returns ``{"res", "preds",
    "out", "crit", "counts"}``: the per-design metric rows, predictions,
    the printed text, the ``predict_critical`` lists it wrote (regression)
    and the counts."""
    from prtp_tpu_torch import test as test_mod

    options = test_mod.get_options(args)
    buf = io.StringIO()
    with timed(torch, test_mod, "evaluate", "dp_evaluate",
               "evaluate_design") as w, contextlib.redirect_stdout(buf):
        tf32_on(torch)
        _zero_launches()
        t0 = time.perf_counter()
        res, _f1, _r2, preds = test_mod.main(args, device=where)
        wall = time.perf_counter() - t0
    counts = _read_launches()
    check_float32(torch, f"{run} on {where}")
    want = dict.fromkeys(counts, 0)
    for _s, (_m, pack, *_r), _o in (w["evaluate"].calls
                                    + w["dp_evaluate"].calls):
        for name, n in launches_per_forward(pack.graph,
                                            "--attn" in args).items():
            want[name] += n
    if where != "cpu" and counts != want:
        raise AssertionError(f"{run} on {where}: launches {counts}, expected "
                             f"{want}")
    crit = {}
    crit_dir = os.path.join(options.model_saving_dir, "predict_critical")
    for design in preds if os.path.isdir(crit_dir) else ():
        with open(os.path.join(crit_dir, f"{design}.json")) as f:
            crit[design] = json.load(f)
    mets = [o[1] for _s, _a, o in w["evaluate_design"].calls]
    log(f"phase 7: {run} on {where}: {wall:.2f} s wall; runtime "
        + ", ".join(f"{m['runtime'] * 1e3:.2f}" for m in mets)
        + " ms (pack " + ", ".join(f"{m['pack_s'] * 1e3:.2f}" for m in mets)
        + f" ms); TF32 off after it  [{smi}]")
    return {"res": res, "preds": preds, "out": buf.getvalue(), "crit": crit,
            "counts": counts}


_LEVEL = re.compile(r"^level (\S+): #=(\d+), r2=(\S+), mape=(\S+)$", re.M)
_NUMBER = re.compile(r"-?(?:\d+\.\d+(?:e[+-]?\d+)?|inf|nan)")
_COUNTS = re.compile(r"^\ttp: (\d+)  fp: (\d+)  fn: (\d+)  tn: (\d+) ", re.M)


def compare_test_clis(np, run, card, cpu, data, task, f32=None):
    """A test CLI's results on the card against the CPU's, from one
    checkpoint: each design's predictions (``cls``: logits) and loss at
    rtol/atol 1e-4, R² at 1e-4 where the design's arrival times differ;
    the per-level lines (the same levels and path counts; R² and MAPE
    at rtol 1e-3, atol 1e-3: ratios of sums of squared errors of
    predictions that agree to 1e-4); the confusion counts and
    ``predict_critical`` equal, except for paths whose label is a near
    tie on the CPU (predicted slack, or the two logits' margin, within
    2e-4 + 2e-4 x |prediction|), counted. A bf16 run (``f32``: the same
    checkpoint's test CLI in float32 on the card) holds the predictions
    by :func:`check_bf16`, the loss, R² and per-level values at rtol and
    atol BF16_ULPS bf16 ulps (BF16_ULPS x 2^-8; a per-level value may
    instead lie within REL_GAP x its distance from the float32 run's: a
    level whose arrival times barely vary has an R² that divides by a
    residue), and its near ties are margins within BF16_ULPS ulps of
    |prediction|."""
    from prtp_tpu_torch.data.dataset import load_design_npz

    tol, lv_tol, near_ties = 1e-4, 1e-3, 0
    if f32 is not None:
        tol = lv_tol = BF16_ULPS * 2.0 ** -8
    for i, design in enumerate(cpu["preds"]):
        parsed = load_design_npz(os.path.join(data, f"{design}.npz"))
        p, q = card["preds"][design], cpu["preds"][design]
        if p.shape != q.shape or not np.all(np.isfinite(p)):
            raise AssertionError(f"{run}: bad predictions {p.shape}")
        if f32 is None:
            np.testing.assert_allclose(p, q, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{run}: {design} predictions")
        else:
            check_bf16(np, f"{run}: {design} predictions", p, q,
                       f32["preds"][design])
        np.testing.assert_allclose(card["res"][i][0], cpu["res"][i][0],
                                   rtol=tol, atol=tol,
                                   err_msg=f"{run}: {design} loss")
        endpoint = np.asarray(parsed["path_endpoint"], np.int64)
        arrival = np.asarray(parsed["arrival_time"])[endpoint]
        if task == "reg" and np.ptp(arrival) > 0:
            np.testing.assert_allclose(card["res"][i][1], cpu["res"][i][1],
                                       rtol=tol, atol=tol,
                                       err_msg=f"{run}: {design} r2")
        if task == "cls":
            labels_p, labels_q = p.argmax(1), q.argmax(1)
            margin = q[:, 0] - q[:, 1]
        else:
            required = np.asarray(parsed["required_time"])[endpoint]
            labels_p, labels_q = required - p < 0, required - q < 0
            margin = required - q
        scale = np.abs(q).max(axis=-1) if q.ndim > 1 else np.abs(q)
        near = (np.abs(margin) <= 2e-4 + 2e-4 * scale if f32 is None else
                np.abs(margin) <= BF16_ULPS * bf16_ulp(np, scale + 1e-30))
        off = labels_p != labels_q
        if (off & ~near).any():
            raise AssertionError(f"{run}: {design}: labels differ at "
                                 f"{np.nonzero(off & ~near)[0]}")
        near_ties += int(off.sum())
        if task == "reg" and not off.any() and \
                card["crit"][design] != cpu["crit"][design]:
            raise AssertionError(f"{run}: {design} predict_critical differs")
    lv_card, lv_cpu = _LEVEL.findall(card["out"]), _LEVEL.findall(cpu["out"])
    if [r[:2] for r in lv_card] != [r[:2] for r in lv_cpu]:
        raise AssertionError(f"{run}: per-level lines differ in levels or "
                             "counts")
    if lv_cpu:
        a = np.array([r[2:] for r in lv_card], float)
        b = np.array([r[2:] for r in lv_cpu], float)
        ok = np.isclose(a, b, rtol=lv_tol, atol=lv_tol, equal_nan=True)
        if f32 is not None:  # a level whose R2 or MAPE bf16 moves far
            c = np.array([r[2:] for r in _LEVEL.findall(f32["out"])], float)
            ok |= np.abs(a - b) <= REL_GAP * np.abs(b - c)
        if not ok.all():
            raise AssertionError(f"{run}: per-level R2 and MAPE: card {a[~ok]}"
                                 f", cpu {b[~ok]}")
    cm_card, cm_cpu = _COUNTS.findall(card["out"]), _COUNTS.findall(cpu["out"])
    if not near_ties and cm_card != cm_cpu:
        raise AssertionError(f"{run}: confusion counts {cm_card} against the "
                             f"cpu's {cm_cpu}")
    worst = max(float(np.abs(card["preds"][d] - cpu["preds"][d]).max())
                for d in cpu["preds"])
    log(f"phase 7: {run} card vs cpu: predictions within {worst:.3g}"
        f" (rtol/atol {tol:.3g}); per design [loss, r2] card "
        f"{[[round(r[0], 6), round(r[1], 6)] for r in card['res']]} cpu "
        f"{[[round(r[0], 6), round(r[1], 6)] for r in cpu['res']]}; "
        f"{len(lv_cpu)} per-level lines agree; confusion counts (tp, fp, fn,"
        f" tn) {cm_card} / {cm_cpu}; {near_ties} labels off at near ties: ok")


def big_design_runs(torch, np, dev, smi, tmp) -> dict:
    """Phase 7, big design: ``synthetic --big``, ``generate`` (the native
    rasterizer must load), the train CLI at full width, again (it must
    resume), the test CLI on the card and on the CPU from the same
    checkpoint. Returns each run's launch counts."""
    from prtp_tpu_torch.data import generate, synthetic
    from prtp_tpu_torch.data.dataset import load_design_npz
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.native import native_available

    launches = {}
    raw, data, mdl = (os.path.join(tmp, d) for d in ("raw", "data", "mdl"))
    t0 = time.perf_counter()
    synthetic.main(["--out", raw, "--big", "--designs", CLI_DESIGN,
                    "--num_paths", str(CLI_PATHS), "--depth", str(CLI_STAGES)])
    log(f"phase 7: synthetic --big ({CLI_PATHS} paths, {CLI_STAGES} stages, "
        f"3 groups): {time.perf_counter() - t0:.2f} s on the host")
    t0 = time.perf_counter()
    generate.main(["--rawdata_path", raw, "--data_save_path", data])
    gen_s = time.perf_counter() - t0
    if not native_available():
        raise AssertionError("generate ran without the native rasterizer")
    parsed = load_design_npz(os.path.join(data, f"{CLI_DESIGN}.npz"))
    graph = pack_design(parsed, map_size=MAP_SIZE, device=dev).graph
    log(f"phase 7: generate: {gen_s:.2f} s on the host (native rasterizer); "
        f"{int(parsed['num_nodes'])} pins, {graph.num_pairs} level pairs, "
        f"{parsed['num_paths']} paths, raster "
        f"{tuple(parsed['cnn_input'].shape)}  [{smi}]")
    del graph
    torch.cuda.empty_cache()

    args = ["--data_save_path", data, "--model_saving_dir", mdl,
            "--num_epoch", "1"]
    for run in ("train CLI", "train CLI resume"):
        launches[run] = cli_train(torch, args, run, smi)[1]
    with open(os.path.join(mdl, "stdout.log")) as f:
        log_text = f.read()
    with open(os.path.join(mdl, "seed.txt")) as f:
        seeds = f.read()
    if ("Loading the model and hyper-parameters" not in log_text
            or "Saving model" not in log_text or seeds != "9294" * 2):
        raise AssertionError(f"the second train CLI run did not resume "
                             f"(seed.txt {seeds!r})")
    test_args = ["--data_save_path", data, "--model_saving_dir", mdl]
    card = cli_test(torch, test_args, DEVICE, "test CLI", smi)
    launches["test CLI"] = card["counts"]
    cpu = cli_test(torch, test_args, "cpu", "test CLI", smi)
    arrival = np.asarray(parsed["arrival_time"])[np.asarray(
        parsed["path_endpoint"], np.int64)]
    if not np.ptp(arrival):
        # every path has the same arc count, so every arrival time is
        # equal: R2 divides by SS_tot, a float32 rounding residue of the
        # mean that depends on the order of the sum
        log(f"  R2 not compared: all {arrival.size} arrival times are "
            f"{arrival[0]}, so SS_tot is a rounding residue")
    compare_test_clis(np, "test CLI", card, cpu, data, "reg")
    return launches


def corpus_runs(torch, np, smi, tmp) -> dict:
    """Phase 7, ``generate_corpus`` corpora (CORPUS_DESIGNS, CORPUS_PATHS
    paths and CORPUS_DEPTH stages and more per design, a third of the
    paths critical, depths varying across and within designs): the
    default 2 x 512 x 512 rasters and, for the U-Net, 3 x UNET_HW x
    UNET_HW. For each of ``reg`` (the default flags), ``cls`` (``--task
    cls --nlabels 2``), ``unet`` (``--unet``), ``attn`` (``--attn
    --num_heads 2``), ``merged`` (``--merge_designs``: the corpus's
    designs trained as one super-graph) and ``bf16`` (``--compute_dtype
    bfloat16``, whose train steps, validations and test CLI take the
    padded scan's rounding; the last three on the default corpus): the
    train CLI
    at full width on the card
    for CORPUS_EPOCHS epochs, then the test CLI on the card and on the
    CPU from its checkpoint, compared by :func:`compare_test_clis`
    (``bf16`` against the same checkpoint's test CLI in float32 too).
    ``cls`` must save the best-F1 model and write no ``visual/`` or
    ``predict_critical/``. Returns each run's launch counts."""
    from prtp_tpu_torch.data import generate, synthetic

    launches, data = {}, {}
    for corpus, extra in (("corpus", []),
                          ("corpus_unet", ["--cnn_channels",
                                           str(UNET_CHANNELS), "--cnn_hw",
                                           str(UNET_HW)])):
        raw, data[corpus] = (os.path.join(tmp, f"{corpus}_{d}")
                             for d in ("raw", "data"))
        t0 = time.perf_counter()
        synthetic.main(["--out", raw, "--designs", *CORPUS_DESIGNS,
                        "--num_paths", str(CORPUS_PATHS), "--depth",
                        str(CORPUS_DEPTH)] + extra)
        generate.main(["--rawdata_path", raw, "--data_save_path",
                       data[corpus]])
        log(f"phase 7: synthetic + generate {corpus} ({len(CORPUS_DESIGNS)} "
            f"designs, --num_paths {CORPUS_PATHS} --depth {CORPUS_DEPTH} "
            f"{' '.join(extra)}): {time.perf_counter() - t0:.2f} s on the "
            "host")
    runs = {"reg": ("corpus", []),
            "cls": ("corpus", ["--task", "cls", "--nlabels", "2"]),
            "unet": ("corpus_unet", ["--unet"]),
            "attn": ("corpus", ["--attn", "--num_heads", "2"]),
            "merged": ("corpus", ["--merge_designs"]),
            "bf16": ("corpus", ["--compute_dtype", "bfloat16"])}
    for name, (corpus, flags) in runs.items():
        mdl = os.path.join(tmp, f"mdl_{name}")
        common = ["--data_save_path", data[corpus], "--model_saving_dir",
                  mdl] + flags
        run = f"train CLI {name} corpus"
        state, launches[run], vals = cli_train(
            torch, common + ["--num_epoch", str(CORPUS_EPOCHS)], run, smi)
        run = f"test CLI {name} corpus"
        card = cli_test(torch, common, DEVICE, run, smi)
        launches[run] = card["counts"]
        cpu = cli_test(torch, common, "cpu", run, smi)
        task = "cls" if name == "cls" else "reg"
        f32 = None
        if name == "bf16":  # the bf16-trained checkpoint in float32
            f32 = cli_test(torch, common[:-2] + ["--compute_dtype",
                                                 "float32"],
                           DEVICE, f"{run} in float32", smi)
            launches[f"{run} in float32"] = f32["counts"]
        compare_test_clis(np, run, card, cpu, data[corpus], task, f32)
        if name != "cls":
            continue
        f1s, best, saves = [v[1] for v in vals], 0.0, 0
        for f1 in f1s:
            if f1 > best:
                best, saves = f1, saves + 1
        with open(os.path.join(mdl, "stdout.log")) as f:
            printed = f.read().count("Saving model.... ")
        blob = torch.load(os.path.join(mdl, "model.pt"), weights_only=True)
        written = [d for d in ("visual", "predict_critical")
                   if os.path.exists(os.path.join(mdl, d))]
        if printed != saves or blob["best_f1"] != best or written:
            raise AssertionError(
                f"cls: validation F1s {f1s}: {saves} improvements but "
                f"{printed} saves; saved best_f1 {blob['best_f1']} against "
                f"{best}; wrote {written}")
        log(f"phase 7: cls: validation F1s {[round(f, 4) for f in f1s]}, "
            f"{saves} saves, the checkpoint holds the best ({best:.4f}); no"
            " visual/ or predict_critical/: ok")
    return launches


def cli_phase(torch, np, dev, smi) -> dict:
    """Phase 7: the user's four CLIs through the port, on the card, in a
    temporary directory, each run with TF32 on before it (the CLIs must
    compute in float32 themselves): the big stress design
    (:func:`big_design_runs`), then the ``generate_corpus`` corpora for
    reg, cls and the U-Net (:func:`corpus_runs`). Returns each CLI run's
    launch counts on the card."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="prtp_cli_") as tmp:
        launches = big_design_runs(torch, np, dev, smi, tmp)
        launches.update(corpus_runs(torch, np, smi, tmp))
    return launches


def time_variant(torch, model_cpu, design, dev, task, what, smi,
                 rounding="fused"):
    """Phase 8: one train step of a variant from a copy of ``model_cpu``
    at the bench's batch (all 597 headline paths), its walk in the bf16
    ``rounding``: device time (queue pre-filled) and as launched, the
    device's busy and idle share and launches under torch.profiler, and
    its largest kernels by name."""
    import numpy as np
    from prtp_tpu_torch.trainer import (init_state, make_optimizer,
                                        pad_batch, train_step)

    state = init_state(copy.deepcopy(model_cpu), make_optimizer(LR), DEVICE)
    n = design.num_paths
    ids, mask = pad_batch(np.random.default_rng(0).permutation(n), n, dev)
    t = step_timing(torch, dev, lambda: train_step(state, design, ids, mask,
                                                   task, rounding), 200)
    log(f"phase 8: {what} train step ({n} paths): device time "
        f"{t['device_ms']:.3f} ms; as launched {t['launched_ms']:.3f} ms; "
        f"wall {t['wall_ms']:.3f} ms, device busy {t['busy_ms']:.3f} ms "
        f"(torch.profiler), idle share {t['idle']:.3f}; {t['launches']} "
        f"kernel launches  [{smi}]")
    for name, (tot, cnt) in sorted(t["by_name"].items(),
                                   key=lambda kv: -kv[1][0])[:10]:
        log(f"    {tot / 1e3:8.3f} ms  x{cnt:<4d} {name[:90]}")
    log_port_kernels(t["by_name"], f"{what} train step")


def time_unet(torch, unet_cpu, x, smi):
    """Phase 8: device time (CUDA events, queue pre-filled) of a U-Net
    forward in eval mode and of a forward + backward in train mode on
    ``x``, as launched too, and the kernels a forward launches."""
    unet = copy.deepcopy(unet_cpu).to(x.device)
    params = list(unet.parameters())
    cot = torch.randn((1, 1, x.shape[2] // 2, x.shape[3] // 2),
                      device=x.device)

    def fwd():
        with torch.no_grad():
            unet.eval()(x)

    def fwd_bwd():
        torch.autograd.grad(unet.train()(x), params, cot)

    timer = Timer(torch, x.device)
    for what, fn in (("forward (eval mode)", fwd),
                     ("forward + backward (train mode)", fwd_bwd)):
        dev_ms = timer.ms(fn, queue_ms=20)
        launched_ms = timer.ms(fn, queue_ms=0)
        by_name = device_kernels(torch, fn)
        log(f"phase 8: U-Net {what} on {tuple(x.shape)}: device time "
            f"{dev_ms:.3f} ms; as launched {launched_ms:.3f} ms; "
            f"{sum(c for _, c in by_name.values())} kernel launches  [{smi}]")
        for name, (tot, cnt) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0])[:6]:
            log(f"    {tot / 1e3:8.3f} ms  x{cnt:<4d} {name[:90]}")


def layoutnet_work(torch, cnn, x) -> tuple:
    """LayoutNet's forward + backward at raster ``x``: the operations
    (each conv's 2 x outputs x cin x k^2, once forward, once for the
    weight gradient and, above Conv_0, once for the input gradient: the
    raster needs none) and the bytes it must move (the raster, the
    weights and their gradients, the map's cotangent, each once)."""
    side, fwd, ops = x.shape[-1], [], 0.0
    for i in range(4):
        w = getattr(cnn, f"Conv_{i}").weight
        fwd.append(2.0 * side * side * w.numel())
        if i < 2:
            side //= 2
    ops = 3 * sum(fwd) - fwd[0]
    n_par = sum(p.numel() for p in cnn.parameters())
    nbytes = x.numel() * x.element_size() + n_par * 8 + side * side * 4
    return ops, nbytes, sum(fwd)


def precision_turns(torch, np, parsed, dev, smi):
    """Phase 8, ROADMAP 3d: the reg train step at the headline (all 597
    paths, flat Adam) in three precisions, in turns in one process:
    float32 with TF32 off (what the CLIs run), float32 with TF32 on for
    matmuls and cuDNN, and bf16 (``--compute_dtype bfloat16``, its
    design packed in bf16 as the train CLI packs it); then again in the
    other order. Each turn: the step's device time (queue pre-filled)
    and as launched, the device's idle share and launches
    (torch.profiler); LayoutNet's forward and forward + backward; the
    walk and its backward. Then LayoutNet's forward + backward bound in
    each precision (:func:`layoutnet_work`, the H100 SXM peaks)."""
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.trainer import (init_state, make_optimizer,
                                        pad_batch, train_step)

    modes = {"float32": (torch.float32, False), "tf32": (torch.float32, True),
             "bf16": (torch.bfloat16, False)}
    designs = {dt: pack_design(parsed, map_size=MAP_SIZE, device=dev,
                               compute_dtype=dt)
               for dt in (torch.float32, torch.bfloat16)}
    n = designs[torch.float32].num_paths
    ids, mask = pad_batch(np.random.default_rng(0).permutation(n), n, dev)
    states = {mode: init_state(PathModel(
        CELL_FEAT, NET_FEAT, map_size=MAP_SIZE, compute_dtype=dt,
        generator=torch.Generator().manual_seed(SEED)), make_optimizer(LR),
        DEVICE) for mode, (dt, _tf) in modes.items()}
    timer = Timer(torch, dev)
    fb_ms = {}
    try:
        for turn, mode in enumerate(list(modes) + list(reversed(modes))):
            dt, tf = modes[mode]
            torch.backends.cuda.matmul.allow_tf32 = tf
            torch.backends.cudnn.allow_tf32 = tf
            state, design = states[mode], designs[dt]
            model = state.model

            def step():
                train_step(state, design, ids, mask)

            dev_ms = timer.ms(step, queue_ms=200)
            launched_ms = timer.ms(step, queue_ms=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            by_name = device_kernels(torch, step)
            busy_ms = sum(t for t, _ in by_name.values()) / 1e3
            cnn_params = list(model.cnn.parameters())
            out = model.cnn(design.cnn_input)
            cot = torch.randn(out.shape, device=dev).to(out.dtype)
            gnn_params = list(model.gnn.parameters())
            hf = model.gnn(design.graph)
            g = torch.randn_like(hf)
            with torch.no_grad():
                cnn_ms = timer.ms(lambda: model.cnn(design.cnn_input),
                                  queue_ms=20)
                walk_ms = timer.ms(lambda: model.gnn(design.graph),
                                   queue_ms=50)
            fb = timer.ms(lambda: torch.autograd.grad(
                model.cnn(design.cnn_input), cnn_params, cot), queue_ms=20)
            fb_ms.setdefault(mode, []).append(fb)
            bwd_ms = timer.ms(lambda: torch.autograd.grad(
                hf, gnn_params, g, retain_graph=True), queue_ms=100)
            del hf, g, out
            log(f"phase 8: precision turn {turn}, {mode}: reg train step "
                f"({n} paths) device time {dev_ms:.3f} ms; as launched "
                f"{launched_ms:.3f} ms; wall {wall_ms:.3f} ms, device busy "
                f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
                f"{sum(c for _, c in by_name.values())} kernel launches; "
                f"LayoutNet forward {cnn_ms:.3f} ms, forward + backward "
                f"{fb:.3f} ms; walk {walk_ms:.3f} ms, walk backward "
                f"{bwd_ms:.3f} ms  [{smi}]")
            for name, (tot, cnt) in sorted(by_name.items(),
                                           key=lambda kv: -kv[1][0])[:6]:
                log(f"    {tot / 1e3:8.3f} ms  x{cnt:<4d} {name[:90]}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    x = designs[torch.bfloat16].cnn_input
    ops, nbytes, fwd = layoutnet_work(torch, states["bf16"].model.cnn, x)
    for mode, rate in (("bf16", BF16_OPS_PER_S), ("tf32", TF32_OPS_PER_S),
                       ("float32", F32_OPS_PER_S)):
        b_ms, by = bound(nbytes, ops, rate)
        log(f"phase 8: LayoutNet forward + backward, {mode}: "
            f"{ops / 1e9:.2f} GFLOP (forward {fwd / 1e9:.2f}), bound "
            f"{b_ms:.4f} ms ({by}); measured "
            + ", ".join(f"{ms:.3f}" for ms in fb_ms[mode])
            + f" ms: {b_ms / min(fb_ms[mode]):.1%} of the bound  [{smi}]")


def variants_phase(torch, np, dev, smi, headline, sizes) -> dict:
    """Phase 8: the variants at the default model's full width, TF32
    off: ``cls`` (``nlabels=2``) on the headline design, the U-Net on
    the headline graph with a 3 x UNET_HW x UNET_HW raster (map 128),
    ``attn`` (``--attn``, one head: the recorded ``reg_fusion_attn``) and
    ``attn4`` (four heads) on the headline design. For each: REQUESTS
    evaluation requests and the epoch of phase 6 (batches of
    TRAIN_BATCH, numpy seed EPOCH_SEED, :func:`paired_steps`; ``attn4``
    its first SHORT_STEPS steps), card against CPU with the launch
    counters as :func:`serve` holds them (``--attn``: ``attn_sum`` and
    ``attn_bwd`` in place of ``softmax_sum`` and ``softmax_sum_bwd``) and
    phase 6's tolerances (:func:`compare_runs`, ``fc_attn2``'s gradient
    among the leaves, the U-Net's max pools counted as LayoutNet's
    are). For the U-Net also its first-step
    gradients against float64 (:func:`unet_f32_error`), its BatchNorm
    running averages card against CPU (:func:`check_running_averages`),
    and an evaluation in eval mode of the CPU's trained weights and
    averages on both (1e-4). Then the timings of every variant
    (:func:`time_variant`, :func:`time_unet`). Returns each run's launch
    counts."""
    from prtp_tpu_torch.data.random_design import make_random_design
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.test import evaluate_design
    from prtp_tpu_torch.trainer import iterate_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    unet_design = make_random_design(
        sizes, cell_feat_dim=CELL_FEAT, net_feat_dim=NET_FEAT,
        map_size=MAP_SIZE, cnn_channels=UNET_CHANNELS, cnn_hw=UNET_HW,
        mask_nnz_per_path=MASK_NNZ, seed=SEED)
    for key in ("cell_edges", "net_edges"):
        if not all(np.array_equal(a, b) for a, b in
                   zip(unet_design[key], headline[key])):
            raise AssertionError("the U-Net design's graph is not the "
                                 "headline's")
    variants = {
        "cls": (dict(nlabels=2), "cls", headline, LAYOUTNET_POOLS),
        "unet": (dict(unet=True, cnn_channels=UNET_CHANNELS), "reg",
                 unet_design, UNET_POOLS),
        "attn": (dict(flag_attn=True, num_heads=1), "reg", headline,
                 LAYOUTNET_POOLS),
        "attn4": (dict(flag_attn=True, num_heads=4), "reg", headline,
                  LAYOUTNET_POOLS),
        "bf16": (dict(compute_dtype=torch.bfloat16), "reg", headline,
                 LAYOUTNET_POOLS),
        "bf16_unet": (dict(unet=True, cnn_channels=UNET_CHANNELS,
                           compute_dtype=torch.bfloat16), "reg", unet_design,
                      UNET_POOLS),
        "bf16_attn": (dict(flag_attn=True, num_heads=1,
                           compute_dtype=torch.bfloat16), "reg", headline,
                      LAYOUTNET_POOLS),
        # JAX's default train steps: the padded scan's rounding, forward
        # and backward (the bf16 run above serves in it already)
        "bf16_scan": (dict(compute_dtype=torch.bfloat16), "reg", headline,
                      LAYOUTNET_POOLS),
    }
    rounding_of = {"bf16_scan": "scan"}
    launches = {}
    num_paths = int(headline["num_paths"])
    for name, (kw, task, parsed, pools) in variants.items():
        log(f"phase 8: {name}: full-width PathModel({kw}), task {task}, "
            f"raster {tuple(parsed['cnn_input'].shape)}, seed {SEED}")
        model_cpu = PathModel(CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
                              generator=torch.Generator().manual_seed(SEED),
                              **kw)
        attn = kw.get("flag_attn", False)
        low = "compute_dtype" in kw
        twin = None
        if low:  # the same weights in float32, on the card
            twin = PathModel(CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
                             **{k: v for k, v in kw.items()
                                if k != "compute_dtype"})
            twin.load_state_dict(model_cpu.state_dict())
            twin.to(dev)
        rounding = rounding_of.get(name, "fused")
        cpu_design = pack_design(parsed, map_size=MAP_SIZE, device="cpu")
        card_design = pack_design(parsed, map_size=MAP_SIZE, device=dev)
        graph = card_design.graph
        if name != "bf16_scan":
            launches[f"serve {name}"] = serve(
                torch, np, copy.deepcopy(model_cpu).to(dev), model_cpu,
                parsed, f"headline {name}",
                launches_per_forward(graph, attn), REQUESTS, task, attn,
                twin)
        flips = pool_winner_flips(torch, model_cpu.cnn, cpu_design.cnn_input,
                                  dev)
        if low:
            log(f"  {name}: max-pool windows whose winner differs, card vs "
                f"cpu, at the init: {flips} (the cpu's first step takes the "
                "card's values)")
            card, _d = card_layers(torch, np, model_cpu.cnn,
                                   cpu_design.cnn_input, dev)
            flips = dict.fromkeys(flips, 0)
        else:
            card, signs = card_branches(torch, model_cpu.cnn,
                                        cpu_design.cnn_input, dev)
            log(f"  {name}: max-pool windows whose winner differs, card vs "
                f"cpu, at the init: {flips}"
                + (f"; conv outputs whose sign differs: {signs}" if card
                   else ""))
        what = f"train {name} epoch"
        designs = {DEVICE: card_design, "cpu": cpu_design}
        batches = {where: list(iterate_batches(
            np.arange(num_paths), TRAIN_BATCH,
            np.random.default_rng(EPOCH_SEED), device=where))
            for where in designs}
        if name in ("attn4", "bf16_unet", "bf16_attn"):
            what = f"train {name}, the epoch's first {SHORT_STEPS} steps"
            batches = {where: b[:SHORT_STEPS] for where, b in batches.items()}
        if name == "bf16_scan":
            what = (f"train {name}, the epoch's first {SCAN_STEPS} steps "
                    "in the padded scan's rounding")
            batches = {where: b[:SCAN_STEPS] for where, b in batches.items()}
        f32_first = (float32_first_step(torch, twin, card_design,
                                        batches[DEVICE][0], task)
                     if low else None)
        runs = paired_steps(torch, model_cpu, designs, batches, what,
                            launches_per_step(graph, attn), task, attn, card,
                            rounding)
        launches[what] = runs[DEVICE][2]
        f32_err = None
        if name == "unet":
            f32_err = unet_f32_error(torch, model_cpu, cpu_design,
                                     batches["cpu"][0], task, dev)
            rel = {k: e / float(runs["cpu"][1][k].abs().max())
                   for k, e in f32_err.items()}
            log(f"  {what}: the U-Net's first-step float32 gradients "
                "against float64 (the larger of cpu and card), largest (x "
                "the leaf's max |g|): "
                + ", ".join(f"{k} {v:.3g}" for k, v in sorted(
                    rel.items(), key=lambda kv: -kv[1])[:5]))
        if low:
            compare_bf16_runs(torch, what, runs[DEVICE], runs["cpu"],
                              f32_first)
        else:
            compare_runs(torch, what, runs[DEVICE], runs["cpu"], flips, pools,
                         f32_err)
        if name in ("unet", "bf16_unet"):
            check_running_averages(torch, what, runs[DEVICE][3],
                                   runs["cpu"][3])
        if name == "unet":
            trained = {where: copy.deepcopy(model_cpu).to(where)
                       for where in designs}
            for model in trained.values():
                model.load_state_dict(runs["cpu"][4])
            p_card, _m = evaluate_design(trained[DEVICE], parsed, DEVICE)
            p_cpu, _m = evaluate_design(trained["cpu"], parsed, "cpu")
            np.testing.assert_allclose(
                p_card, p_cpu, rtol=1e-4, atol=1e-4,
                err_msg="U-Net eval mode after training")
            log(f"  {name}: eval mode on the trained running averages, card "
                f"vs cpu: within {float(np.abs(p_card - p_cpu).max()):.3g} "
                "(rtol/atol 1e-4): ok")
            # the float32 gradient error past the init: the same
            # measurement at the cpu's weights and averages after the epoch
            after = unet_f32_error(torch, trained["cpu"], cpu_design,
                                   batches["cpu"][-1], task, dev)
            grown = {k: e / float(runs["cpu"][1][k].abs().max())
                     for k, e in after.items()}
            log(f"  {name}: float32 gradient error against float64 after "
                f"{len(batches['cpu'])} steps, largest (x the leaf's max |g| "
                "at the init; at the init in brackets): " + ", ".join(
                    f"{k} {v:.3g} ({rel[k]:.3g})" for k, v in sorted(
                        grown.items(), key=lambda kv: -kv[1])[:5])
                + f"  [{smi}]")
            time_unet(torch, model_cpu.cnn, card_design.cnn_input, smi)
        if name not in ("bf16_unet", "bf16_attn"):
            time_variant(torch, model_cpu, card_design, dev, task, name, smi,
                         rounding)
        del runs, designs, card_design, cpu_design, twin
        torch.cuda.empty_cache()
    return launches

def merged_batch(np, merged, rows=MERGED_BATCH):
    """bench.py's merged batch (``build_merged_step``): for each design of
    the merged super-graph, the first ``rows`` ids of a numpy seed 0
    permutation of its universe, padded; ``(ids (K, rows), mask (K,
    rows))`` in numpy."""
    rng = np.random.default_rng(0)
    universes = merged["path_ids_per_design"]
    ids = np.zeros((len(universes), rows), np.int64)
    mask = np.zeros((len(universes), rows), np.float32)
    for i, uni in enumerate(universes):
        take = np.asarray(uni)[rng.permutation(len(uni))[:rows]]
        ids[i, :len(take)] = take
        mask[i, :len(take)] = 1.0
    return ids, mask


def merged_phase(torch, np, dev, smi) -> dict:
    """Phase 9: the merged super-graph (``--merge_designs``) at the
    default model's full width, TF32 off, on bench.py's merged point
    (MERGED_K designs of MERGED_NODES nodes, one super-graph packed as
    one design with its MERGED_K rasters stacked). Serving: REQUESTS
    grouped forwards of the bench's batch, card against CPU at rtol/atol
    1e-4, and each design's rows against that design packed alone on the
    card (1e-4). Training: MERGED_STEPS steps on grouped batches
    (``iterate_grouped_batches``, numpy seed EPOCH_SEED, an epoch a
    step), card against CPU by phase 6's rules (MAX_FLIPS a pool and
    raster). Timing: one merged step at the bench's batch against the
    MERGED_K single-design steps on the same designs and paths (device
    time, as launched, idle share, launches). The merged U-Net (MERGED_K
    rasters of 3 x UNET_HW x UNET_HW): SHORT_STEPS steps, each card step
    from the CPU's state, its BatchNorm statistics taken over the
    rasters together (running averages at STAT_RTOL, gradients by phase
    8's U-Net rule). One bf16 forward in the test CLI's rounding
    (``rounding="scan"``) by phase 8's bf16 bounds. Every run's launch
    counters are zeroed just before it and checked just after against
    the merged tables. Returns each run's launch counts."""
    from prtp_tpu_torch.data.random_design import (bench_level_sizes,
                                                   make_random_design)
    from prtp_tpu_torch.graph import merge_parsed_designs, pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.test import evaluate
    from prtp_tpu_torch.trainer import (init_state, iterate_grouped_batches,
                                        make_optimizer, pad_batch,
                                        train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    sizes = bench_level_sizes(MERGED_NODES, LEVELS, decay=DECAY)

    def build(**kw):
        parsed = [make_random_design(
            sizes, cell_feat_dim=CELL_FEAT, net_feat_dim=NET_FEAT,
            map_size=MAP_SIZE, mask_nnz_per_path=MASK_NNZ,
            seed=MERGED_SEED + i, **kw) for i in range(MERGED_K)]
        merged = merge_parsed_designs(parsed)
        return parsed, merged, {where: pack_design(merged, map_size=MAP_SIZE,
                                                   device=where)
                                for where in ("cpu", DEVICE)}

    t0 = time.perf_counter()
    parsed, merged, packs = build(cnn_hw=CNN_HW)
    graph = packs[DEVICE].graph
    log(f"phase 9: merged super-graph of {MERGED_K} designs of "
        f"{sum(sizes)} nodes ({LEVELS} levels, seeds {MERGED_SEED}-"
        f"{MERGED_SEED + MERGED_K - 1}): {merged['num_nodes']} nodes, "
        f"{graph.num_pairs} level pairs, {merged['num_paths']} paths, "
        f"rasters {tuple(packs['cpu'].cnn_input.shape)}; built, merged and "
        f"packed in {time.perf_counter() - t0:.2f} s")
    ids_np, mask_np = merged_batch(np, merged)
    batch = {where: (torch.from_numpy(ids_np).to(where),
                     torch.from_numpy(mask_np).to(where)) for where in packs}
    model_cpu = PathModel(CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
                          generator=torch.Generator().manual_seed(SEED))
    model = copy.deepcopy(model_cpu).to(dev)
    per_forward, per_step = launches_per_forward(graph), launches_per_step(
        graph)
    launches = {}

    # ---- serving ----
    torch.cuda.synchronize()
    _zero_launches()
    outs = []
    for req in range(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, mets = evaluate(model, packs[DEVICE], *batch[DEVICE])
        outs.append(preds.cpu().numpy())
        log(f"  merged request {req}: wall "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms  loss "
            f"{float(mets['loss']):.6f}  r2 {float(mets['r2']):.6f}")
    launches["serve merged"] = _read_launches()
    check_launches("serve merged", launches["serve merged"], per_forward,
                   REQUESTS)
    want, _m = evaluate(model_cpu, packs["cpu"], *batch["cpu"])
    for req, got in enumerate(outs):
        if got.shape != ids_np.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"merged request {req}: bad predictions "
                                 f"{got.shape}")
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=f"merged request {req} vs cpu")
    log(f"  merged requests vs cpu: max abs diff "
        f"{max(float(np.abs(o - want.numpy()).max()) for o in outs):.3g} "
        "(rtol/atol 1e-4): ok")
    off = np.cumsum([0] + [int(p["num_paths"]) for p in parsed])
    singles, worst = [], 0.0
    for k, p in enumerate(parsed):
        valid = mask_np[k] > 0
        alone = pack_design(p, map_size=MAP_SIZE, device=dev)
        ids_k, mask_k = pad_batch(ids_np[k][valid] - off[k],
                                  ids_np.shape[1], dev)
        singles.append((alone, ids_k, mask_k))
        one = evaluate(model, alone, ids_k, mask_k)[0].cpu().numpy()
        np.testing.assert_allclose(outs[0][k][valid], one[:valid.sum()],
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"merged design {k} vs alone")
        worst = max(worst, float(np.abs(outs[0][k][valid]
                                        - one[:valid.sum()]).max()))
    log(f"  each design's rows of the merged forward vs the design packed "
        f"alone, on the card: max abs diff {worst:.3g} (rtol/atol 1e-4): ok")

    # ---- training ----
    what = f"train merged, {MERGED_STEPS} steps"
    rng = np.random.default_rng(EPOCH_SEED)
    rounds = [r for _ in range(MERGED_STEPS) for r in iterate_grouped_batches(
        merged["path_ids_per_design"], MERGED_BATCH, rng, "cpu")]
    if len(rounds) != MERGED_STEPS:
        raise AssertionError(f"{what}: {len(rounds)} rounds, one an epoch "
                             "expected")
    flips = pool_winner_flips(torch, model_cpu.cnn, packs["cpu"].cnn_input,
                              dev)
    cards, signs = card_branches(torch, model_cpu.cnn,
                                 packs["cpu"].cnn_input, dev)
    log(f"  merged LayoutNet at the init, card vs cpu: max-pool windows "
        f"whose winner differs {flips}; conv outputs whose sign differs "
        f"{signs}")
    card = train_run(torch, init_state(copy.deepcopy(model_cpu),
                                       make_optimizer(LR), DEVICE),
                     packs[DEVICE], [(i.to(dev), m.to(dev))
                                     for i, m in rounds], what, per_step)
    launches[what] = card[2]
    cpu = train_run(torch, init_state(copy.deepcopy(model_cpu),
                                      make_optimizer(LR), "cpu"),
                    packs["cpu"], rounds, what, card=cards)
    compare_runs(torch, what, card, cpu, flips, rasters=MERGED_K)
    del card, cpu, cards

    # ---- timing: one merged step against the single-design steps ----
    state = init_state(copy.deepcopy(model_cpu), make_optimizer(LR), DEVICE)
    runs = {
        "one merged step": step_timing(
            torch, dev, lambda: train_step(state, packs[DEVICE],
                                           *batch[DEVICE]), 300),
        f"{MERGED_K} single-design steps": step_timing(
            torch, dev, lambda: [train_step(state, *one) for one in singles],
            1500),
    }
    for name, t in runs.items():
        log(f"phase 9: {name} ({MERGED_K} x {MERGED_BATCH} ids, "
            f"{int(mask_np.sum())} valid): device time "
            f"{t['device_ms']:.3f} ms; as launched {t['launched_ms']:.3f} "
            f"ms; wall {t['wall_ms']:.3f} ms, device busy {t['busy_ms']:.3f}"
            f" ms (torch.profiler), idle share {t['idle']:.3f}; "
            f"{t['launches']} kernel launches  [{smi}]")
        for kname, (tot, cnt) in sorted(t["by_name"].items(),
                                        key=lambda kv: -kv[1][0])[:6]:
            log(f"    {tot / 1e3:8.3f} ms  x{cnt:<4d} {kname[:90]}")
        log_port_kernels(t["by_name"], name)
    # the launch queue holds about 1,000 launches, so a call of more does
    # not fit the pre-filled queue: its timed device time holds host time,
    # and the profiler's busy time is its device work
    a, b = runs.values()
    log(f"phase 9: merged step / {MERGED_K} single steps: device busy "
        f"{a['busy_ms'] / b['busy_ms']:.3f}, as launched "
        f"{a['launched_ms'] / b['launched_ms']:.3f}, launches "
        f"{a['launches'] / b['launches']:.3f}  [{smi}]")
    shared = {"parsed": parsed, "ids": ids_np, "mask": mask_np,
              "rounds": rounds, "timing": {
                  name: {k: v for k, v in t.items() if k != "by_name"}
                  for name, t in runs.items()}}
    del state, runs, singles

    # ---- bf16: one forward in the test CLI's rounding ----
    low = PathModel(CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
                    compute_dtype=torch.bfloat16)
    low.load_state_dict(model_cpu.state_dict())
    low_card = copy.deepcopy(low).to(dev)
    torch.cuda.synchronize()
    _zero_launches()
    got = evaluate(low_card, packs[DEVICE], *batch[DEVICE],
                   rounding="scan")[0].cpu().numpy()
    launches["serve merged bf16"] = _read_launches()
    check_launches("serve merged bf16", launches["serve merged bf16"],
                   per_forward, 1)
    check_bf16(np, "merged bf16 forward (rounding scan)", got,
               evaluate(low, packs["cpu"], *batch["cpu"],
                        rounding="scan")[0].numpy(),
               evaluate(model, packs[DEVICE], *batch[DEVICE])[0]
               .cpu().numpy())
    del low, low_card, model, packs, graph
    torch.cuda.empty_cache()

    # ---- the merged U-Net ----
    t0 = time.perf_counter()
    parsed_u, merged_u, packs_u = build(cnn_channels=UNET_CHANNELS,
                                        cnn_hw=UNET_HW)
    if not all(np.array_equal(a, b) for a, b in zip(
            merged_u["cell_edges"], merged["cell_edges"])):
        raise AssertionError("the merged U-Net's graph is not the merged "
                             "design's")
    unet_cpu = PathModel(CELL_FEAT, NET_FEAT, map_size=MAP_SIZE, unet=True,
                         cnn_channels=UNET_CHANNELS,
                         generator=torch.Generator().manual_seed(SEED))
    what = f"train merged U-Net, {SHORT_STEPS} steps"
    log(f"phase 9: merged U-Net, rasters "
        f"{tuple(packs_u['cpu'].cnn_input.shape)}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    flips = pool_winner_flips(torch, unet_cpu.cnn, packs_u["cpu"].cnn_input,
                              dev)
    log(f"  merged U-Net at the init: max-pool windows whose winner differs, "
        f"card vs cpu: {flips}")
    batches = {where: [(i.to(where), m.to(where))
                       for i, m in rounds[:SHORT_STEPS]] for where in packs_u}
    runs = paired_steps(torch, unet_cpu, packs_u, batches, what,
                        launches_per_step(packs_u[DEVICE].graph), "reg")
    launches[what] = runs[DEVICE][2]
    f32_err = unet_f32_error(torch, unet_cpu, packs_u["cpu"],
                             batches["cpu"][0], "reg", dev)
    compare_runs(torch, what, runs[DEVICE], runs["cpu"], flips, UNET_POOLS,
                 f32_err, rasters=MERGED_K)
    check_running_averages(torch, what, runs[DEVICE][3], runs["cpu"][3])
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    return launches, shared


def _host_ms(torch, fn, reps):
    """Median host wall time (ms) of ``fn`` between two synchronizes,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dp_rank(rank, tmp, port):
    """Phase 10 (b), one of DP_RANKS processes on cuda:0, joined over
    gloo: the headline model from the parent's state before each step,
    DP_STEPS data-parallel steps on its 299 of the 598 padded ids (in the
    CLIs' deterministic scope, as the parent's); then one step timed, and
    the gradient broadcast alone. Writes its losses, parameter checksums,
    first-step gradients (rank 0), launch counts and times to
    ``rank<r>.pt`` in ``tmp``."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.parallel import Mesh
    from prtp_tpu_torch.parallel.dp import broadcast_state, dp_train_step
    from prtp_tpu_torch.train import use_deterministic
    from prtp_tpu_torch.trainer import init_state, make_optimizer, pad_batch

    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = contextlib.ExitStack()
    deterministic.enter_context(use_deterministic())
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=DP_RANKS, rank=rank)
    try:
        mesh = Mesh.of_group()
        with open(os.path.join(tmp, "headline.pkl"), "rb") as f:
            parsed = pickle.load(f)
        snaps = torch.load(os.path.join(tmp, "ref_states.pt"),
                           weights_only=True)
        design = pack_design(parsed, map_size=MAP_SIZE, device=dev)
        n = design.num_paths
        state = init_state(PathModel(
            CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
            generator=torch.Generator().manual_seed(SEED)),
            make_optimizer(LR), dev)
        broadcast_state(state, mesh)
        ids, mask = pad_batch(np.random.default_rng(0).permutation(n), n,
                              dev)
        out = {"losses": [], "checksums": [], "grads": None}
        torch.cuda.synchronize()
        _zero_launches()
        for t in range(DP_STEPS):
            _state_restore(state, (snaps["model"][t], snaps["opt"][t]))
            out["losses"].append(float(
                dp_train_step(state, design, ids, mask, mesh)["loss"]))
            out["checksums"].append(
                float(state.optimizer.flat.double().abs().sum()))
            if t == 0 and rank == 0:
                out["grads"] = _grads(state)
        torch.cuda.synchronize()
        out["counts"] = _read_launches()
        # F4: the first step of the same weights in bf16, in the padded
        # scan's rounding (the --dp train CLI's)
        low = init_state(PathModel(
            CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
            compute_dtype=torch.bfloat16), make_optimizer(LR), dev)
        _state_restore(low, (snaps["model"][0], snaps["opt"][0]))
        dp_train_step(low, pack_design(parsed, map_size=MAP_SIZE, device=dev,
                                       compute_dtype=torch.bfloat16),
                      ids, mask, mesh, rounding="scan")
        out["bf16_checksum"] = float(low.optimizer.flat.double().abs().sum())
        if rank == 0:
            out["bf16_grads"] = _grads(low)
        del low
        deterministic.close()
        out["step_ms"] = _host_ms(
            torch, lambda: dp_train_step(state, design, ids, mask, mesh), 3)
        buf = torch.ones(state.optimizer.grad.numel(), device=dev)
        out["allreduce_ms"] = _host_ms(
            torch, lambda: dist.broadcast(buf, 0, group=mesh.group), 5)
        out["allreduce_numel"] = buf.numel()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_cli_runs(torch, np, smi, tmp) -> dict:
    """Phase 10 (c): the reg corpus of phase 7, the train CLI and the
    test CLI without ``--dp`` and with it (one card: a rank of one, NCCL),
    each from a fresh model directory: the printed train-step and
    validation lines and the ``predict.txt`` rows must be the same, each
    number within a unit of its last printed digit plus DP_CLI_RTOL of
    its value. Returns the ``--dp`` runs' launch counts."""
    from prtp_tpu_torch.data import generate, synthetic

    raw, data = os.path.join(tmp, "raw"), os.path.join(tmp, "data")
    synthetic.main(["--out", raw, "--designs", *CORPUS_DESIGNS,
                    "--num_paths", str(CORPUS_PATHS), "--depth",
                    str(CORPUS_DEPTH)])
    generate.main(["--rawdata_path", raw, "--data_save_path", data])
    printed, rows, launches = {}, {}, {}
    for name, flags in (("single", []), ("dp", ["--dp"])):
        mdl = os.path.join(tmp, f"mdl_{name}")
        common = ["--data_save_path", data, "--model_saving_dir", mdl]
        run = f"train CLI {' '.join(flags) or 'without --dp'} reg corpus"
        _state, counts, _vals = cli_train(
            torch, common + ["--num_epoch", str(CORPUS_EPOCHS)] + flags,
            run, smi)
        run = f"test CLI {' '.join(flags) or 'without --dp'} reg corpus"
        out = cli_test(torch, common + flags, DEVICE, run, smi)
        if flags:
            launches["train CLI --dp reg corpus"] = counts
            launches["test CLI --dp reg corpus"] = out["counts"]
        with open(os.path.join(mdl, "stdout.log")) as f:
            printed[name] = [ln for ln in f.read().splitlines()
                             if ln.startswith(("e", "\tcase", "\toverall"))]
        with open(os.path.join(mdl, "predict.txt")) as f:
            rows[name] = f.read()
    # the same lines and numbers, each within one unit of its last
    # printed digit and DP_CLI_RTOL: on the card cuDNN's backward adds in
    # another order from run to run (phase 10 (a): gradients 1e-6 of max
    # |g| apart at equal losses), and an R2 near -1e4 printed with three
    # decimals shows float32's last bits
    text = {k: [_NUMBER.sub("#", ln) for ln in v + [rows[k]]]
            for k, v in printed.items()}
    nums = {k: np.array([float(x) for ln in v + [rows[k]]
                         for x in _NUMBER.findall(ln)])
            for k, v in printed.items()}
    off = np.abs(nums["dp"] - nums["single"]) if (
        text["dp"] == text["single"]) else np.array([np.inf])
    if not len(printed["dp"]) or (off > 1e-3 * (1 + 1e-6) + DP_CLI_RTOL
                                  * np.abs(nums["single"])).any():
        raise AssertionError(
            "phase 10 (c): the --dp CLIs printed other values: "
            f"{printed['dp'][:4]} ... / {printed['single'][:4]} ...; "
            f"predict.txt {rows['dp']!r} / {rows['single']!r}")
    log(f"phase 10 (c): train CLI and test CLI with --dp (1 card, NCCL): "
        f"{len(printed['dp'])} printed train and validation lines and the "
        f"predict.txt row {rows['dp'].strip()!r} equal the runs without it "
        f"within {float(off.max()):.3g} ({int((off > 0).sum())} of "
        f"{len(off)} numbers off; allowed 1e-3 + rtol {DP_CLI_RTOL}): ok")
    return launches


def check_f4(what, outs, ref16, ref32):
    """F4 on the card: the dp ranks' first bf16 step (``bf16_grads`` of
    rank 0, every rank's ``bf16_checksum`` equal) against ``train_step``'s
    on one rank (``ref16``), each leaf within F4_MEAN x its bf16-to-float32
    distance (from ``ref32``, the float32 first step of the same weights)
    in mean distance and within F4_MAX x its max |g|."""
    if any(o["bf16_checksum"] != outs[0]["bf16_checksum"] for o in outs):
        raise AssertionError(f"{what}: the ranks' parameters differ")
    worst_mean, worst_max = (0.0, ""), (0.0, "")
    for key, want in ref16.items():
        got = outs[0]["bf16_grads"][key]
        gap = float((want - ref32[key]).abs().mean())
        mean, top = float((got - want).abs().mean()), float(
            (got - want).abs().max())
        scale = float(want.abs().max()) or 1.0
        worst_mean = max(worst_mean, (mean / gap if gap else mean, key))
        worst_max = max(worst_max, (top / scale, key))
        if mean > F4_MEAN * gap or top > F4_MAX * scale:
            raise AssertionError(f"{what}: gradient of {key}: mean distance "
                                 f"{mean} ({mean / (gap or 1):.3g} x its bf16"
                                 f"-to-float32 {gap}), max {top / scale:.3g}"
                                 " x max |g|")
    log(f"  {what} vs train_step's: mean distance at most {worst_mean[0]:.3g}"
        f" x the leaf's bf16-to-float32 distance ({worst_mean[1]}; allowed "
        f"{F4_MEAN}), max at most {worst_max[0]:.3g} x max |g| "
        f"({worst_max[1]}; allowed {F4_MAX}); checksums equal: ok")


def dp_phase(torch, np, dev, smi, headline, compute_mode) -> dict:
    """Phase 10: data parallelism (``--dp``) at the default model's full
    width on the headline (all 597 paths a step), float32, TF32 off.

    The compared steps run in the CLIs' deterministic scope
    (``train.use_deterministic``): cuDNN's default weight gradients add
    in another order from call to call, by up to 1.1e-6 of Conv_0's max
    |g| between two equal steps (PR 12).
    (a) A process group of one rank, NCCL: DP_STEPS data-parallel steps
    (``parallel.dp.dp_train_step``), each from the state ``train_step``
    started its step from, against ``train_step``: losses at rtol DP_TOL
    and first-step gradients within DP_TOL x each leaf's max |g|; one dp
    step timed as phase 8 times a step (:func:`step_timing`), and the
    gradient broadcast (2,727,202 float32) alone.
    (b) DP_RANKS processes on cuda:0 over gloo (NCCL refuses two ranks on
    one card), :func:`dp_rank`: the 597 ids padded to 598, 299 a rank,
    each step from the one-rank run's state before it: losses at rtol
    DP_TOL_2, first-step gradients within DP_TOL_2 x each leaf's max |g|
    (both processes run the raster's forward with the same kernels on
    the same inputs, so no max-pool winner can differ), the ranks'
    parameter checksums equal after each step; each rank's step and the
    broadcast timed on the host. Not run, and said so, where the card's
    compute mode admits one process.
    (c) :func:`dp_cli_runs`.

    A speed-up over cards cannot be shown on one card; none is claimed.
    Returns the dp runs' launch counts (each rank's own in (b))."""
    import pickle
    import tempfile

    import torch.distributed as dist
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.parallel import Mesh
    from prtp_tpu_torch.parallel.distributed import free_port
    from prtp_tpu_torch.parallel.dp import dp_train_step
    from prtp_tpu_torch.train import use_deterministic
    from prtp_tpu_torch.trainer import (init_state, make_optimizer,
                                        pad_batch, train_step)

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the compared steps in the CLIs' deterministic scope: cuDNN's
    # default weight gradients add in another order from call to call
    # (1e-6 of Conv_0's max |g| apart between two equal steps)
    deterministic = contextlib.ExitStack()
    deterministic.enter_context(use_deterministic())
    design = pack_design(headline, map_size=MAP_SIZE, device=dev)
    n = design.num_paths
    ids, mask = pad_batch(np.random.default_rng(0).permutation(n), n, dev)

    def fresh():
        return init_state(PathModel(
            CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
            generator=torch.Generator().manual_seed(SEED)),
            make_optimizer(LR), dev)

    # the one-rank reference: train_step, its state before each step kept
    ref, snaps, ref_losses, ref_grads = fresh(), [], [], None
    for t in range(DP_STEPS):
        snaps.append(_state_snapshot(ref))
        ref_losses.append(float(train_step(ref, design, ids, mask)["loss"]))
        if t == 0:
            ref_grads = _grads(ref)
    # F4's reference: the first step of the same weights in bf16, in the
    # padded scan's rounding (the --dp train CLI's), on one rank
    low = init_state(PathModel(CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
                               compute_dtype=torch.bfloat16),
                     make_optimizer(LR), dev)
    _state_restore(low, snaps[0])
    train_step(low, pack_design(headline, map_size=MAP_SIZE, device=dev,
                                compute_dtype=torch.bfloat16), ids, mask,
               rounding="scan")
    ref16 = _grads(low)
    del low
    launches = {}

    def check(what, losses, grads, tol):
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        worst = (0.0, "")
        for key, want in ref_grads.items():
            scale = float(want.abs().max())
            diff = float((grads[key] - want).abs().max())
            worst = max(worst, (diff / scale if scale else diff, key))
            if diff > tol * scale:
                raise AssertionError(f"{what}: gradient of {key} differs by "
                                     f"{diff} (max |g| {scale}, allowed "
                                     f"{tol} x)")
        if rel > tol:
            raise AssertionError(f"{what}: losses {losses} against one "
                                 f"rank's {ref_losses}")
        log(f"  {what} vs train_step: losses {losses} within rtol {rel:.3g},"
            f" first-step gradients within {worst[0]:.3g} x the leaf's max "
            f"|g| ({worst[1]}; allowed {tol} each): ok")

    # ---- (a) one rank, NCCL ----
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = Mesh.of_group()
        state = fresh()
        what = f"phase 10 (a): dp, 1 rank (NCCL), {DP_STEPS} steps"
        losses, grads = [], None
        torch.cuda.synchronize()
        _zero_launches()
        for t in range(DP_STEPS):
            _state_restore(state, snaps[t])
            losses.append(float(dp_train_step(state, design, ids, mask,
                                              mesh)["loss"]))
            if t == 0:
                grads = _grads(state)
        torch.cuda.synchronize()
        launches[what] = _read_launches()
        check_launches(what, launches[what],
                       launches_per_step(design.graph), DP_STEPS)
        check(what, losses, grads, DP_TOL)
        deterministic.close()
        tm = step_timing(torch, dev, lambda: dp_train_step(
            state, design, ids, mask, mesh), 200)
        buf = torch.ones(state.optimizer.grad.numel(), device=dev)
        ar_ms = Timer(torch, dev).ms(lambda: dist.broadcast(buf, 0))
        log(f"phase 10 (a): dp step, 1 rank ({n} paths): device time "
            f"{tm['device_ms']:.3f} ms; as launched {tm['launched_ms']:.3f} "
            f"ms; wall {tm['wall_ms']:.3f} ms, device busy "
            f"{tm['busy_ms']:.3f} ms, idle share {tm['idle']:.3f}; "
            f"{tm['launches']} kernel launches; the {buf.numel():,} float32"
            f" gradient broadcast (NCCL, 1 rank) {ar_ms:.4f} ms  [{smi}]")
        del state, buf
    finally:
        dist.destroy_process_group()

    # ---- (b) two ranks on one card, gloo ----
    if "exclusive" in compute_mode.lower():
        log(f"phase 10 (b): the card's compute mode is {compute_mode}: it "
            "admits one process, so two ranks cannot share it; (b) not run")
    else:
        with tempfile.TemporaryDirectory(prefix="prtp_dp_") as tmp:
            with open(os.path.join(tmp, "headline.pkl"), "wb") as f:
                pickle.dump(headline, f)
            torch.save({"model": [s[0] for s in snaps],
                        "opt": [s[1] for s in snaps]},
                       os.path.join(tmp, "ref_states.pt"))
            t0 = time.perf_counter()
            torch.multiprocessing.start_processes(
                dp_rank, args=(tmp, free_port()), nprocs=DP_RANKS,
                join=True, start_method="spawn")
            wall = time.perf_counter() - t0
            outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                               weights_only=True) for r in range(DP_RANKS)]
        what = (f"phase 10 (b): dp, {DP_RANKS} ranks on {DEVICE} (gloo), "
                f"{DP_STEPS} steps")
        for r, out in enumerate(outs):
            launches[f"{what}, rank {r}"] = out["counts"]
            check_launches(f"{what}, rank {r}", out["counts"],
                           launches_per_step(design.graph), DP_STEPS)
        if any(o["checksums"] != outs[0]["checksums"]
               or o["losses"] != outs[0]["losses"] for o in outs):
            raise AssertionError(f"{what}: the ranks' parameters or losses "
                                 f"differ: {[o['checksums'] for o in outs]}")
        check(what, outs[0]["losses"], outs[0]["grads"], DP_TOL_2)
        log(f"  {what}: parameter checksums equal on every rank after each "
            f"step ({outs[0]['checksums']}); {wall:.1f} s with the "
            "processes' start")
        check_f4(f"phase 10 (b): F4, {DP_RANKS} ranks' first bf16 step",
                 outs, ref16, ref_grads)
        log(f"phase 10 (b): dp step, {DP_RANKS} ranks on one card, host "
            "time between synchronizes (median of 3): "
            + ", ".join(f"rank {r} {o['step_ms']:.3f} ms"
                        for r, o in enumerate(outs))
            + f"; the {outs[0]['allreduce_numel']:,} float32 gradient "
            "broadcast alone (gloo, through the host; median of 5): "
            + ", ".join(f"{o['allreduce_ms']:.3f}" for o in outs)
            + f" ms  [{smi}]")
    del design
    torch.cuda.empty_cache()

    # ---- (c) the CLIs ----
    with tempfile.TemporaryDirectory(prefix="prtp_dp_cli_") as tmp:
        launches.update(dp_cli_runs(torch, np, smi, tmp))
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    return launches


def launches_per_forward_segment(graph, attn=False) -> dict:
    """Each kernel's launches in one segment walk of ``graph``: the cell
    reduce (``segment_softmax_sum``, or ``segment_attn_sum`` with
    ``--attn``; the other 0 times) for pairs k > 0, the net reduce for
    every pair."""
    cell = graph.num_pairs - 1
    return {"segment_softmax_sum": 0 if attn else cell,
            "segment_attn_sum": cell if attn else 0,
            "segment_mean": graph.num_pairs}


def launches_per_step_segment(graph, sharded=False, attn=False) -> dict:
    """Each kernel's launches in one train step of the segment walk on
    ``graph``: the forward's, the cell cotangent for pairs k > 0
    (``segment_attn_bwd`` with ``--attn``: a rows call a pair and one
    reduce of ``fc_attn2``'s gradient a step), a ``mailbox_scatter`` for
    each level with edges (two under the edge-sharded step: into the
    compact buffer, then into dh) and one flat Adam update. The same in
    bf16: the walk's bf16 products are library GEMMs and its bias sums
    plain PyTorch ops."""
    p = graph.num_pairs
    scatters = sum((graph.net_src_rows[k].numel() > 0)
                   + (k > 0 and graph.cell_src_rows[k].numel() > 0)
                   for k in range(p))
    return {**launches_per_forward_segment(graph, attn),
            "segment_softmax_sum_bwd": 0 if attn else p - 1,
            "segment_attn_bwd": p - 1 + (p > 1) if attn else 0,
            "mailbox_scatter": scatters * (2 if sharded else 1),
            "flat_adam": 1}


def walk_allreduces(graph, nh=None) -> list:
    """The shapes of the edge-sharded walk's all-reduces over gp in one
    train step, in order: per pair the cell reduce's max and [den |
    numer] (k > 0; with ``--attn`` of ``nh`` heads the max and den per
    head) and the net sums; in the backward each level's compact
    source-row cotangents, and with ``--attn`` last ``fc_attn2``'s
    gradient. ``(op, rows, width)``."""
    stats = D if nh is None else nh
    out = []
    for k in range(graph.num_pairs):
        pn_c, pn_n = (graph.cell_feat_lvl[k].shape[0],
                      graph.net_feat_lvl[k].shape[0])
        if k > 0:
            out += [("max", pn_c, stats), ("sum", pn_c, stats + D)]
        out.append(("sum", pn_n, D))
    for k in reversed(range(graph.num_pairs)):
        for half in ("net", "cell"):
            u = getattr(graph, f"{half}_src_rows")[k].numel()
            if u and (half == "net" or k > 0):
                out.append(("sum", u, D))
    if nh is not None:
        out.append(("sum", nh, D))
    return out


def time_allreduces(torch, dist, shapes, dev, group, reps):
    """Host time (ms, median of ``reps``) of the step's all-reduces
    ``shapes`` (:func:`walk_allreduces`) in sequence, on fresh buffers."""
    bufs = [(op, torch.ones((r, w), device=dev)) for op, r, w in shapes]

    def run():
        for op, b in bufs:
            dist.all_reduce(b, op=(dist.ReduceOp.MAX if op == "max"
                                   else dist.ReduceOp.SUM), group=group)

    return _host_ms(torch, run, reps)


def check_segment_kernels(torch, F, graph, dev, timer) -> dict:
    """Phase 11 (a): the three kernels of the segment walk against their
    plain versions at the headline's shapes, each level's in turn, with a
    random state ``h``: ``segment_softmax_sum`` whole (the main path)
    and ``partial`` (an edge-sharded rank's), ``segment_mean`` (with and
    without counts), ``segment_softmax_sum_bwd`` recomputing (the main
    path) and reading the statistics (an edge-sharded rank's), and the
    backward's ``mailbox_scatter`` calls (a cell level's per-edge
    cotangent, a net level's per-slot one over its counts), each at rtol
    1e-5, atol 1e-6. The partial call's numerator over its denominator
    (the combine at one rank) against the whole call's output, and the
    two backward modes against each other: bit-equal, or the largest
    difference logged. Bytes count what a call must move: each distinct
    source row and index once and the outputs (``partial`` also writes
    the shift and denominator, the stats-reading backward reads them and
    the output). Times: the median of REPS cold-L2 calls; library:
    ``F.embedding_bag`` (mode "mean") for ``segment_mean``,
    ``index_add_`` of prebuilt per-edge contributions for the scatter.
    Returns ``({name: KernelRecord} of the main path's modes, the
    scatter's KernelRecord, [KernelRecord] of the other modes)``."""
    from prtp_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    h = torch.randn((graph.num_rows + 1, D), generator=gen, device=dev)
    row_b = D * 4
    recs = {name: KernelRecord(name, "headline") for name in SEGMENT_KERNELS}
    scatter = KernelRecord("mailbox_scatter", "headline segment")
    partial_rec = KernelRecord("segment_softmax_sum", "headline, partial")
    stats_rec = KernelRecord("segment_softmax_sum_bwd",
                             "headline, stats-reading")
    recs["segment_mean"].design = "headline, update"
    mean_rec = KernelRecord("segment_mean", "headline, mean")
    sums_rec = KernelRecord("segment_mean", "headline, sums")
    composition = {"ms": 0.0, "launches": 0}

    def close(name, k, got, want):
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not (torch.allclose(got, want, rtol=1e-5, atol=1e-6)
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{name} differs at pair {k}: max abs err "
                                 f"{err}")
        return err

    def bits(a, b):
        """'bit-equal', or the largest difference and its count."""
        if torch.equal(a, b):
            return "bit-equal"
        return (f"{int((a != b).sum())} elements differ, by at most "
                f"{float((a - b).abs().max()):.3g}")

    for k in range(graph.num_pairs):
        # ---- the cell half (k > 0): forward, backward, scatter ----
        if k > 0:
            src, off = graph.cell_src[k], graph.cell_dst_off[k]
            s, e = off.shape[0] - 1, src.shape[0]
            rows = torch.unique(src).numel()
            out = K.segment_softmax_sum(h, src, off)[0]
            err = close("segment_softmax_sum", k, out,
                        K.segment_softmax_sum_plain(h, src, off)[0])
            stats = K.segment_softmax_sum(h, src, off, True)
            err_p = max(close("segment_softmax_sum (partial)", k, got, want)
                        for got, want in zip(stats, K.segment_softmax_sum_plain(
                            h, src, off, partial=True)))
            numer, mx, den = stats
            combined = bits(numer / den.clamp_min(1e-12), out)
            # read: the distinct rows, the edge table, the offsets
            nbytes = rows * row_b + e * 4 + (s + 1) * 4
            ops = 6.0 * e * D
            ms = timer.ms(lambda: K.segment_softmax_sum(h, src, off))
            ms_p = timer.ms(lambda: K.segment_softmax_sum(h, src, off, True))
            pms = timer.ms(lambda: K.segment_softmax_sum_plain(h, src, off))
            recs["segment_softmax_sum"].add(ms, pms, None,
                                            nbytes + s * row_b, ops, err)
            partial_rec.add(ms_p, pms, None, nbytes + 3 * s * row_b, ops,
                            err_p)
            log(f"  segment_softmax_sum pair {k}: {e} edges into {s} slots "
                f"of {D} f32  kernel {ms:.4f} ms (partial {ms_p:.4f})  plain "
                f"{pms:.4f}  bound {bound(nbytes + s * row_b, ops)[0]:.4f} "
                f"(partial {bound(nbytes + 3 * s * row_b, ops)[0]:.4f})  max "
                f"abs err {err:.3g} (partial {err_p:.3g}); partial numerator "
                f"over its denominator vs the whole output: {combined}")
            g = torch.randn((s, D), generator=gen, device=dev)
            stats = (out, mx, den)
            d_msg = K.segment_softmax_sum_bwd(h, src, off, g)
            d_st = K.segment_softmax_sum_bwd(h, src, off, g, stats)
            # both against the plain version on the forward kernel's
            # statistics (which match the plain forward's above): a
            # recomputed out off by an ulp moves (1 + x) - out by more
            # than rtol where the two nearly cancel
            want = K.segment_softmax_sum_bwd_plain(h, src, off, g, stats)
            err = close("segment_softmax_sum_bwd", k, d_msg, want)
            err_s = close("segment_softmax_sum_bwd (stats-reading)", k, d_st,
                          want)
            err_r = float((d_msg - K.segment_softmax_sum_bwd_plain(
                h, src, off, g)).abs().max())
            modes = bits(d_msg, d_st)
            # read the distinct rows, the tables and g; write the (E, D)
            # cotangent; stats-reading also reads out, mx and den
            nbytes = (rows * row_b + e * 4 + (s + 1) * 4 + s * row_b
                      + e * row_b)
            ms = timer.ms(lambda: K.segment_softmax_sum_bwd(h, src, off, g))
            ms_s = timer.ms(lambda: K.segment_softmax_sum_bwd(h, src, off, g,
                                                              stats))
            pms = timer.ms(lambda: K.segment_softmax_sum_bwd_plain(
                h, src, off, g))
            recs["segment_softmax_sum_bwd"].add(ms, pms, None, nbytes,
                                                14.0 * e * D, err)
            stats_rec.add(ms_s, pms, None, nbytes + 3 * s * row_b,
                          8.0 * e * D, err_s)
            log(f"  segment_softmax_sum_bwd pair {k}: {e} edges  kernel "
                f"{ms:.4f} ms (stats-reading {ms_s:.4f})  plain {pms:.4f}  "
                f"bound {bound(nbytes, 14.0 * e * D)[0]:.4f} (stats-reading "
                f"{bound(nbytes + 3 * s * row_b, 8.0 * e * D)[0]:.4f})  max "
                f"abs err {err:.3g} (stats-reading {err_s:.3g}; against the "
                f"plain version recomputing too {err_r:.3g}); recomputing vs "
                f"stats-reading: {modes}")
            check_segment_scatter(torch, scatter, k, "cell", graph, h, d_msg,
                                  None, timer, close)
        # ---- the net half (every pair): the three modes, the scatter ----
        src, off = graph.net_src[k], graph.net_dst_off[k]
        cnt, has_in = graph.net_cnt[k], graph.net_has_in[k]
        n0 = graph.net_off[k]
        s, e = off.shape[0] - 1, src.shape[0]
        err_s = close("segment_mean (sums)", k, K.segment_mean(h, src, off,
                                                              None),
                      K.segment_mean_plain(h, src, off, None))
        mean = K.segment_mean(h, src, off, cnt)
        err = close("segment_mean (mean)", k, mean,
                    K.segment_mean_plain(h, src, off, cnt))
        src_l, off_l = src.long(), off[:-1].long()
        lib = F.embedding_bag(src_l, h, off_l, mode="mean")
        close("segment_mean (embedding_bag)", k, lib, mean)
        pre = torch.randn((s, D), generator=gen, device=dev)
        err_u, cases = check_net_update(torch, K, gen, k, h, src, off, cnt,
                                        pre, has_in, n0, close)
        # read: the distinct rows, the edge table, the offsets (and the
        # counts); write the (S, D) result. The update mode reads pre and
        # has_in, the old rows of the slots without in-edges, and only
        # the sources of the others
        read = torch.unique(src).numel() * row_b + e * 4 + (s + 1) * 4
        ops = float(e * D + s * D)
        nb = {"sums": read + s * row_b, "mean": read + s * 4 + s * row_b,
              "update": net_update_bytes(torch, src, off, has_in, s)}
        hu, hc = h.clone(), h.clone()
        ms = {
            "sums": timer.ms(lambda: K.segment_mean(h, src, off, None)),
            "mean": timer.ms(lambda: K.segment_mean(h, src, off, cnt)),
            "update": timer.ms(lambda: K.net_update(hu, src, off, cnt, pre,
                                                    has_in, n0)),
            "composition": timer.ms(lambda: K.net_epilogue(
                hc, pre, K.segment_mean(hc, src, off, cnt), has_in, n0))}
        pms = {
            "sums": timer.ms(lambda: K.segment_mean_plain(h, src, off, None)),
            "mean": timer.ms(lambda: K.segment_mean_plain(h, src, off, cnt)),
            "update": timer.ms(lambda: K.net_update_plain(
                hc, src, off, cnt, pre, has_in, n0))}
        lms = timer.ms(lambda: F.embedding_bag(src_l, h, off_l, mode="mean"))
        ops_u = float(e * D + 3 * s * D)  # the adds; div, add, relu a slot
        recs["segment_mean"].add(ms["update"], pms["update"], None,
                                 nb["update"], ops_u, err_u)
        sums_rec.add(ms["sums"], pms["sums"], None, nb["sums"], float(e * D),
                     err_s)
        mean_rec.add(ms["mean"], pms["mean"], lms, nb["mean"], ops, err)
        composition["ms"] += ms["composition"]
        composition["launches"] += 6 if has_in is not None else 4
        log(f"  segment_mean pair {k}: {e} edges into {s} slots  kernel "
            f"update {ms['update']:.4f} ms (the mean kernel and the five ops "
            f"it replaces {ms['composition']:.4f}), mean {ms['mean']:.4f}, "
            f"sums {ms['sums']:.4f}  plain {pms['update']:.4f} / "
            f"{pms['mean']:.4f} / {pms['sums']:.4f}  embedding_bag "
            f"{lms:.4f}  bound {bound(nb['update'], ops_u)[0]:.4f}"
            f" / {bound(nb['mean'], ops)[0]:.4f} / "
            f"{bound(nb['sums'], float(e * D))[0]:.4f}  max abs err "
            f"{err_u:.3g} / {err:.3g} / {err_s:.3g}; update vs the unfused "
            f"composition: {cases}")
        g_n = torch.randn((s, D), generator=gen, device=dev)
        check_segment_scatter(torch, scatter, k, "net", graph, h, g_n, cnt,
                              timer, close)
    log(f"  the net half's update: segment_mean's update mode "
        f"{recs['segment_mean'].ms:.4f} ms a pass in "
        f"{recs['segment_mean'].calls} launches; the mean kernel and the "
        f"five ops it replaces {composition['ms']:.4f} ms in "
        f"{composition['launches']} launches")
    return recs, scatter, [partial_rec, stats_rec, mean_rec, sums_rec]


def net_update_bytes(torch, src, off, has_in, s):
    """The bytes the update mode must move for one net level: the
    distinct sources of the slots with in-edges (``has_in``; every slot
    when None) and their edges, the offsets, counts and ``has_in``, pre
    read, and the (S, D) rows written; a slot without in-edges reads its
    old row instead."""
    row_b = D * 4
    slot = torch.repeat_interleave(
        torch.arange(s, device=src.device), (off[1:] - off[:-1]).long())
    take = (torch.ones(s, dtype=torch.bool, device=src.device)
            if has_in is None else has_in.reshape(-1))
    used = src[take[slot]]
    return (torch.unique(used).numel() * row_b + used.numel() * 4
            + (s + 1) * 4 + s * 4 + s + 2 * s * row_b
            + int((~take).sum()) * row_b)


def check_net_update(torch, K, gen, k, h, src, off, cnt, pre, has_in, n0,
                     close):
    """Phase 11 (a): ``segment_mean``'s update mode (``net_update``) at
    one net level against its plain version (rtol 1e-5, atol 1e-6) and,
    bit for bit, against the unfused composition it replaces on the card
    (the mean kernel, then the walk's five PyTorch ops:
    ``net_epilogue``), each on a copy of ``h``, in three cases: every
    slot with in-edges, a random third without, and ``dgl_parity`` off
    (no ``has_in``). Also the rows outside the level must be untouched.
    Returns the largest error against the plain version and a note."""
    s = off.shape[0] - 1
    third = torch.rand((s, 1), generator=gen, device=h.device) >= 1 / 3
    cases = {"has_in all true": torch.ones_like(has_in),
             "a third without in-edges": has_in & third,
             "dgl_parity off": None}
    err = 0.0
    for what, mask in cases.items():
        got, plain, comp = h.clone(), h.clone(), h.clone()
        K.net_update(got, src, off, cnt, pre, mask, n0)
        K.net_update_plain(plain, src, off, cnt, pre, mask, n0)
        K.net_epilogue(comp, pre, K.segment_mean(comp, src, off, cnt), mask,
                       n0)
        err = max(err, close(f"segment_mean (update, {what})", k,
                             got[n0: n0 + s], plain[n0: n0 + s]))
        if not same_bits(torch, got, comp):
            differ = int((got.view(torch.int32)
                          != comp.view(torch.int32)).sum())
            raise AssertionError(
                f"segment_mean (update, {what}) at pair {k}: {differ} "
                "elements' bits differ from the unfused composition")
    return err, f"bit-equal in {len(cases)} cases ({', '.join(cases)})"


def same_bits(torch, a, b) -> bool:
    """Whether two float32 tensors hold the same bits (NaN payloads and
    the sign of zero included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def segment_chain(torch, graph, dev, timer, per_call_ms, net_ms):
    """Phase 11 (a): the segment walk's kernel calls as the walk issues
    them, back to back, each after an elementwise kernel of CHAIN_ELEMS
    floats (as the MLP before it), no event between (where a
    programmatic launch overlaps the kernel before it): (1) the softmax
    pair: each pair's forward (whole), then each pair's backward
    (recomputing) in reverse; (2) the same with the net half: in each
    pair the cell forward (k > 0), then ``segment_mean``'s update mode
    (``net_update``), then the backwards. Each beside its elementwise
    kernels alone and its kernels' summed per-call times
    (``per_call_ms`` for the softmax pair, ``net_ms`` more with the net
    half)."""
    from prtp_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    h = torch.randn((graph.num_rows + 1, D), generator=gen, device=dev)
    cells = {k: (graph.cell_src[k], graph.cell_dst_off[k],
                 torch.randn((graph.cell_dst_off[k].shape[0] - 1, D),
                             generator=gen, device=dev))
             for k in range(1, graph.num_pairs)}
    nets = [(graph.net_src[k], graph.net_dst_off[k], graph.net_cnt[k],
             torch.randn((graph.net_cnt[k].shape[0], D), generator=gen,
                         device=dev), graph.net_has_in[k], graph.net_off[k])
            for k in range(graph.num_pairs)]
    y = torch.randn(CHAIN_ELEMS, generator=gen, device=dev)

    def chain(kernels=True, net=False):
        for k in range(graph.num_pairs):
            if k in cells:
                y.mul_(1.0)
                if kernels:
                    K.segment_softmax_sum(h, *cells[k][:2])
            if net:
                y.mul_(1.0)
                if kernels:
                    K.net_update(h, *nets[k])
        for src, off, g in reversed(cells.values()):
            y.mul_(1.0)
            if kernels:
                K.segment_softmax_sum_bwd(h, src, off, g)

    ms = timer.ms(chain, queue_ms=3)
    alone = timer.ms(lambda: chain(False), queue_ms=3)
    log(f"  the walk's {len(cells)} segment_softmax_sum and "
        f"{len(cells)} segment_softmax_sum_bwd calls, each after an "
        f"elementwise kernel, back to back: {ms:.4f} ms (the elementwise "
        f"kernels alone {alone:.4f}; the pair's per-call times summed "
        f"{per_call_ms:.4f})")
    ms = timer.ms(lambda: chain(net=True), queue_ms=3)
    alone = timer.ms(lambda: chain(False, True), queue_ms=3)
    log(f"  the same with the net half's {len(nets)} net_update calls "
        f"(segment_mean's update mode), each after an elementwise kernel: "
        f"{ms:.4f} ms (the elementwise kernels alone {alone:.4f}; the "
        f"per-call times summed {per_call_ms + net_ms:.4f})")


def degree_mixes(torch, graph, dev) -> dict:
    """``{mix: [(src, off) of each cell pair k > 0]}``: the headline's
    cell levels with their slots' degrees redrawn (empty slots stay
    empty) and every edge's source drawn anew from the level's distinct
    sources. The headline's slots have 1-4 edges; "5% at 5-8" gives a
    twentieth of them 5-8 edges (the many-input cells of a standard-cell
    library, AOI222 or OA33, among mostly 1-4 input ones), "1-8 uniform"
    every slot 1-8."""
    gen = torch.Generator().manual_seed(SEED + 23)
    mixes = {}
    for mix, share in (("5% at 5-8", 0.05), ("1-8 uniform", None)):
        levels = []
        for k in range(1, graph.num_pairs):
            src = graph.cell_src[k].cpu()
            off = graph.cell_dst_off[k].cpu()
            deg = (off[1:] - off[:-1]).long()
            if share is None:
                new = torch.randint(1, 9, deg.shape, generator=gen)
            else:
                new = deg.clone()
                pick = torch.rand(deg.shape, generator=gen) < share
                new[pick] = torch.randint(5, 9, (int(pick.sum()),),
                                          generator=gen)
            new[deg == 0] = 0
            pool = torch.unique(src)
            n_off = torch.zeros(deg.shape[0] + 1, dtype=torch.int32)
            n_off[1:] = new.cumsum(0)
            pick = torch.randint(0, pool.shape[0], (int(new.sum()),),
                                 generator=gen)
            levels.append((pool[pick].to(torch.int32).to(dev), n_off.to(dev)))
        mixes[mix] = levels
    return mixes


def check_segment_degree_mix(torch, graph, dev, timer, smi):
    """Phase 11 (a): the segment softmax pair on the headline's cell
    levels with slots of 5-8 edges mixed in (:func:`degree_mixes`), which
    take the kernels' generic path: the forward (whole) and the backward
    (recomputing), each against its plain version (rtol 1e-5, atol 1e-6;
    the backward on the kernel's statistics, as in
    :func:`check_segment_kernels`), timed (the median of REPS cold-L2
    calls) into ms a pass beside each kernel's bound."""
    from prtp_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    h = torch.randn((graph.num_rows + 1, D), generator=gen, device=dev)
    row_b = D * 4

    def close(what, got, want):
        if not (torch.allclose(got, want, rtol=1e-5, atol=1e-6)
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{what} differs from its plain version: "
                                 f"max abs err "
                                 f"{float((got - want).abs().max())}")

    for mix, levels in degree_mixes(torch, graph, dev).items():
        ms = {"fwd": 0.0, "bwd": 0.0}
        nbytes = {"fwd": 0, "bwd": 0}
        edges = slots = 0
        for src, off in levels:
            s, e = off.shape[0] - 1, src.shape[0]
            edges, slots = edges + e, slots + s
            g = torch.randn((s, D), generator=gen, device=dev)
            out = K.segment_softmax_sum(h, src, off)[0]
            close(f"segment_softmax_sum ({mix})", out,
                  K.segment_softmax_sum_plain(h, src, off)[0])
            _n, mx, den = K.segment_softmax_sum(h, src, off, True)
            close(f"segment_softmax_sum_bwd ({mix})",
                  K.segment_softmax_sum_bwd(h, src, off, g),
                  K.segment_softmax_sum_bwd_plain(h, src, off, g,
                                                  (out, mx, den)))
            ms["fwd"] += timer.ms(lambda: K.segment_softmax_sum(h, src, off))
            ms["bwd"] += timer.ms(
                lambda: K.segment_softmax_sum_bwd(h, src, off, g))
            read = torch.unique(src).numel() * row_b + e * 4 + (s + 1) * 4
            nbytes["fwd"] += read + s * row_b
            nbytes["bwd"] += read + s * row_b + e * row_b
        log(f"  degree mix {mix} ({edges} edges into {slots} slots over "
            f"{len(levels)} pairs): segment_softmax_sum {ms['fwd']:.4f} ms a "
            f"pass (bound {bound(nbytes['fwd'], 0.0)[0]:.4f}), "
            f"segment_softmax_sum_bwd {ms['bwd']:.4f} (bound "
            f"{bound(nbytes['bwd'], 0.0)[0]:.4f}); each matches its plain "
            f"version  [{smi}]")


def check_segment_scatter(torch, rec, k, half, graph, h, val, cnt, timer,
                          close):
    """Phase 11 (a): the segment walk's ``mailbox_scatter`` of one level
    (``segment_walk._scatter_add``) into a copy of ``h`` against the
    plain version; timed beside ``index_add_`` of the level's prebuilt
    per-edge contributions (dst-sorted, by source)."""
    from prtp_tpu_torch.ops import fused_gnn
    from prtp_tpu_torch.ops.segment_walk import _scatter_add

    rows, soff, pos = (getattr(graph, f"{half}_src_{x}")[k]
                       for x in ("rows", "off", "pos"))
    src = getattr(graph, f"{half}_src")[k]
    if rows.numel() == 0:
        return

    def plain(dest):
        if cnt is None:  # the per-edge cotangent as the cell rows
            fused_gnn.mailbox_scatter_plain(
                dest, rows, soff, pos, val, val.new_empty((0, D)),
                val.new_empty((0,)), 1, val.shape[0])
        else:
            fused_gnn.mailbox_scatter_plain(dest, rows, soff, pos, None, val,
                                            cnt, 1, 0)

    got, want = h.clone(), h.clone()
    _scatter_add(got, rows, soff, pos, val, cnt)
    plain(want)
    err = close("mailbox_scatter (segment)", k, got, want)
    if cnt is None:
        contrib = val  # one row an edge, dst-sorted
        read = pos.numel() * (D * 4 + 4)
    else:
        slot = getattr(graph, f"{half}_dst_slot")[k].long()
        contrib = val[slot] / cnt[slot][:, None]
        read = torch.unique(pos).numel() * (D * 4 + 4) + pos.numel() * 4
    lib_out, src_l = h.clone(), src.long()
    torch.testing.assert_close(lib_out.index_add_(0, src_l, contrib), got,
                               rtol=1e-5, atol=1e-5)
    nbytes = read + rows.numel() * (2 * D * 4 + 8) + 4
    ops = float(pos.numel() * D)
    ms = timer.ms(lambda: _scatter_add(got, rows, soff, pos, val, cnt))
    pms = timer.ms(lambda: plain(want))
    lms = timer.ms(lambda: lib_out.index_add_(0, src_l, contrib))
    rec.add(ms, pms, lms, nbytes, ops, err)
    log(f"  mailbox_scatter pair {k} {half}: {pos.numel()} edges into "
        f"{rows.numel()} rows  kernel {ms:.4f} ms  plain {pms:.4f}  "
        f"index_add_ {lms:.4f}  bound {bound(nbytes, ops)[0]:.4f}  max abs "
        f"err {err:.3g}")


def segment_floors(torch, graph, dev, timer) -> dict:
    """Each segment kernel, and the walk's ``mailbox_scatter``, timed on
    a one-slot call, keyed by name (the main path's mode) and, for the
    other modes of ``segment_mean``, by ``(name, design)`` as their
    records have it."""
    from prtp_tpu_torch.ops import segment_kernels as K
    from prtp_tpu_torch.ops.fused_gnn import mailbox_scatter

    h = torch.randn((graph.num_rows + 1, D), device=dev)
    src = graph.cell_src[1][:1]
    off = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    one = torch.ones(1, device=dev)
    row = torch.randn((1, D), device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    has_in = torch.ones((1, 1), dtype=torch.bool, device=dev)
    n0 = graph.net_off[graph.num_pairs - 1]
    return {
        "segment_softmax_sum": timer.ms(
            lambda: K.segment_softmax_sum(h, src, off)),
        "segment_mean": timer.ms(
            lambda: K.net_update(h, src, off, one, row, has_in, n0)),
        ("segment_mean", "headline, mean"): timer.ms(
            lambda: K.segment_mean(h, src, off, one)),
        ("segment_mean", "headline, sums"): timer.ms(
            lambda: K.segment_mean(h, src, off, None)),
        "segment_softmax_sum_bwd": timer.ms(
            lambda: K.segment_softmax_sum_bwd(h, src, off, row)),
        "mailbox_scatter": timer.ms(
            lambda: mailbox_scatter(h, zero, off, zero, None, row, one, 1, 0)),
    }


def check_segment_edge_shapes(torch, dev):
    """Phase 11 (a): the segment walk's kernels on the code paths the
    headline does not reach, against their plain versions (rtol 1e-5,
    atol 1e-6, NaN where the plain version has it):
    ``segment_softmax_sum`` whole and ``partial``,
    ``segment_softmax_sum_bwd`` recomputing and stats-reading (the
    statistics of the kernel's own partial call), and ``segment_mean``'s
    three modes (sums, mean, and the update of a net level held in h's
    last rows, with a random third of the slots without in-edges and
    with ``dgl_parity`` off; :func:`check_segment_mean_shape` gives its
    tolerance and the order it is held to bit for bit), on empty slots,
    slots of 1-9 and 33 edges
    (above 4: the generic path, 4 rows at a time, a last chunk of 1-4
    rows), D % 4 != 0 and a misaligned h (the scalar path), narrow and
    wide rows, a NaN on a real edge (and NaN and signed zeros in pre and
    the level's old rows), and no edges (no slots too). An empty slot
    must give 0 (sums, mean, the softmax), relu(pre + 0) in the update
    mode; the update mode must also equal, bit for bit, the mean kernel
    followed by the walk's five PyTorch ops. The two backward modes
    against each other: the elements that differ are logged."""
    from prtp_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(6)

    def same(got, want):
        return got.shape == want.shape and torch.allclose(
            got, want, rtol=1e-5, atol=1e-6, equal_nan=True)

    cases, differ = 0, 0
    # (degrees of the slots, D, rows of h, case)
    for degs, d, r, case in (
            ([0, 1, 8, 9, 33, 0, 4, 2, 3, 1, 5, 6, 7] * 30, 128, 500,
             "degrees"),
            ([0, 1, 8, 9, 33, 4], 300, 200, "75 float4s a slot"),
            ([0, 1, 8, 9, 33, 4] * 20, 20, 200, "5 float4s a slot"),
            ([0, 1, 8, 9, 33, 4] * 20, 4, 200, "one float4 a slot"),
            ([0, 1, 8, 9, 33, 4] * 20, 7, 200, "D%4!=0"),
            ([0, 1, 8, 9, 33, 4] * 20, 128, 200, "misaligned h"),
            ([0, 3, 9, 2] * 20, 128, 200, "NaN"),
            ([0] * 5, 128, 50, "no edges"),
            ([], 128, 50, "no slots")):
        deg = torch.tensor(degs, dtype=torch.int64)
        off = torch.zeros(len(degs) + 1, dtype=torch.int32)
        off[1:] = deg.cumsum(0)
        off = off.to(dev)
        src = torch.randint(0, r, (int(deg.sum()),), generator=gen,
                            device=dev, dtype=torch.int32)
        # rows [r, r + S) of h: the net level that the update mode writes
        rows = r + len(degs)
        if case == "misaligned h":
            h = torch.randn(rows * d + 1, generator=gen, device=dev)[1:]
            h = h.view(rows, d)
        else:
            h = torch.randn((rows, d), generator=gen, device=dev) * 4
        pre = torch.randn((len(degs), d), generator=gen, device=dev) * 4
        nan_slot = None
        if case == "NaN":  # on the first edge of slots 1 and 2 (3, 9 edges)
            nan_slot = [1, 2]
            h[src[off[1:3].long()], 2] = float("nan")
            for t in (pre, h[r:]):
                t[::3, 0] = float("nan")
                t[1::3, 1] = -0.0
                t[2::3, 1] = 0.0
        empty = (deg == 0).to(dev)
        g = torch.randn((len(degs), d), generator=gen, device=dev)
        want = K.segment_softmax_sum_plain(h, src, off)[0]
        want_p = K.segment_softmax_sum_plain(h, src, off, True)
        what = f"{case}, D={d}"
        out = K.segment_softmax_sum(h, src, off)[0]
        part = K.segment_softmax_sum(h, src, off, True)
        ok = (same(out, want)
              and all(same(x, y) for x, y in zip(part, want_p))
              and not bool(out[empty].any())
              and not any(bool(t[empty].any()) for t in part[1:]))
        if nan_slot is not None:
            ok = ok and bool(out[nan_slot, 2].isnan().all())
        else:
            ok = ok and bool(torch.isfinite(out).all())
        if not ok:
            raise AssertionError(f"segment_softmax_sum differs: {what}")
        stats = (out, part[1], part[2])
        d_re = K.segment_softmax_sum_bwd(h, src, off, g)
        d_st = K.segment_softmax_sum_bwd(h, src, off, g, stats)
        # against the plain version on the kernel's statistics, as in
        # check_segment_kernels
        d_want = K.segment_softmax_sum_bwd_plain(h, src, off, g, stats)
        if not (same(d_re, d_want) and same(d_st, d_want)):
            errs = [float((x - d_want).abs().nan_to_num().max())
                    if x.numel() else 0.0 for x in (d_re, d_st)]
            raise AssertionError(
                f"segment_softmax_sum_bwd differs: {what}: max abs err "
                f"recomputing {errs[0]}, stats-reading {errs[1]}")
        differ += int((~((d_re == d_st) | (d_re.isnan() & d_st.isnan())))
                      .sum())
        check_segment_mean_shape(torch, K, gen, what, h, src, off, deg, pre,
                                 r, nan_slot)
        cases += 1
    log(f"  segment edge shapes: {cases} cases, each softmax kernel in both "
        "modes and segment_mean in its three, match their plain versions "
        "(rtol 1e-5, atol 1e-6, NaN where the plain version has it, empty "
        "slots 0, relu(pre + 0) in the update mode); the update mode "
        "bit-equal to the mean kernel and five ops; backward elements that "
        f"differ between recomputing and stats-reading: {differ}")


def edge_order_sums(torch, h, src, off):
    """Each slot's sum of its rows ``h[src[e]]`` as ``segment_mean`` adds
    them: from 0, in edge order, one float32 add at a time; (S, D)."""
    deg = (off[1:] - off[:-1]).long()
    start = off[:-1].long()
    acc = torch.zeros((deg.shape[0], h.shape[1]), device=h.device)
    for j in range(int(deg.max()) if deg.numel() else 0):
        slots = (deg > j).nonzero()[:, 0]
        acc[slots] = acc[slots] + h[src[start[slots] + j].long()]
    return acc


def near(torch, got, want, slack):
    """``|got - want| <= 1e-5 |want| + 1e-6 + slack`` elementwise, NaN
    exactly where ``want`` has it."""
    nan = want.isnan()
    if got.shape != want.shape or not torch.equal(got.isnan(), nan):
        return False
    bad = (got - want).abs() > 1e-5 * want.abs() + 1e-6 + slack
    return not bool((bad & ~nan).any())


def check_segment_mean_shape(torch, K, gen, what, h, src, off, deg, pre, r,
                             nan_slot):
    """:func:`check_segment_edge_shapes` for ``segment_mean``: the sums
    and mean modes (cnt the in-degree, at least 1) and the update mode of
    the level at h's rows ``[r, r + S)``, with a random third of the
    slots without in-edges (those with none among them) and with
    ``dgl_parity`` off. Each against its plain version at rtol 1e-5 and
    atol 1e-6 plus twice the float32 bound of a sum of n terms in any
    order, ``(n - 1) 2^-24 sum |x|`` (over cnt for the mean; the plain
    version's ``index_add_`` adds in another order than the kernel), and
    bit for bit against the same float operations in the kernel's order:
    the sums and the mean against :func:`edge_order_sums` (over cnt),
    the update against the mean kernel and the walk's five PyTorch ops;
    h's other rows untouched."""
    s = off.shape[0] - 1
    dev = h.device
    deg = deg.to(dev)
    empty = deg == 0
    cnt = deg.clamp_min(1).float()
    slack = (2 * (deg - 1).clamp_min(0)[:, None] * 2.0 ** -24
             * K.segment_mean_plain(h.abs(), src, off, None)).nan_to_num()
    ref = edge_order_sums(torch, h, src, off)
    for c in (None, cnt):
        mode = "sums" if c is None else "mean"
        got = K.segment_mean(h, src, off, c)
        div = 1.0 if c is None else c[:, None]
        ok = (near(torch, got, K.segment_mean_plain(h, src, off, c),
                   slack / div)
              and same_bits(torch, got, ref if c is None else ref / div)
              and not bool(got[empty].any()))
        if nan_slot is not None:
            ok = ok and bool(got[nan_slot, 2].isnan().all())
        if not ok:
            raise AssertionError(f"segment_mean ({mode}) differs: {what}")
    third = torch.rand((s, 1), generator=gen, device=dev) >= 1 / 3
    for mask in (~empty[:, None] & third, None):
        got, plain, comp = h.clone(), h.clone(), h.clone()
        K.net_update(got, src, off, cnt, pre, mask, r)
        K.net_update_plain(plain, src, off, cnt, pre, mask, r)
        K.net_epilogue(comp, pre, K.segment_mean(comp, src, off, cnt), mask,
                       r)
        take = (torch.ones((s, 1), dtype=torch.bool, device=dev)
                if mask is None else mask)
        ok = (near(torch, got[r:], plain[r:],
                   torch.where(take, slack / cnt[:, None], 0.0))
              and same_bits(torch, got, comp)
              and same_bits(torch, got[:r], h[:r])
              and same_bits(torch, got[r:][empty & take[:, 0]],
                            torch.relu(pre[empty & take[:, 0]] + 0.0)))
        if not ok:
            raise AssertionError(
                f"segment_mean (update, "
                f"{'dgl_parity off' if mask is None else 'has_in'}) "
                f"differs: {what}")


def check_segment_hazard(torch, graph, dev, early_writer, pair=1):
    """Phase 11 (a), programmatic dependent launch: at one pair's shapes
    of ``graph``, ``segment_softmax_sum`` (whole and ``partial``) right
    after a writer of ``h``, the one input it reads after its wait,
    ``segment_softmax_sum_bwd`` (recomputing and stats-reading) right
    after a writer of ``g``, ``segment_mean`` (sums and mean) right after
    a writer of ``h`` and its update mode right after a writer of ``h``
    and ``pre``, each NaN first, for both writers of
    :func:`hazard_writers`; each of HAZARD_REPS results a writer must
    match the plain version on the written values (rtol 1e-5, atol
    1e-6)."""
    from prtp_tpu_torch.ops import segment_kernels as K

    writers = hazard_writers(torch, dev, early_writer)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    src, off = graph.cell_src[pair], graph.cell_dst_off[pair]
    s = off.shape[0] - 1
    h = torch.randn((graph.num_rows + 1, D), generator=gen, device=dev)
    g = torch.randn((s, D), generator=gen, device=dev)
    failed = []
    (h_v,), h_src, h_buf = staged(torch, [h])
    for partial in (False, True):
        want = K.segment_softmax_sum_plain(h, src, off, partial)
        failed += after_writers(
            torch, writers, f"segment_softmax_sum (partial={partial})",
            lambda: torch.cat([t for t in K.segment_softmax_sum(
                h_v, src, off, partial) if t is not None]),
            h_buf, h_src, torch.cat([t for t in want if t is not None]))
    numer, mx, den = K.segment_softmax_sum_plain(h, src, off, True)
    (g_v,), g_src, g_buf = staged(torch, [g])
    for stats in (None, (numer / den.clamp_min(1e-12), mx, den)):
        mode = "recomputing" if stats is None else "stats-reading"
        failed += after_writers(
            torch, writers, f"segment_softmax_sum_bwd ({mode})",
            lambda: K.segment_softmax_sum_bwd(h, src, off, g_v, stats),
            g_buf, g_src,
            K.segment_softmax_sum_bwd_plain(h, src, off, g, stats))
    # segment_mean at the pair's net level: the sums and the mean right
    # after a writer of h; the update right after one writer launch of h
    # and pre (the level's rows of h, each slot's own old row included,
    # read after the wait), with a random third of the slots without
    # in-edges
    src, off = graph.net_src[pair], graph.net_dst_off[pair]
    cnt, n0 = graph.net_cnt[pair], graph.net_off[pair]
    s = off.shape[0] - 1
    for mode, c in (("sums", None), ("mean", cnt)):
        failed += after_writers(
            torch, writers, f"segment_mean ({mode})",
            lambda: K.segment_mean(h_v, src, off, c), h_buf, h_src,
            K.segment_mean_plain(h, src, off, c))
    pre = torch.randn((s, D), generator=gen, device=dev)
    has_in = graph.net_has_in[pair] & (
        torch.rand((s, 1), generator=gen, device=dev) >= 1 / 3)
    want = h.clone()
    K.net_update_plain(want, src, off, cnt, pre, has_in, n0)
    (hu_v, pre_v), u_src, u_buf = staged(torch, [h, pre])

    def update():
        K.net_update(hu_v, src, off, cnt, pre_v, has_in, n0)
        return hu_v[n0: n0 + s]

    failed += after_writers(torch, writers, "segment_mean (update)", update,
                            u_buf, u_src, want[n0: n0 + s])
    if failed:
        raise AssertionError("launched right after the kernel that writes "
                             "its inputs, a segment kernel differs from its "
                             f"plain version: {failed}")
    log(f"  programmatic launch: segment_softmax_sum (whole, partial), "
        f"segment_softmax_sum_bwd (recomputing, stats-reading) and "
        f"segment_mean (sums, mean, update) at pair {pair} match their plain "
        "versions right after each writer (rtol 1e-5, atol 1e-6)")


def gp_rank(rank, tmp, port, model_kw):
    """Phases 11, 12 and 13 (c), one of GP_RANKS processes on cuda:0
    joined over gloo in a (1, GP_RANKS) mesh: the headline segment model
    (with ``model_kw``: phase 12's ``--attn``, phase 13's bf16) from the
    parent's state before each step, SEG_STEPS graph-sharded steps on all
    597 paths (cuDNN deterministic, as the parent's); then one step
    timed, and the step's all-reduces alone. Writes its losses,
    parameter checksums, first-step gradients (rank 0), launch counts,
    split slots and times to ``rank<r>.pt`` in ``tmp``."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.parallel.graph_shard import (graph_sharded_train_step,
                                                     make_2d_mesh,
                                                     shard_design)
    from prtp_tpu_torch.trainer import init_state, make_optimizer, pad_batch

    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=GP_RANKS, rank=rank)
    try:
        mesh = make_2d_mesh(1, GP_RANKS)
        with open(os.path.join(tmp, "headline.pkl"), "rb") as f:
            parsed = pickle.load(f)
        snaps = torch.load(os.path.join(tmp, "ref_states.pt"),
                           weights_only=True)
        design = shard_design(mesh, pack_design(parsed, map_size=MAP_SIZE,
                                                device=dev, segment=True))
        n = design.num_paths
        state = init_state(PathModel(
            CELL_FEAT, NET_FEAT, map_size=MAP_SIZE, gnn_reduce="segment",
            generator=torch.Generator().manual_seed(SEED), **model_kw),
            make_optimizer(LR), dev)
        ids, mask = pad_batch(np.random.default_rng(0).permutation(n), n,
                              dev)
        out = {"losses": [], "checksums": [], "grads": None,
               "split_slots": design.graph.shard.split_slots}
        torch.cuda.synchronize()
        _zero_launches()
        for t in range(SEG_STEPS):
            _state_restore(state, (snaps["model"][t], snaps["opt"][t]))
            out["losses"].append(float(graph_sharded_train_step(
                state, design, ids, mask, mesh, batch_axis=None)["loss"]))
            out["checksums"].append(
                float(state.optimizer.flat.double().abs().sum()))
            if t == 0 and rank == 0:
                out["grads"] = _grads(state)
        torch.cuda.synchronize()
        out["counts"] = _read_launches()
        torch.backends.cudnn.deterministic = False
        out["step_ms"] = _host_ms(torch, lambda: graph_sharded_train_step(
            state, design, ids, mask, mesh, batch_axis=None), 3)
        shapes = walk_allreduces(design.graph, heads_of(model_kw))
        out["allreduces"] = len(shapes)
        out["allreduce_ms"] = time_allreduces(torch, dist, shapes, dev,
                                              mesh.gp_group, 3)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def segment_phase(torch, np, dev, smi, headline, compute_mode,
                  early_writer) -> tuple:
    """Phase 11: the segment reduce (``gnn_reduce="segment"``) and the
    2-D ``(dp, gp)`` edge-sharded step at the default model's full width
    on the headline, float32, TF32 off.

    (a) :func:`check_segment_kernels`, and each kernel's one-slot floor;
    :func:`check_segment_edge_shapes` and :func:`check_segment_hazard`.
    (b) (:func:`segment_model_checks`) The headline LayoutNet reg model
    with ``gnn_reduce="segment"`` (the phase 4 model's weights):
    REQUESTS evaluation requests card
    against CPU (1e-4) and against the card's mailbox model on the same
    weights (1e-4); SEG_STEPS steps of phase 6's epoch through
    :func:`paired_steps` (each card step from the CPU's state) by phase
    6's bounds, with the segment walk's launch counts; the first step's
    loss and gradients against the mailbox model's on the card (the same
    function, summed in another order: phase 6's bounds); one step timed
    (:func:`step_timing`), the mailbox step beside it, in turns.
    (c) :func:`~prtp_tpu_torch.parallel.graph_shard.graph_sharded_train_step`
    on all 597 paths (cuDNN deterministic): a (1, 1) mesh over NCCL,
    SEG_STEPS steps each from ``train_step``'s state before it, against
    ``train_step`` (losses and first-step gradients within DP_TOL),
    timed; then GP_RANKS processes on ``cuda:0`` over gloo at (1,
    GP_RANKS) (:func:`gp_rank`; not run, and said so, where the card's
    compute mode admits one process): against the one-rank steps within
    DP_TOL_2, checksums equal on every rank, cell slots split
    across the blocks, the step and its all-reduces timed on the host.
    Returns ``(records, launch counts of each run)``."""
    import torch.nn.functional as F
    from prtp_tpu_torch.graph import pack_design

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    design = pack_design(headline, map_size=MAP_SIZE, device=dev,
                         segment=True)
    graph = design.graph
    # ---- (a) the kernels ----
    log(f"phase 11 (a): the segment kernels at the headline's shapes "
        f"({graph.num_pairs} pairs)")
    timer = Timer(torch, dev)
    recs, scatter, modes = check_segment_kernels(torch, F, graph, dev, timer)
    floors = segment_floors(torch, graph, dev, timer)
    segment_chain(torch, graph, dev, timer,
                  recs["segment_softmax_sum"].ms
                  + recs["segment_softmax_sum_bwd"].ms,
                  recs["segment_mean"].ms)
    check_segment_degree_mix(torch, graph, dev, timer, smi)
    del timer
    for rec in (*recs.values(), *modes, scatter):
        rec.floor_ms = floors.get((rec.name, rec.design), floors[rec.name])
        log(f"  {rec.summary()}  [{smi}]")
    check_segment_edge_shapes(torch, dev)
    check_segment_hazard(torch, graph, dev, early_writer)

    launches = segment_model_checks(torch, np, dev, smi, headline, design,
                                    compute_mode, "11", {})
    del design
    torch.cuda.empty_cache()
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    return [recs[name] for name in SEGMENT_KERNELS], launches


def heads_of(model_kw):
    """The head count of a segment model's keyword arguments with
    ``--attn``, else None."""
    return model_kw.get("num_heads", 1) if model_kw.get("flag_attn") else None


def segment_model_checks(torch, np, dev, smi, headline, design,
                         compute_mode, phase, model_kw, brief=False) -> dict:
    """Phases 11, 12 and 13, (b) and (c), for the headline segment model
    with ``model_kw`` (phase 12: ``flag_attn`` and ``num_heads``; phase
    13: ``compute_dtype`` bfloat16 too), on ``design`` (the headline
    packed with ``segment=True``), its mailbox twin on the same weights
    beside it; see :func:`segment_phase`. A bf16 model (``low``) is held
    by phase 8's bf16 bounds (:func:`check_bf16`,
    :func:`compare_bf16_runs`) against the CPU and its mailbox twin, whose
    walk rounds as its own does, JAX's padded scan's (``rounding="scan"``;
    the segment model's default); its float32 twin (the same weights, the
    segment reduce) gives the bf16 rounding's own distance, and its (1,
    1) step must equal ``train_step``'s bit for bit. ``brief``: the
    requests, SHORT_STEPS paired steps and the (1, 1) step only.
    Returns the launch counts of each run."""
    import pickle
    import tempfile

    import torch.distributed as dist
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.parallel.distributed import free_port
    from prtp_tpu_torch.parallel.graph_shard import (graph_sharded_train_step,
                                                     make_2d_mesh,
                                                     shard_design)
    from prtp_tpu_torch.test import evaluate_design
    from prtp_tpu_torch.trainer import (init_state, iterate_batches,
                                        make_optimizer, pad_batch,
                                        train_step)

    graph = design.graph
    nh = heads_of(model_kw)
    attn = nh is not None
    low = model_kw.get("compute_dtype") is not None
    name_of = ("segment" + (" bf16" if low else "")
               + (f" --attn nh {nh}" if attn else ""))
    kw = dict(map_size=MAP_SIZE, generator=torch.Generator().manual_seed(SEED))
    model_cpu = PathModel(CELL_FEAT, NET_FEAT, gnn_reduce="segment", **kw,
                          **model_kw)
    mailbox = PathModel(CELL_FEAT, NET_FEAT,
                        generator=torch.Generator().manual_seed(SEED),
                        map_size=MAP_SIZE, **model_kw)
    mailbox.load_state_dict(model_cpu.state_dict())
    mailbox.to(dev)
    # each model's walk rounding: a bf16 mailbox model in the padded
    # scan's, as the bf16 segment model always rounds
    rounding_of = {"segment": None, "mailbox": "scan" if low else None}
    twin = None
    if low:  # the same weights in float32, on the card
        twin = PathModel(CELL_FEAT, NET_FEAT, gnn_reduce="segment", **kw,
                         **{k: v for k, v in model_kw.items()
                            if k != "compute_dtype"})
        twin.load_state_dict(model_cpu.state_dict())
        twin.to(dev)
    launches = {}
    what = f"serve headline {name_of}"
    model = copy.deepcopy(model_cpu).to(dev)
    launches[what] = serve(torch, np, model, model_cpu, headline,
                           f"headline {name_of}",
                           launches_per_forward_segment(graph, attn),
                           REQUESTS, attn=attn, f32_model=twin)
    with contextlib.redirect_stdout(io.StringIO()):
        p_seg, _m = evaluate_design(model, headline, DEVICE)
        p_box, _m = evaluate_design(mailbox, headline, DEVICE,
                                    rounding=rounding_of["mailbox"] or "scan")
        if low:
            p_f32, _m = evaluate_design(twin, headline, DEVICE)
    if low:
        check_bf16(np, f"headline {name_of} vs the mailbox model in the "
                   "padded scan's rounding, both on the card, same weights",
                   p_seg, p_box, p_f32)
    else:
        diff = float(np.abs(p_seg - p_box).max())
        np.testing.assert_allclose(p_seg, p_box, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name_of} vs mailbox on the card")
        log(f"  headline {name_of} vs mailbox, both on the card, same "
            f"weights: predictions within {diff:.3g} (rtol/atol 1e-4): ok")
    num_paths = int(headline["num_paths"])
    pids, _m = pad_batch(np.arange(num_paths), num_paths, dev)
    for name, m in (("segment", model), ("mailbox", mailbox)):
        with torch.no_grad():
            by_name = device_kernels(torch, lambda: m(
                design, pids, rounding=rounding_of[name]))
        log(f"phase {phase} (b): {name} model forward ({num_paths} paths"
            f"{', --attn nh %d' % nh if attn else ''}): "
            f"{sum(c for _, c in by_name.values())} kernel launches, device "
            f"busy {sum(t for t, _ in by_name.values()) / 1e3:.3f} ms "
            f"(torch.profiler)  [{smi}]")
    cpu_design = pack_design(headline, map_size=MAP_SIZE, device="cpu",
                             segment=True)
    designs = {DEVICE: design, "cpu": cpu_design}
    steps = SHORT_STEPS if brief else SEG_STEPS
    batches = {where: list(iterate_batches(
        np.arange(num_paths), TRAIN_BATCH, np.random.default_rng(EPOCH_SEED),
        device=where))[:steps] for where in designs}
    flips = pool_winner_flips(torch, model_cpu.cnn, cpu_design.cnn_input, dev)
    if low:  # the cpu's first step takes the card's bf16 CNN values
        log(f"  {name_of}: max-pool windows whose winner differs, card vs "
            f"cpu, at the init: {flips} (the cpu's first step takes the "
            "card's values)")
        card, _d = card_layers(torch, np, model_cpu.cnn, cpu_design.cnn_input,
                               dev)
    else:
        card, signs = card_branches(torch, model_cpu.cnn,
                                    cpu_design.cnn_input, dev)
        log(f"  {name_of}: max-pool windows whose winner differs, card vs "
            f"cpu, at the init: {flips}; conv outputs whose sign differs: "
            f"{signs}")
    what = f"train headline {name_of}, the epoch's first {steps} steps"
    f32_first = (float32_first_step(torch, twin, design, batches[DEVICE][0],
                                    "reg") if low else None)
    runs = paired_steps(torch, model_cpu, designs, batches, what,
                        launches_per_step_segment(graph, attn=attn), "reg",
                        attn=attn, card=card)
    launches[what] = runs[DEVICE][2]
    if low:
        compare_bf16_runs(torch, what, runs[DEVICE], runs["cpu"], f32_first)
    else:
        compare_runs(torch, what, runs[DEVICE], runs["cpu"], flips)
    del runs, cpu_design
    ids, mask = pad_batch(np.random.default_rng(0).permutation(num_paths),
                          num_paths, dev)
    if not brief:
        # the same first step on the card, segment and mailbox
        first = {}
        for name, m in (("segment", model_cpu), ("mailbox", mailbox)):
            state = init_state(copy.deepcopy(m).cpu(), make_optimizer(LR),
                               dev)
            loss = float(train_step(state, design, *batches[DEVICE][0],
                                    rounding=rounding_of[name])["loss"])
            first[name] = ([loss], _grads(state))
        (l_seg, g_seg), (l_box, g_box) = first["segment"], first["mailbox"]
        worst = max((float((g_seg[k] - g).abs().max() / g.abs().max()), k)
                    for k, g in g_box.items() if g.abs().max() > 0)
        rel = abs(l_seg[0] - l_box[0]) / abs(l_box[0])
        grad_tol, loss_rtol = ((BF16_GRAD_TOL, BF16_LOSS_RTOL) if low
                               else (GRAD_TOL, LOSS_RTOL))
        if worst[0] > grad_tol or rel > loss_rtol:
            raise AssertionError(f"{name_of} vs mailbox first step on the "
                                 f"card: loss rtol {rel}, gradients {worst} "
                                 "x max |g|")
        log(f"  train headline {name_of} vs mailbox, first step, both on "
            f"the card: loss within rtol {rel:.3g} (allowed {loss_rtol}), "
            f"gradients within {worst[0]:.3g} x each leaf's max |g| "
            f"({worst[1]}; allowed {grad_tol}): ok")
        for name in ("mailbox", "segment", "segment", "mailbox"):
            state = init_state(copy.deepcopy(
                model_cpu if name == "segment" else mailbox).cpu(),
                make_optimizer(LR), dev)
            tm = step_timing(torch, dev, lambda: train_step(
                state, design, ids, mask, rounding=rounding_of[name]), 200)
            log(f"phase {phase} (b): {name}{' bf16' if low else ''} train "
                f"step ({num_paths} paths"
                f"{', --attn nh %d' % nh if attn else ''}"
                f"{', the padded scan rounding' if low else ''}): device "
                f"time {tm['device_ms']:.3f} ms; as launched "
                f"{tm['launched_ms']:.3f} ms; wall {tm['wall_ms']:.3f} ms, "
                f"device busy {tm['busy_ms']:.3f} ms, idle share "
                f"{tm['idle']:.3f}; {tm['launches']} kernel launches  "
                f"[{smi}]")
            if name == "segment":
                log_port_kernels(tm["by_name"], f"{name_of} train step")
        del state
    del mailbox, model, twin
    torch.cuda.empty_cache()

    # ---- (c) the edge-sharded step ----
    torch.backends.cudnn.deterministic = True
    ref = init_state(copy.deepcopy(model_cpu), make_optimizer(LR), dev)
    snaps, ref_losses, ref_grads = [], [], None
    for t in range(steps):
        snaps.append(_state_snapshot(ref))
        ref_losses.append(float(train_step(ref, design, ids, mask)["loss"]))
        if t == 0:
            ref_grads = _grads(ref)
    del ref

    def check(what, losses, grads, tol):
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        worst = (0.0, "")
        for key, want in ref_grads.items():
            scale = float(want.abs().max())
            diff = float((grads[key] - want).abs().max())
            worst = max(worst, (diff / scale if scale else diff, key))
            if diff > tol * scale:
                raise AssertionError(f"{what}: gradient of {key} differs by "
                                     f"{diff} (max |g| {scale}, allowed "
                                     f"{tol} x)")
        if rel > tol:
            raise AssertionError(f"{what}: losses {losses} against one "
                                 f"process's {ref_losses}")
        log(f"  {what} vs train_step: losses {losses} within rtol "
            f"{rel:.3g}, first-step gradients within {worst[0]:.3g} x the "
            f"leaf's max |g| ({worst[1]}; allowed {tol} each): ok")

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_2d_mesh(1, 1)
        sharded = shard_design(mesh, design)
        state = init_state(copy.deepcopy(model_cpu), make_optimizer(LR), dev)
        what = (f"phase {phase} (c): {name_of} graph-sharded, (1, 1) mesh "
                f"(NCCL), {steps} steps")
        losses, grads = [], None
        torch.cuda.synchronize()
        _zero_launches()
        for t in range(steps):
            _state_restore(state, snaps[t])
            losses.append(float(graph_sharded_train_step(
                state, sharded, ids, mask, mesh)["loss"]))
            if t == 0:
                grads = _grads(state)
        torch.cuda.synchronize()
        launches[what] = _read_launches()
        check_launches(what, launches[what],
                       launches_per_step_segment(graph, True, attn), steps)
        # bf16: bit for bit (one rank's all-reduces change nothing)
        check(what, losses, grads, 0.0 if low else DP_TOL)
        torch.backends.cudnn.deterministic = False
        tm = step_timing(torch, dev, lambda: graph_sharded_train_step(
            state, sharded, ids, mask, mesh), 200)
        shapes = walk_allreduces(graph, nh)
        ar_ms = time_allreduces(torch, dist, shapes, dev, mesh.gp_group, 5)
        log(f"phase {phase} (c): {name_of} graph-sharded step, (1, 1) "
            f"mesh ({num_paths} "
            f"paths): device time {tm['device_ms']:.3f} ms; as launched "
            f"{tm['launched_ms']:.3f} ms; wall {tm['wall_ms']:.3f} ms, "
            f"device busy {tm['busy_ms']:.3f} ms, idle share "
            f"{tm['idle']:.3f}; {tm['launches']} kernel launches; its "
            f"{len(shapes)} gp all-reduces alone (NCCL, 1 rank, host time) "
            f"{ar_ms:.3f} ms  [{smi}]")
        del state, sharded
    finally:
        dist.destroy_process_group()

    if brief:
        log(f"phase {phase} (c): {name_of}: the (1, {GP_RANKS}) mesh is "
            "not run for this model (the reg model's is)")
    elif "exclusive" in compute_mode.lower():
        log(f"phase {phase} (c): the card's compute mode is {compute_mode}: it "
            "admits one process, so two ranks cannot share it; the (1, 2) "
            "mesh not run")
    else:
        with tempfile.TemporaryDirectory(prefix="prtp_gp_") as tmp:
            with open(os.path.join(tmp, "headline.pkl"), "wb") as f:
                pickle.dump(headline, f)
            torch.save({"model": [s[0] for s in snaps],
                        "opt": [s[1] for s in snaps]},
                       os.path.join(tmp, "ref_states.pt"))
            t0 = time.perf_counter()
            torch.multiprocessing.start_processes(
                gp_rank, args=(tmp, free_port(), model_kw), nprocs=GP_RANKS,
                join=True, start_method="spawn")
            wall = time.perf_counter() - t0
            outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                               weights_only=True) for r in range(GP_RANKS)]
        what = (f"phase {phase} (c): {name_of} graph-sharded, (1, "
                f"{GP_RANKS}) mesh on {DEVICE} (gloo), {SEG_STEPS} steps")
        for r, out in enumerate(outs):
            launches[f"{what}, rank {r}"] = out["counts"]
            check_launches(f"{what}, rank {r}", out["counts"],
                           launches_per_step_segment(graph, True, attn),
                           SEG_STEPS)
        if any(o["checksums"] != outs[0]["checksums"]
               or o["losses"] != outs[0]["losses"] for o in outs):
            raise AssertionError(f"{what}: the ranks' parameters or losses "
                                 f"differ: {[o['checksums'] for o in outs]}")
        if not outs[0]["split_slots"]:
            raise AssertionError(f"{what}: no cell slot is split "
                                 "across the gp blocks")
        check(what, outs[0]["losses"], outs[0]["grads"], DP_TOL_2)
        log(f"  {what}: parameter checksums equal on every rank after each "
            f"step ({outs[0]['checksums']}); {outs[0]['split_slots']} "
            f"cell slots split across the blocks; {wall:.1f} s with "
            "the processes' start")
        log(f"phase {phase} (c): {name_of} graph-sharded step, (1, "
            f"{GP_RANKS}) mesh on one card, host time between synchronizes (median of 3): "
            + ", ".join(f"rank {r} {o['step_ms']:.3f} ms"
                        for r, o in enumerate(outs))
            + f"; its {outs[0]['allreduces']} gp all-reduces alone (gloo, "
            "through the host; median of 3): "
            + ", ".join(f"{o['allreduce_ms']:.3f}" for o in outs)
            + f" ms  [{smi}]")
    torch.backends.cudnn.deterministic = False
    return launches


# ---- phase 12: --attn under the segment reduce ----

def attn_bits(torch, a, b) -> int:
    """Elements of ``a`` whose bits differ from ``b``'s (NaN equal to
    NaN)."""
    return int((~((a == b) | (a.isnan() & b.isnan()))).sum())


def check_segment_attn_kernels(torch, graph, dev, timer, nh) -> tuple:
    """Phase 12 (a): the two ``--attn`` kernels of the segment walk
    against their plain versions at the headline's shapes, each level
    k > 0 in turn, with ``nh`` heads, a random state ``h``, score weight
    (``fc_attn2``'s init scale) and cotangent: ``segment_attn_sum`` whole
    (the main path) and ``partial`` (an edge-sharded rank's),
    ``segment_attn_bwd`` recomputing (the main path) and reading the
    statistics (an edge-sharded rank's), each tensor by
    :func:`attn_close`, the backward against the plain version on the
    forward kernel's statistics (each call's ``d_w`` a sum of one call).
    Bit for bit: the partial call's numerator over its denominator (the
    combine at one rank) against the whole call's output, the two
    backward modes given those statistics, and ``d_w`` of two calls.
    Then the walk's backward order (pairs 9 to 1) into one
    ``AttnGradSum`` a backward (:func:`check_attn_grad_sum`). Bytes count
    what a call must move: each distinct source row and index once, w,
    and the outputs (``partial`` also writes the (S, nh) shift and
    denominator; the backward reads g_out and writes the (E, D)
    cotangent, stats-reading also reads the statistics, and a pass
    writes d_w once); operations the products (2 D nh an edge for the
    scores, 2 D for the weighted sum; the backward 2 D (3 nh + 2)). No
    single PyTorch call computes either function: no library time.
    Times: the median of REPS cold-L2 calls; a backward pass is its
    rows calls, each adding into a sum, and the sum's one reduce.
    Returns ``({name: KernelRecord} of the main path's modes,
    [KernelRecord] of the others)``."""
    from prtp_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(SEED + 21 + nh)
    h = torch.randn((graph.num_rows + 1, D), generator=gen, device=dev)
    w = attn_weights(torch, nh, gen, dev)
    row_b, w_b, st_b = D * 4, nh * D * 4, nh * 4
    design = f"headline, nh {nh}"
    recs = {name: KernelRecord(name, design) for name in SEGMENT_ATTN_KERNELS}
    partial_rec = KernelRecord("segment_attn_sum", f"{design}, partial")
    stats_rec = KernelRecord("segment_attn_bwd", f"{design}, stats-reading")
    # the timed calls' sums, one a mode
    timed = {False: K.AttnGradSum(w), True: K.AttnGradSum(w)}
    cots = {}

    def close(what, k, got, want):
        ok, err = attn_close(torch, got, want)
        if not (ok and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{what} (nh {nh}) differs at pair {k}: max "
                                 f"abs err {err}")
        return err

    for k in range(1, graph.num_pairs):
        src, off = graph.cell_src[k], graph.cell_dst_off[k]
        s, e = off.shape[0] - 1, src.shape[0]
        rows = torch.unique(src).numel()
        out = K.segment_attn_sum(h, src, off, w)[0]
        err = close("segment_attn_sum", k, out,
                    K.segment_attn_sum_plain(h, src, off, w)[0])
        numer, mx, den = K.segment_attn_sum(h, src, off, w, True)
        err_p = max(close("segment_attn_sum (partial)", k, got, want)
                    for got, want in zip(
                        (numer, mx, den),
                        K.segment_attn_sum_plain(h, src, off, w, True)))
        stats = (K.divide_heads(numer, den), mx, den)
        if not torch.equal(stats[0], out):
            raise AssertionError(f"segment_attn_sum (nh {nh}) at pair {k}: "
                                 f"the partial numerator over its "
                                 f"denominator differs from the whole "
                                 f"output at {attn_bits(torch, stats[0], out)}"
                                 " elements")
        # read: the distinct rows, the edge table, the offsets, w
        nbytes = rows * row_b + e * 4 + (s + 1) * 4 + w_b
        ops = 2.0 * e * D * (nh + 1)
        ms = timer.ms(lambda: K.segment_attn_sum(h, src, off, w))
        ms_p = timer.ms(lambda: K.segment_attn_sum(h, src, off, w, True))
        pms = timer.ms(lambda: K.segment_attn_sum_plain(h, src, off, w))
        recs["segment_attn_sum"].add(ms, pms, None, nbytes + s * row_b, ops,
                                     err)
        partial_rec.add(ms_p, pms, None, nbytes + s * row_b + 2 * s * st_b,
                        ops, err_p)
        log(f"  segment_attn_sum nh {nh} pair {k}: {e} edges into {s} slots "
            f"of {D} f32  kernel {ms:.4f} ms (partial {ms_p:.4f})  plain "
            f"{pms:.4f}  bound {bound(nbytes + s * row_b, ops)[0]:.4f} "
            f"(partial {bound(nbytes + s * row_b + 2 * s * st_b, ops)[0]:.4f})"
            f"  library none  max abs err {err:.3g} (partial {err_p:.3g}); "
            "partial numerator over its denominator vs the whole output: "
            "bit-equal")
        g = torch.randn((s, D), generator=gen, device=dev)
        cots[k] = (src, off, g, stats)
        d_msg, d_w = K.segment_attn_bwd(h, src, off, w, g)
        d_st, d_w_st = K.segment_attn_bwd(h, src, off, w, g, stats)
        want_m, want_w = K.segment_attn_bwd_plain(h, src, off, w, g, stats)
        err = max(close("segment_attn_bwd d_msg", k, d_msg, want_m),
                  close("segment_attn_bwd d_w", k, d_w, want_w))
        err_s = max(close("segment_attn_bwd d_msg (stats-reading)", k, d_st,
                          want_m),
                    close("segment_attn_bwd d_w (stats-reading)", k, d_w_st,
                          want_w))
        again = K.segment_attn_bwd(h, src, off, w, g)[1]
        modes = (attn_bits(torch, d_msg, d_st), attn_bits(torch, d_w, d_w_st))
        if any(modes) or not torch.equal(again, d_w):
            raise AssertionError(
                f"segment_attn_bwd (nh {nh}) at pair {k}: recomputing vs "
                f"stats-reading differ at {modes} elements (d_msg, d_w); "
                f"d_w again equal {torch.equal(again, d_w)}")
        # read the distinct rows, the tables, w and g; write the (E, D)
        # cotangent (and, once a pass, d_w); stats-reading also reads out,
        # mx and den
        nbytes = (rows * row_b + e * 4 + (s + 1) * 4 + w_b + s * row_b
                  + e * row_b)
        ops = 2.0 * e * D * (3 * nh + 2)
        ms = timer.ms(lambda: K.segment_attn_bwd(h, src, off, w, g, None,
                                                 timed[False]))
        ms_s = timer.ms(lambda: K.segment_attn_bwd(h, src, off, w, g, stats,
                                                   timed[True]))
        ms_one = timer.ms(lambda: K.segment_attn_bwd(h, src, off, w, g))
        pms = timer.ms(lambda: K.segment_attn_bwd_plain(h, src, off, w, g))
        extra = s * row_b + 2 * s * st_b
        recs["segment_attn_bwd"].add(ms, pms, None, nbytes, ops, err)
        stats_rec.add(ms_s, pms, None, nbytes + extra, ops, err_s)
        log(f"  segment_attn_bwd nh {nh} pair {k}: {e} edges  kernel "
            f"{ms:.4f} ms into a sum (stats-reading {ms_s:.4f}; a call with "
            f"its own reduce {ms_one:.4f})  plain {pms:.4f}  bound "
            f"{bound(nbytes, ops)[0]:.4f} (stats-reading "
            f"{bound(nbytes + extra, ops)[0]:.4f})  library none  max abs err "
            f"{err:.3g} (stats-reading {err_s:.3g}; d_w of max "
            f"{float(want_w.abs().max()):.3g}); recomputing vs stats-reading: "
            "bit-equal, d_w deterministic")
    for rec, acc in ((recs["segment_attn_bwd"], timed[False]),
                     (stats_rec, timed[True])):
        red_ms = timer.ms(acc.finish)
        rec.ms += red_ms
        rec.bytes += w_b
        log(f"  segment_attn_bwd nh {nh} ({rec.design}): the sum's reduce "
            f"over {acc.filled} rows {red_ms:.4f} ms, once a pass")
    check_attn_grad_sum(torch, h, w, cots, nh)
    return recs, [partial_rec, stats_rec]


def check_attn_grad_sum(torch, h, w, cots, nh):
    """Phase 12 (a): the walk's backward order over the pairs (9 to 1),
    each ``segment_attn_bwd`` call adding into one ``AttnGradSum``
    reduced once: ``d_w`` against the plain versions' per-call ``d_w``
    added in that order (:func:`attn_close`); bit for bit, a second run,
    the stats-reading mode, and a run with a synchronize after each call
    (the calls back to back read and add to the workspace rows the call
    before wrote: a read before the wait would miss its sums), the last
    also for each call's ``d_msg``. ``cots``: ``{k: (src, off, g,
    stats)}``."""
    from prtp_tpu_torch.ops import segment_kernels as K

    order = sorted(cots, reverse=True)

    def backward(stats=False, sync=False):
        acc = K.AttnGradSum(w)
        d_msgs = []
        for k in order:
            src, off, g, st = cots[k]
            d_msgs.append(K.segment_attn_bwd(h, src, off, w, g,
                                             st if stats else None, acc)[0])
            if sync:
                torch.cuda.synchronize()
        return d_msgs, acc.finish()

    want = None
    for k in order:
        src, off, g, st = cots[k]
        d_w = K.segment_attn_bwd_plain(h, src, off, w, g, st)[1]
        want = d_w if want is None else want + d_w
    got_m, got = backward()
    ok, err = attn_close(torch, got, want)
    runs = {"again": backward(), "stats-reading": backward(stats=True),
            "synchronized": backward(sync=True)}
    bits = {name: attn_bits(torch, run[1], got) for name, run in runs.items()}
    bits["synchronized d_msg"] = sum(
        attn_bits(torch, a, b) for a, b in zip(runs["synchronized"][0],
                                               got_m))
    if not ok or any(bits.values()):
        raise AssertionError(f"segment_attn_bwd (nh {nh}): the backward's "
                             f"d_w sum: max abs err {err:.3g} against the "
                             f"plain sum; elements off: {bits}")
    log(f"  segment_attn_bwd nh {nh}: d_w summed over the {len(order)} "
        f"pairs in the walk's order into one sum (one reduce): max abs err "
        f"{err:.3g} against the plain per-call sum (of max "
        f"{float(want.abs().max()):.3g}); bit-equal to a second run, to the "
        "stats-reading mode and to a run synchronized after each call "
        "(d_msg too)")


def segment_attn_floors(torch, graph, dev, timer, nh) -> dict:
    """Each ``--attn`` segment kernel with ``nh`` heads timed on a
    one-slot call (one edge), by name: the backward's rows kernel adding
    into a sum (the walk's per-call cost); also, by ``(name, what)``, the
    backward with its own reduce (a sum of one call) and the reduce of
    one row alone."""
    from prtp_tpu_torch.ops import segment_kernels as K

    h = torch.randn((graph.num_rows + 1, D), device=dev)
    w = torch.randn((nh, D), device=dev)
    src = graph.cell_src[1][:1]
    off = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    row = torch.randn((1, D), device=dev)
    acc = K.AttnGradSum(w)
    return {"segment_attn_sum": timer.ms(
                lambda: K.segment_attn_sum(h, src, off, w)),
            "segment_attn_bwd": timer.ms(
                lambda: K.segment_attn_bwd(h, src, off, w, row, None, acc)),
            ("segment_attn_bwd", "one call"): timer.ms(
                lambda: K.segment_attn_bwd(h, src, off, w, row)),
            ("segment_attn_bwd", "reduce"): timer.ms(acc.finish)}


def check_segment_attn_degree_mix(torch, graph, dev, timer, smi, nh):
    """Phase 12 (a): the ``--attn`` segment pair with ``nh`` heads on the
    headline's cell levels with slots of 5-8 edges mixed in
    (:func:`degree_mixes`; a warp with a slot of more than 4 edges walks
    its edges 4 rows at a time): the forward (whole) and the backward
    (recomputing; a sum of one call) against their plain versions
    (:func:`attn_close`, the backward on the plain statistics), timed
    (the median of REPS cold-L2 calls) into ms a pass, the backward as
    the walk runs it (each call adding into one sum, then its reduce),
    beside each kernel's bound."""
    from prtp_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(SEED + 31 + nh)
    h = torch.randn((graph.num_rows + 1, D), generator=gen, device=dev)
    w = attn_weights(torch, nh, gen, dev)
    row_b, w_b = D * 4, nh * D * 4
    for mix, levels in degree_mixes(torch, graph, dev).items():
        ms = {"fwd": 0.0, "bwd": 0.0}
        nbytes = {"fwd": 0, "bwd": w_b}
        ops = {"fwd": 0.0, "bwd": 0.0}
        edges = slots = 0
        err = 0.0
        acc = K.AttnGradSum(w)
        for src, off in levels:
            s, e = off.shape[0] - 1, src.shape[0]
            edges, slots = edges + e, slots + s
            g = torch.randn((s, D), generator=gen, device=dev)
            pairs = [(K.segment_attn_sum(h, src, off, w)[0],
                      K.segment_attn_sum_plain(h, src, off, w)[0])]
            pairs += list(zip(K.segment_attn_bwd(h, src, off, w, g),
                              K.segment_attn_bwd_plain(h, src, off, w, g)))
            for got, want in pairs:
                ok, e_ = attn_close(torch, got, want)
                if not (ok and bool(torch.isfinite(got).all())):
                    raise AssertionError(f"segment --attn pair (nh {nh}, "
                                         f"{mix}) differs from its plain "
                                         f"version: max abs err {e_}")
                err = max(err, e_)
            ms["fwd"] += timer.ms(lambda: K.segment_attn_sum(h, src, off, w))
            ms["bwd"] += timer.ms(
                lambda: K.segment_attn_bwd(h, src, off, w, g, None, acc))
            read = (torch.unique(src).numel() * row_b + e * 4 + (s + 1) * 4
                    + w_b)
            nbytes["fwd"] += read + s * row_b
            nbytes["bwd"] += read + s * row_b + e * row_b
            ops["fwd"] += 2.0 * e * D * (nh + 1)
            ops["bwd"] += 2.0 * e * D * (3 * nh + 2)
        ms["bwd"] += timer.ms(acc.finish)
        log(f"  degree mix {mix}, nh {nh} ({edges} edges into {slots} slots "
            f"over {len(levels)} pairs): segment_attn_sum {ms['fwd']:.4f} ms "
            f"a pass (bound {bound(nbytes['fwd'], ops['fwd'])[0]:.4f}), "
            f"segment_attn_bwd {ms['bwd']:.4f} (bound "
            f"{bound(nbytes['bwd'], ops['bwd'])[0]:.4f}); each matches its "
            f"plain version (max abs err {err:.3g})  [{smi}]")


def check_segment_attn_edge_shapes(torch, dev):
    """Phase 12 (a): the ``--attn`` segment kernels on the code paths the
    headline does not reach, against their plain versions
    (:func:`attn_close`, NaN where the plain version has it):
    ``segment_attn_sum`` whole and ``partial``, ``segment_attn_bwd``
    recomputing and stats-reading (the statistics of the kernel's own
    partial call; the two modes bit for bit). Slots of 0 (an empty slot
    gives 0: out, shift and den), 1, 2-4, 5-8 and more than 8 edges (9,
    13, 33: the generic path, 4 rows at a time), in warps whose slots'
    degrees differ; the heads together at 1 to 32 heads and 4 to 32
    float4s a row (16 and 8 lanes a slot: two and four slots a warp); the
    per-head loop at nh = 3, D = 12 (not a power of two), D / nh < 4 (a
    float4 spanning heads), 75 float4s a row (several a lane), D % 4 != 0
    and a misaligned h (the scalar path); a NaN on a real edge; no edges,
    and no slots."""
    from prtp_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(16)
    mix = [0, 1, 5, 8, 9, 13, 4, 2, 3, 6, 7, 33]
    cases = 0
    # (degrees of the slots, D, nh, rows of h, case)
    for degs, d, nh, r, case in (
            (mix * 30, 128, 1, 500, "degrees"),
            (mix * 30, 128, 4, 500, "degrees"),
            (mix * 30, 128, 32, 500, "32 heads"),
            ([0, 1, 3, 9] * 40, 64, 2, 300, "16 float4s a slot"),
            ([0, 1, 3, 9] * 40, 16, 4, 300, "4 float4s a slot"),
            (mix * 10, 12, 3, 200, "nh 3"),
            (mix * 10, 128, 64, 200, "D/nh < 4"),
            (mix * 3, 300, 3, 200, "75 float4s a slot"),
            (mix * 10, 14, 2, 200, "D%4!=0"),
            (mix * 10, 128, 4, 200, "misaligned h"),
            ([0, 3, 9, 2] * 20, 128, 4, 200, "NaN"),
            ([0] * 5, 128, 4, 50, "no edges"),
            ([], 128, 4, 50, "no slots")):
        deg = torch.tensor(degs, dtype=torch.int64)
        off = torch.zeros(len(degs) + 1, dtype=torch.int32)
        off[1:] = deg.cumsum(0)
        off = off.to(dev)
        src = torch.randint(0, r, (int(deg.sum()),), generator=gen,
                            device=dev, dtype=torch.int32)
        if case == "misaligned h":
            h = torch.randn(r * d + 1, generator=gen, device=dev)[1:]
            h = h.view(r, d)
        else:
            h = torch.randn((r, d), generator=gen, device=dev)
        nan_slot = None
        if case == "NaN":  # on the first edge of slots 1 and 2 (3, 9 edges)
            nan_slot = [1, 2]
            h[src[off[1:3].long()], 2] = float("nan")
        w = attn_weights(torch, nh, gen, dev, d)
        empty = (deg == 0).to(dev)
        g = torch.randn((len(degs), d), generator=gen, device=dev)
        what = f"{case}, D={d}, nh {nh}"
        out = K.segment_attn_sum(h, src, off, w)[0]
        part = K.segment_attn_sum(h, src, off, w, True)
        pairs = [(out, K.segment_attn_sum_plain(h, src, off, w)[0])]
        pairs += list(zip(part, K.segment_attn_sum_plain(h, src, off, w,
                                                         True)))
        ok = (all(attn_close(torch, x, y)[0] for x, y in pairs)
              and not any(bool(t[empty].any()) for t in (out, *part)))
        if nan_slot is not None:  # every head's score of the slot is NaN
            ok = ok and bool(out[nan_slot].isnan().all())
        else:
            ok = ok and bool(torch.isfinite(out).all())
        if not ok:
            raise AssertionError(f"segment_attn_sum differs: {what}: max abs "
                                 "err " + ", ".join(
                                     f"{attn_close(torch, x, y)[1]:.3g}"
                                     for x, y in pairs))
        stats = (K.divide_heads(part[0], part[2]), part[1], part[2])
        if attn_bits(torch, stats[0], out):
            raise AssertionError(f"segment_attn_sum: {what}: the partial "
                                 "numerator over its denominator differs "
                                 "from the whole output")
        re = K.segment_attn_bwd(h, src, off, w, g)
        st = K.segment_attn_bwd(h, src, off, w, g, stats)
        want = K.segment_attn_bwd_plain(h, src, off, w, g, stats)
        res = [attn_close(torch, x, y) for got in (re, st)
               for x, y in zip(got, want)]
        if not all(ok for ok, _e in res):
            raise AssertionError(f"segment_attn_bwd differs: {what}: max abs "
                                 "err (d_msg, d_w; recomputing, "
                                 "stats-reading) "
                                 + ", ".join(f"{e:.3g}" for _o, e in res))
        differ = [attn_bits(torch, x, y) for x, y in zip(re, st)]
        if any(differ):
            raise AssertionError(f"segment_attn_bwd: {what}: recomputing vs "
                                 f"stats-reading differ at {differ} elements "
                                 "(d_msg, d_w)")
        cases += 1
    log(f"  segment --attn edge shapes: {cases} cases, each kernel in both "
        "modes matches its plain version (rtol 1e-5, atol 1e-5 x max |value|"
        ", NaN where the plain version has it, empty slots 0); the partial "
        "numerator over its denominator bit-equal to the whole output, the "
        "backward's modes bit-equal")


def check_segment_attn_hazard(torch, graph, dev, early_writer, nh, pair=1):
    """Phase 12 (a), programmatic dependent launch, at one pair's shapes
    of ``graph`` with ``nh`` heads: ``segment_attn_sum`` (whole and
    ``partial``) right after each writer of :func:`hazard_writers` writes
    the NaN-filled ``h`` (the one input it reads after its wait), and
    ``segment_attn_bwd`` (recomputing and stats-reading) right after each
    writes the NaN-filled ``g``, and again (both modes) into an
    ``AttnGradSum`` whose workspace rows an earlier call wrote, right
    after each writer writes those rows back into the NaN-filled
    workspace: each of HAZARD_REPS launches must equal bit for bit a run
    with a synchronize between writer and kernel (a read before the wait
    would find NaN), and the synchronized run match the plain version
    (:func:`attn_close`; the sum against the two calls' plain d_w)."""
    from prtp_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(SEED + 23 + nh)
    src, off = graph.cell_src[pair], graph.cell_dst_off[pair]
    s = off.shape[0] - 1
    h = torch.randn((graph.num_rows + 1, D), generator=gen, device=dev)
    g = torch.randn((s, D), generator=gen, device=dev)
    w = attn_weights(torch, nh, gen, dev)
    numer, mx, den = K.segment_attn_sum_plain(h, src, off, w, True)
    stats = (K.divide_heads(numer, den), mx, den)
    writers = hazard_writers(torch, dev, early_writer)
    h_v = torch.full_like(h, float("nan"))
    g_v = torch.full_like(g, float("nan"))
    calls = {}
    for partial in (False, True):
        calls[f"segment_attn_sum (partial={partial})"] = (
            h_v, h,
            lambda p=partial: [t for t in K.segment_attn_sum(h_v, src, off,
                                                             w, p)
                               if t is not None],
            [t for t in K.segment_attn_sum_plain(h, src, off, w, partial)
             if t is not None])
    for st in (None, stats):
        mode = "recomputing" if st is None else "stats-reading"
        calls[f"segment_attn_bwd ({mode})"] = (
            g_v, g, lambda st=st: list(K.segment_attn_bwd(h, src, off, w,
                                                          g_v, st)),
            list(K.segment_attn_bwd_plain(h, src, off, w, g, st)))
    for name, (buf, val, call, want) in calls.items():
        for writer, write in writers.items():
            bad = []
            for _ in range(HAZARD_REPS):
                runs = []
                for sync in (False, True):
                    buf.fill_(float("nan"))
                    torch.cuda._sleep(int(0.2 * SPIN_CYCLES_PER_MS))
                    write(buf, val)
                    if sync:
                        torch.cuda.synchronize()
                    runs.append(call())
                bad.append(sum(attn_bits(torch, a, b)
                               for a, b in zip(*runs)))
            ok = all(attn_close(torch, a, b)[0] for a, b in zip(runs[1],
                                                                want))
            log(f"  programmatic launch: {name} (nh {nh}) right after "
                f"{writer} writes its input: elements off the synchronized "
                f"run in each of {HAZARD_REPS} launches {bad}; synchronized "
                f"run vs plain version {'ok' if ok else 'DIFFERS'}")
            if any(bad) or not ok:
                raise AssertionError(f"{name} (nh {nh}) right after {writer} "
                                     f"differs: {bad}")
    # the sum's workspace: a second call right after a writer of the rows
    # the first call left there (read before the wait, they would be NaN)
    for st in (None, stats):
        mode = "recomputing" if st is None else "stats-reading"
        want_m, want_w = K.segment_attn_bwd_plain(h, src, off, w, g, st)
        want = [want_m, want_w + want_w]
        for writer, write in writers.items():
            bad = []
            for _ in range(HAZARD_REPS):
                runs = []
                for sync in (False, True):
                    acc = K.AttnGradSum(w)
                    K.segment_attn_bwd(h, src, off, w, g, st, acc)
                    rows = acc.work.clone()
                    acc.work.fill_(float("nan"))
                    torch.cuda._sleep(int(0.2 * SPIN_CYCLES_PER_MS))
                    write(acc.work, rows)
                    if sync:
                        torch.cuda.synchronize()
                    d_msg = K.segment_attn_bwd(h, src, off, w, g, st, acc)[0]
                    runs.append([d_msg, acc.finish()])
                bad.append(sum(attn_bits(torch, a, b)
                               for a, b in zip(*runs)))
            ok = all(attn_close(torch, a, b)[0] for a, b in zip(runs[1],
                                                                want))
            log(f"  programmatic launch: segment_attn_bwd ({mode}, nh {nh}) "
                f"into a sum, right after {writer} writes the rows an "
                f"earlier call left in its workspace: elements off the "
                f"synchronized run in each of {HAZARD_REPS} launches {bad}; "
                f"synchronized run vs plain version (two calls' d_w) "
                f"{'ok' if ok else 'DIFFERS'}")
            if any(bad) or not ok:
                raise AssertionError(f"segment_attn_bwd ({mode}, nh {nh}) "
                                     f"into a sum right after {writer} "
                                     f"differs: {bad}")


def segment_attn_phase(torch, np, dev, smi, headline, compute_mode,
                       early_writer) -> tuple:
    """Phase 12: ``--attn`` under the segment reduce
    (``PathModel(gnn_reduce="segment", flag_attn=True, num_heads=nh)``)
    at the default model's full width on the headline, float32, TF32
    off, for nh in ATTN_HEADS (1: the recorded ``reg_fusion_attn``; 4).

    (a) :func:`check_segment_attn_kernels` (with
    :func:`check_attn_grad_sum`), each kernel's one-slot floor and
    :func:`check_segment_attn_degree_mix`, for each nh;
    :func:`check_segment_attn_edge_shapes`;
    :func:`check_segment_attn_hazard` for each nh.
    (b) and (c), for each nh: :func:`segment_model_checks` with
    ``flag_attn`` and ``num_heads``, beside the mailbox ``--attn`` model
    on the same weights: REQUESTS requests card against CPU and against
    the mailbox model (1e-4), the forward's launches, SEG_STEPS steps
    card against CPU by phase 6's bounds, the step timed beside the
    mailbox ``--attn`` step; ``graph_sharded_train_step`` at (1, 1) over
    NCCL against ``train_step`` (DP_TOL) and at (1, GP_RANKS) over gloo
    (DP_TOL_2, a slot split, the ranks' states equal).
    Returns ``(records of nh = ATTN_HEADS[0], launch counts of each
    run)``."""
    from prtp_tpu_torch.graph import pack_design

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    design = pack_design(headline, map_size=MAP_SIZE, device=dev,
                         segment=True)
    graph = design.graph
    log(f"phase 12 (a): the segment --attn kernels at the headline's shapes "
        f"({graph.num_pairs} pairs)")
    timer = Timer(torch, dev)
    main_recs = {}
    for nh in ATTN_HEADS:
        recs, modes = check_segment_attn_kernels(torch, graph, dev, timer, nh)
        floors = segment_attn_floors(torch, graph, dev, timer, nh)
        for rec in (*recs.values(), *modes):
            rec.floor_ms = floors[rec.name]
            log(f"  {rec.summary()}  [{smi}]")
        log(f"  segment_attn_bwd nh {nh}: one-slot call with its own reduce "
            f"{floors['segment_attn_bwd', 'one call']:.4f} ms, the reduce "
            f"of one row {floors['segment_attn_bwd', 'reduce']:.4f}  [{smi}]")
        check_segment_attn_degree_mix(torch, graph, dev, timer, smi, nh)
        main_recs[nh] = recs
    del timer
    check_segment_attn_edge_shapes(torch, dev)
    for nh in ATTN_HEADS:
        check_segment_attn_hazard(torch, graph, dev, early_writer, nh)
    launches = {}
    for nh in ATTN_HEADS:
        launches.update(segment_model_checks(
            torch, np, dev, smi, headline, design, compute_mode, "12",
            dict(flag_attn=True, num_heads=nh)))
    del design
    torch.cuda.empty_cache()
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    return [main_recs[ATTN_HEADS[0]][name] for name in SEGMENT_ATTN_KERNELS], \
        launches


def segment_bf16_phase(torch, np, dev, smi, headline, compute_mode) -> dict:
    """Phase 13: bf16 under the segment reduce
    (``PathModel(gnn_reduce="segment", compute_dtype="bfloat16")``, the
    walk in JAX's padded scan's rounding, every entry point at its
    default) at the default model's full width on the headline, TF32
    off. The kernels are the float32 segment walk's (phases 11 and 12
    hold them), on the same float32 inputs.

    (b) and (c) of :func:`segment_model_checks` for the reg model, by
    phase 8's bf16 bounds: REQUESTS requests card against CPU and against
    the card's bf16 mailbox model in the same rounding on the same
    weights (:func:`check_bf16`, the float32 twin's distance measured in
    the run), the forward's launches, SEG_STEPS paired steps card against
    CPU (:func:`compare_bf16_runs`) with the segment walk's launch
    counts, the first step against the mailbox model's on the card
    (BF16_GRAD_TOL, BF16_LOSS_RTOL), one step timed beside the bf16
    mailbox step in the padded scan's rounding (``bf16_scan``), in turns;
    the (1, 1) NCCL step bit-equal to ``train_step``; GP_RANKS gloo
    processes at (1, GP_RANKS) within DP_TOL_2, the ranks' checksums
    equal. Then the ``--attn`` model with 4 heads (``brief``): the
    requests, SHORT_STEPS paired steps and the (1, 1) bit check.
    Returns the launch counts of each run."""
    from prtp_tpu_torch.graph import pack_design

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    design = pack_design(headline, map_size=MAP_SIZE, device=dev,
                         segment=True)
    launches = {}
    for model_kw, brief in (
            (dict(compute_dtype="bfloat16"), False),
            (dict(compute_dtype="bfloat16", flag_attn=True,
                  num_heads=ATTN_HEADS[-1]), True)):
        log(f"phase 13: segment PathModel({model_kw}) on the headline")
        launches.update(segment_model_checks(
            torch, np, dev, smi, headline, design, compute_mode, "13",
            model_kw, brief=brief))
    del design
    torch.cuda.empty_cache()
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    return launches


def _multi_snapshots(torch, model_cpu, stacked, batches, step_fn):
    """The one-rank multi-design run of phase 14 (d) on the card: from the
    init, a step a batch, the state before each kept; returns (snapshots,
    losses, the first step's gradients on the CPU)."""
    from prtp_tpu_torch.trainer import init_state, make_optimizer

    state = init_state(copy.deepcopy(model_cpu), make_optimizer(LR), DEVICE)
    snaps, losses, grads = [], [], None
    for t, (ids, mask) in enumerate(batches):
        snaps.append(_state_snapshot(state))
        losses.append(float(step_fn(state, stacked, ids, mask)["loss"]))
        if t == 0:
            grads = _grads(state)
    return snaps, losses, grads


def multi_rank(rank, tmp, port):
    """Phase 14 (d), one of DP_RANKS processes on cuda:0, joined over
    gloo: the MERGED_K designs packed on the card and stacked, and
    MULTI_STEPS design-sharded multi-design steps, each from the one-rank
    run's state before it (cuDNN deterministic); rank r owns designs
    r x MERGED_K / DP_RANKS onward. Writes its losses, parameter
    checksums, first-step gradients (rank 0) and launch counts to
    ``rank<r>.pt`` in ``tmp``."""
    import pickle

    import torch
    import torch.distributed as dist
    from prtp_tpu_torch.graph import stack_designs
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.parallel import Mesh
    from prtp_tpu_torch.parallel.multi import multidesign_train_step
    from prtp_tpu_torch.trainer import init_state, make_optimizer

    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=DP_RANKS, rank=rank)
    try:
        mesh = Mesh.of_group()
        with open(os.path.join(tmp, "multi.pkl"), "rb") as f:
            parsed, batches = pickle.load(f)
        snaps = torch.load(os.path.join(tmp, "multi_states.pt"),
                           weights_only=True)
        stacked = stack_designs(parsed, map_size=MAP_SIZE, device=dev)
        state = init_state(PathModel(
            CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
            generator=torch.Generator().manual_seed(SEED)),
            make_optimizer(LR), dev)
        out = {"losses": [], "checksums": [], "grads": None}
        per = len(parsed) // DP_RANKS
        stacked.block(rank * per, (rank + 1) * per)  # packed before the run
        torch.cuda.synchronize()
        _zero_launches()
        for t, (ids, mask) in enumerate(batches):
            _state_restore(state, (snaps["model"][t], snaps["opt"][t]))
            out["losses"].append(float(multidesign_train_step(
                state, stacked, ids.to(dev), mask.to(dev), mesh=mesh)["loss"]))
            out["checksums"].append(
                float(state.optimizer.flat.double().abs().sum()))
            if t == 0 and rank == 0:
                out["grads"] = _grads(state)
        torch.cuda.synchronize()
        out["counts"] = _read_launches()
        out["graph"] = launches_per_step(
            stacked.block(rank * per, (rank + 1) * per)[0].graph)
        torch.backends.cudnn.deterministic = False
        ids, mask = (x.to(dev) for x in batches[0])
        out["step_ms"] = _host_ms(torch, lambda: multidesign_train_step(
            state, stacked, ids, mask, mesh=mesh), 3)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def multi_phase(torch, np, dev, smi, shared, compute_mode) -> dict:
    """Phase 14: the multi-design step (``parallel/multi.py``,
    ``graph.stack_designs``) at the default model's full width, TF32 off,
    on phase 9's MERGED_K designs (the same parsed designs, weights and
    batches, stacked; their super-graph is packed once for the stack). The per-design ids are phase 9's
    merged batch and grouped rounds read back in each design's own
    numbering.
    (a) REQUESTS evaluations (``multidesign_eval_step``), card against
    CPU at rtol/atol 1e-4, and against phase 9's merged ``evaluate`` of
    the stack's super-graph on the same weights and path rows: the same
    walk and head on the same tables, so the valid entries' predictions
    must agree within MULTI_TOL x their largest |value| (a padded entry
    reads its own design's path 0 here, design 0's there).
    (b) MULTI_STEPS steps on phase 9's rounds, card against CPU by phase
    6's rules (MAX_FLIPS a pool and raster); the step timed beside phase
    9's merged step and MERGED_K single steps (same run, same paths).
    (c) The model in bf16: REQUESTS evaluations and SHORT_STEPS paired
    steps, card against CPU by phase 8's bf16 bounds.
    (d) Design-sharded: one NCCL rank against the unsharded step
    (losses and first gradients within DP_TOL), its step timed as phase
    10 (a) times one, and in bf16 (the walk's per-pair sums and the other
    leaves' rounding after the sum) one step against the unsharded bf16
    step with its leaves outside the walk rounded to bf16 (loss equal,
    gradients within DP_TOL); DP_RANKS gloo processes on cuda:0, MERGED_K /
    DP_RANKS designs a rank, MULTI_STEPS steps each from the one-rank
    run's state, within DP_TOL_2, the ranks' parameter checksums equal,
    a step timed on the host (not run, and said so, where the card's
    compute mode admits one process). Every run's launch counters are
    zeroed just before it and checked just after against the stack's
    super-graph. Returns each run's launch counts."""
    import pickle
    import tempfile

    import torch.distributed as dist
    from prtp_tpu_torch.graph import stack_designs
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.parallel import Mesh
    from prtp_tpu_torch.parallel.distributed import free_port
    from prtp_tpu_torch.parallel.multi import (multidesign_eval_step,
                                               multidesign_train_step)
    from prtp_tpu_torch.test import evaluate
    from prtp_tpu_torch.trainer import init_state, make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    parsed = shared["parsed"]
    first = np.cumsum([0] + [int(p["num_paths"]) for p in parsed])[:-1, None]

    def local(ids, mask):  # a merged (K, B) batch in each design's own ids
        ids, mask = np.asarray(ids), np.asarray(mask)
        return np.where(mask > 0, ids - first, 0), mask

    def on(where, ids, mask):
        return (torch.from_numpy(ids).to(where),
                torch.from_numpy(mask).to(where))

    ids_np, mask_np = local(shared["ids"], shared["mask"])
    rounds = [local(i.numpy(), m.numpy()) for i, m in shared["rounds"]]
    t0 = time.perf_counter()
    stacks = {where: stack_designs(parsed, map_size=MAP_SIZE, device=where)
              for where in ("cpu", DEVICE)}
    blocks = {where: s.block(0, MERGED_K)[0] for where, s in stacks.items()}
    graph = blocks[DEVICE].graph
    log(f"phase 14: {MERGED_K} designs stacked (bucket "
        f"{stacks[DEVICE].bucket}, {stacks[DEVICE].num_pairs} level pairs), "
        f"their super-graph packed once, on the cpu and the card, in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = {where: on(where, ids_np, mask_np) for where in stacks}
    model_cpu = PathModel(CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
                          generator=torch.Generator().manual_seed(SEED))
    model = copy.deepcopy(model_cpu).to(dev)
    per_forward, per_step = launches_per_forward(graph), launches_per_step(
        graph)
    launches = {}

    def multi_step(state, stacked, ids, mask):
        return multidesign_train_step(state, stacked, ids, mask)

    # ---- (a) evaluation ----
    what = "serve multi-design"
    torch.cuda.synchronize()
    _zero_launches()
    outs = []
    for req in range(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, mets = multidesign_eval_step(model, stacks[DEVICE],
                                            *batch[DEVICE])
        outs.append(preds.cpu().numpy())
        log(f"  multi-design request {req}: wall "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms  loss "
            f"{float(mets['loss']):.6f}  r2 {float(mets['r2']):.6f}")
    launches[what] = _read_launches()
    check_launches(what, launches[what], per_forward, REQUESTS)
    want = multidesign_eval_step(model_cpu, stacks["cpu"],
                                 *batch["cpu"])[0].numpy()
    for req, got in enumerate(outs):
        if got.shape != ids_np.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"multi-design request {req}: bad "
                                 f"predictions {got.shape}")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"multi-design request {req} vs "
                                   "cpu")
    rows = torch.from_numpy(shared["ids"]).to(dev)
    merged = evaluate(model, blocks[DEVICE], rows,
                      torch.from_numpy(shared["mask"]).to(dev))[0].cpu().numpy()
    # a padded entry (mask 0) reads path 0 of its own design here and of
    # design 0 in phase 9's batch: the valid entries are compared
    valid = mask_np > 0
    off = float(np.abs(outs[0][valid] - merged[valid]).max())
    if off > MULTI_TOL * float(np.abs(merged[valid]).max()):
        raise AssertionError(f"multi-design request vs the merged evaluate: "
                             f"{off} apart")
    log(f"  multi-design requests vs cpu: max abs diff "
        f"{max(float(np.abs(o - want).max()) for o in outs):.3g} (rtol/atol "
        f"1e-4); vs phase 9's merged evaluate of the same super-graph: "
        f"{off:.3g} (allowed {MULTI_TOL} x max |pred|): ok")

    # ---- (b) training ----
    what = f"train multi-design, {MULTI_STEPS} steps"
    cpu_in = blocks["cpu"].cnn_input
    flips = pool_winner_flips(torch, model_cpu.cnn, cpu_in, dev)
    cards, signs = card_branches(torch, model_cpu.cnn, cpu_in, dev)
    log(f"  multi-design LayoutNet at the init, card vs cpu: max-pool "
        f"windows whose winner differs {flips}; conv outputs whose sign "
        f"differs {signs}")
    steps = rounds[:MULTI_STEPS]
    card = train_run(torch, init_state(copy.deepcopy(model_cpu),
                                       make_optimizer(LR), DEVICE),
                     stacks[DEVICE], [on(dev, *b) for b in steps], what,
                     per_step, step=multi_step)
    launches[what] = card[2]
    cpu = train_run(torch, init_state(copy.deepcopy(model_cpu),
                                      make_optimizer(LR), "cpu"),
                    stacks["cpu"], [on("cpu", *b) for b in steps], what,
                    card=cards, step=multi_step)
    compare_runs(torch, what, card, cpu, flips, rasters=MERGED_K)
    del card, cpu, cards
    state = init_state(copy.deepcopy(model_cpu), make_optimizer(LR), DEVICE)
    t = step_timing(torch, dev, lambda: multi_step(state, stacks[DEVICE],
                                                   *batch[DEVICE]), 300)
    log(f"phase 14: one multi-design step ({MERGED_K} x {MERGED_BATCH} ids, "
        f"{int(mask_np.sum())} valid): device time {t['device_ms']:.3f} ms; "
        f"as launched {t['launched_ms']:.3f} ms; wall {t['wall_ms']:.3f} ms,"
        f" device busy {t['busy_ms']:.3f} ms (torch.profiler), idle share "
        f"{t['idle']:.3f}; {t['launches']} kernel launches  [{smi}]")
    for kname, (tot, cnt) in sorted(t["by_name"].items(),
                                    key=lambda kv: -kv[1][0])[:6]:
        log(f"    {tot / 1e3:8.3f} ms  x{cnt:<4d} {kname[:90]}")
    log_port_kernels(t["by_name"], "one multi-design step")
    for name, other in shared["timing"].items():
        log(f"phase 14: the multi-design step / phase 9's {name}: device "
            f"busy {t['busy_ms'] / other['busy_ms']:.3f}, as launched "
            f"{t['launched_ms'] / other['launched_ms']:.3f}, launches "
            f"{t['launches'] / other['launches']:.3f} ({other['busy_ms']:.3f}"
            f" ms busy, {other['launched_ms']:.3f} ms as launched, "
            f"{other['launches']} launches)  [{smi}]")
    del state, t

    # ---- (c) bf16 ----
    low = PathModel(CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
                    compute_dtype=torch.bfloat16)
    low.load_state_dict(model_cpu.state_dict())
    low_card = copy.deepcopy(low).to(dev)
    stacks16 = {where: stack_designs(parsed, map_size=MAP_SIZE, device=where,
                                     compute_dtype=torch.bfloat16)
                for where in ("cpu", DEVICE)}
    what = "serve multi-design bf16"
    torch.cuda.synchronize()
    _zero_launches()
    outs16 = [multidesign_eval_step(low_card, stacks16[DEVICE],
                                    *batch[DEVICE])[0].cpu().numpy()
              for _ in range(REQUESTS)]
    launches[what] = _read_launches()
    check_launches(what, launches[what], per_forward, REQUESTS)
    want16 = multidesign_eval_step(low, stacks16["cpu"],
                                   *batch["cpu"])[0].numpy()
    for req, got in enumerate(outs16):
        check_bf16(np, f"multi-design bf16 request {req}", got, want16,
                   outs[0])
    what = f"train multi-design bf16, {SHORT_STEPS} steps"
    card, _d = card_layers(torch, np, low.cnn,
                           stacks16["cpu"].block(0, MERGED_K)[0].cnn_input,
                           dev)
    batches = {where: [on(where, *b) for b in rounds[:SHORT_STEPS]]
               for where in stacks16}
    twin = init_state(copy.deepcopy(model_cpu), make_optimizer(LR), DEVICE)
    f32_first = (float(multi_step(twin, stacks[DEVICE],
                                  *batches[DEVICE][0])["loss"]),
                 _grads(twin))
    del twin
    runs = paired_steps(torch, low, stacks16, batches, what, per_step, "reg",
                        card=card, step=multi_step)
    launches[what] = runs[DEVICE][2]
    compare_bf16_runs(torch, what, runs[DEVICE], runs["cpu"], f32_first)
    stack16 = stacks16[DEVICE]
    del low_card, stacks16, runs, card
    torch.cuda.empty_cache()

    # ---- (d) the design-sharded step ----
    torch.backends.cudnn.deterministic = True
    steps_card = [on(dev, *b) for b in steps]
    snaps, ref_losses, ref_grads = _multi_snapshots(
        torch, model_cpu, stacks[DEVICE], steps_card, multi_step)

    def check(what, losses, grads, tol):
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        worst = (0.0, "")
        for key, w in ref_grads.items():
            scale = float(w.abs().max())
            diff = float((grads[key] - w).abs().max())
            worst = max(worst, (diff / scale if scale else diff, key))
            if diff > tol * scale:
                raise AssertionError(f"{what}: gradient of {key} differs by "
                                     f"{diff} (max |g| {scale}, allowed "
                                     f"{tol} x)")
        if rel > tol:
            raise AssertionError(f"{what}: losses {losses} against one "
                                 f"rank's {ref_losses}")
        log(f"  {what} vs the unsharded step: losses {losses} within rtol "
            f"{rel:.3g}, first-step gradients within {worst[0]:.3g} x the "
            f"leaf's max |g| ({worst[1]}; allowed {tol} each): ok")

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = Mesh.of_group()
        what = f"phase 14 (d): multi-design, 1 rank (NCCL), {MULTI_STEPS} steps"
        state = init_state(copy.deepcopy(model_cpu), make_optimizer(LR),
                           DEVICE)
        losses, grads = [], None
        torch.cuda.synchronize()
        _zero_launches()
        for step_t, (ids, mask) in enumerate(steps_card):
            _state_restore(state, snaps[step_t])
            losses.append(float(multidesign_train_step(
                state, stacks[DEVICE], ids, mask, mesh=mesh)["loss"]))
            if step_t == 0:
                grads = _grads(state)
        torch.cuda.synchronize()
        launches[what] = _read_launches()
        check_launches(what, launches[what], per_step, MULTI_STEPS)
        check(what, losses, grads, DP_TOL)
        torch.backends.cudnn.deterministic = False
        t = step_timing(torch, dev, lambda: multidesign_train_step(
            state, stacks[DEVICE], *steps_card[0], mesh=mesh), 300)
        log(f"phase 14 (d): design-sharded step, 1 rank (NCCL): device time "
            f"{t['device_ms']:.3f} ms; as launched {t['launched_ms']:.3f} ms;"
            f" wall {t['wall_ms']:.3f} ms, device busy {t['busy_ms']:.3f} ms,"
            f" idle share {t['idle']:.3f}; {t['launches']} kernel launches  "
            f"[{smi}]")
        del state, t
        # the bf16 model over one rank: the walk's per-pair sums change no
        # bit, and every other leaf is the unsharded step's rounded to
        # bf16 once (the ranks' sum is rounded, as JAX's sharded step
        # rounds it; an unsharded gradient such as fcn_bias's is float32)
        what = "phase 14 (d): multi-design bf16, 1 rank (NCCL), 1 step"
        torch.backends.cudnn.deterministic = True
        runs16 = []
        for on_mesh in (None, mesh):
            state = init_state(copy.deepcopy(low), make_optimizer(LR), DEVICE)
            _zero_launches()
            loss = float(multidesign_train_step(
                state, stack16, *steps_card[0], mesh=on_mesh)["loss"])
            torch.cuda.synchronize()
            runs16.append((loss, _grads(state), _read_launches()))
        launches[what] = runs16[1][2]
        check_launches(what, launches[what], per_step, 1)
        worst, rounded = (0.0, ""), []
        for key, w in runs16[0][1].items():
            if not key.startswith("gnn."):
                w16 = w.to(torch.bfloat16).float()
                if not torch.equal(w16, w):
                    rounded.append(key)
                w = w16
            diff = float((runs16[1][1][key] - w).abs().max())
            worst = max(worst, (diff / (float(w.abs().max()) or 1.0), key))
        if worst[0] > DP_TOL or runs16[1][0] != runs16[0][0]:
            raise AssertionError(f"{what}: loss {runs16[1][0]} against "
                                 f"{runs16[0][0]}, gradients {worst}")
        log(f"  {what} vs the unsharded bf16 step, the leaves outside the "
            f"walk rounded to bf16 (it changes {rounded}): losses equal, "
            f"first-step gradients within {worst[0]:.3g} x the leaf's max "
            f"|g| ({worst[1] or 'every leaf'}; allowed {DP_TOL}): ok")
        del state, runs16
    finally:
        dist.destroy_process_group()
    del low, stack16
    torch.backends.cudnn.deterministic = False
    if "exclusive" in compute_mode.lower():
        log(f"phase 14 (d): the card's compute mode is {compute_mode}: it "
            "admits one process, so two ranks cannot share it; not run")
    else:
        with tempfile.TemporaryDirectory(prefix="prtp_multi_") as tmp:
            with open(os.path.join(tmp, "multi.pkl"), "wb") as f:
                pickle.dump((parsed, [on("cpu", *b) for b in steps]), f)
            torch.save({"model": [s[0] for s in snaps],
                        "opt": [s[1] for s in snaps]},
                       os.path.join(tmp, "multi_states.pt"))
            t0 = time.perf_counter()
            torch.multiprocessing.start_processes(
                multi_rank, args=(tmp, free_port()), nprocs=DP_RANKS,
                join=True, start_method="spawn")
            wall = time.perf_counter() - t0
            outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                               weights_only=True) for r in range(DP_RANKS)]
        what = (f"phase 14 (d): multi-design, {DP_RANKS} ranks on {DEVICE} "
                f"(gloo), {MERGED_K // DP_RANKS} designs a rank, "
                f"{MULTI_STEPS} steps")
        for r, out in enumerate(outs):
            launches[f"{what}, rank {r}"] = out["counts"]
            check_launches(f"{what}, rank {r}", out["counts"], out["graph"],
                           MULTI_STEPS)
        if any(o["checksums"] != outs[0]["checksums"]
               or o["losses"] != outs[0]["losses"] for o in outs):
            raise AssertionError(f"{what}: the ranks' parameters or losses "
                                 f"differ: {[o['checksums'] for o in outs]}")
        check(what, outs[0]["losses"], outs[0]["grads"], DP_TOL_2)
        log(f"  {what}: parameter checksums equal on every rank after each "
            f"step ({outs[0]['checksums']}); {wall:.1f} s with the "
            "processes' start")
        log(f"phase 14 (d): design-sharded step, {DP_RANKS} ranks on one "
            "card (gloo), host time between synchronizes (median of 3): "
            + ", ".join(f"rank {r} {o['step_ms']:.3f} ms"
                        for r, o in enumerate(outs)) + f"  [{smi}]")
    del stacks, blocks, model
    torch.cuda.empty_cache()
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    return launches


def flagship_forward(torch, graft, small, device):
    """Phase 15 (a)'s forward on ``device``: ``entry()``'s (the small
    flagship, its first 32 paths), or the full flagship's over all its
    paths, in eval mode. Returns ``(forward, graph)``."""
    if small:
        fn, args = graft.entry(device=device)
        return (lambda: fn(*args)), args[1].graph
    model, design, _parsed = graft._flagship(small=False, device=device)
    model.eval()
    ids = torch.arange(design.num_paths, device=design.path_endpoint.device)

    def forward():
        with torch.no_grad():
            return model(design, ids)

    return forward, design.graph


def entry_phase(torch, np, dev, smi, compute_mode) -> dict:
    """Phase 15 (a), (b): ``__graft_entry_torch__``'s forwards and dry run
    (module doc; (c) is :func:`pack_parity`). Returns the forwards'
    launch counts."""
    import __graft_entry_torch__ as graft

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = {}
    timer = Timer(torch, dev)
    for small, what in ((True, "serve flagship entry()"),
                        (False, "serve flagship full")):
        t0 = time.perf_counter()
        forward, graph = flagship_forward(torch, graft, small, DEVICE)
        build_s = time.perf_counter() - t0
        per = launches_per_forward(graph)
        torch.cuda.synchronize()
        _zero_launches()
        got = forward()
        torch.cuda.synchronize()
        launches[what] = _read_launches()
        check_launches(f"phase 15 (a): {what}", launches[what], per, 1)
        got = got.cpu().numpy()
        forward_cpu, _g = flagship_forward(torch, graft, small, "cpu")
        t0 = time.perf_counter()
        want = forward_cpu().numpy()
        cpu_s = time.perf_counter() - t0
        del forward_cpu, _g
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"phase 15 (a): {what}: {got.shape} "
                                 f"against {want.shape}, finite "
                                 f"{np.isfinite(got).all()}")
        diff = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, rtol=FLAGSHIP_TOL,
                                   atol=FLAGSHIP_TOL,
                                   err_msg=f"phase 15 (a): {what} vs cpu")
        dev_ms = timer.ms(forward, queue_ms=50)
        launched_ms = timer.ms(forward, queue_ms=0)
        log(f"phase 15 (a): {what}: {graph.num_pairs} level pairs, "
            f"{got.shape[0]} paths; built and packed in {build_s:.2f} s; "
            f"card vs cpu max abs diff {diff:.3g} (rtol/atol "
            f"{FLAGSHIP_TOL}): ok; forward device time {dev_ms:.3f} ms, as "
            f"launched {launched_ms:.3f} ms (cpu {cpu_s * 1e3:.1f} ms)  "
            f"[{smi}]")
        del forward, graph, got
    del timer
    torch.cuda.empty_cache()

    if ("exclusive" in compute_mode.lower()
            and torch.cuda.device_count() < DRYRUN_RANKS):
        log(f"phase 15 (b): the card's compute mode is {compute_mode}: it "
            f"admits one process, so {DRYRUN_RANKS} ranks cannot share it; "
            "not run")
    else:
        t0 = time.perf_counter()
        result = graft.dryrun_multichip(DRYRUN_RANKS)
        wall = time.perf_counter() - t0
        if not result["matched"]:
            raise AssertionError(f"phase 15 (b): no 2-D step: {result}")
        log(f"phase 15 (b): dryrun_multichip({DRYRUN_RANKS}): mesh "
            f"{result['mesh']} over {result['backend']}, loss "
            f"{result['loss']:.6f}, gradients within {result['grad_gap'][0]:.3g}"
            f" x their allowance ({result['grad_gap'][1] or 'every leaf equal'}"
            f"); {wall:.1f} s with the processes' start  [{smi}]")

    log(f"phase 15 (a), (b): {time.perf_counter() - t_phase:.1f} s  "
        f"[{smi}]")
    return launches


def _pack_module():
    """``scripts/results_pack_torch.py`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "results_pack_torch.py")
    spec = importlib.util.spec_from_file_location("results_pack_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_PACK_LINE = re.compile(r"^(e\d+,\S+,b\d+/\d+), l:\S+, r2:\S+, r:\S+, "
                        r"F1:(\S+)$", re.M)


def _pack_gaps(pack, name, task, card, cpu) -> tuple:
    """Phase 15 (c): one config's train CLI on the card against on the
    CPU. ``card`` and ``cpu`` are ``(state_dict, steps, printed)``: the
    weights the CLI started from, its steps' metrics at full precision
    and its printed batch lines ``(label, F1)``. Returns (mismatches, the
    worst loss gap, the worst r2 gap), each gap relative: the loss's to
    the larger loss, r2's to the larger ``1 - r2``, the residual's share
    of the targets' variance, which the loss's rtol bounds."""
    bad = [f"{name}: {d}, card vs cpu"
           for d in pack.start_diffs(card[0], cpu[0])]
    labels = [[lab for lab, _f1 in run[2]] for run in (card, cpu)]
    if labels[0] != labels[1] or len(card[1]) != len(labels[0]) \
            or len(cpu[1]) != len(labels[1]):
        bad.append(f"{name}: batch lines differ: card {len(card[1])} steps "
                   f"{labels[0]}, cpu {len(cpu[1])} steps {labels[1]}")
        return bad, float("inf"), float("inf")
    loss_gap = r2_gap = 0.0
    for label, a, b, pa, pb in zip(labels[0], card[1], cpu[1], card[2],
                                   cpu[2]):
        gap = abs(a["loss"] - b["loss"]) / max(abs(a["loss"]),
                                                abs(b["loss"]), 1e-30)
        loss_gap = max(loss_gap, gap)
        if gap > LOSS_RTOL:
            bad.append(f"{name}: batch {label}: loss card {a['loss']!r} cpu "
                       f"{b['loss']!r}, {gap:.3g} apart (rtol {LOSS_RTOL})")
        gap = abs(a["r2"] - b["r2"]) / max(abs(1 - a["r2"]),
                                            abs(1 - b["r2"]), 1e-30)
        r2_gap = max(r2_gap, gap)
        if gap > LOSS_RTOL:
            bad.append(f"{name}: batch {label}: r2 card {a['r2']!r} cpu "
                       f"{b['r2']!r}, {gap:.3g} of 1 - r2 apart (rtol "
                       f"{LOSS_RTOL})")
        counts = [[run[k] for k in ("tp", "fp", "tn", "fn")]
                  for run in (a, b)]
        if task == "cls" and (pa[1] != pb[1] or counts[0] != counts[1]):
            bad.append(f"{name}: batch {label}: F1 card {pa[1]} cpu {pb[1]}"
                       f" (tp, fp, tn, fn card {counts[0]}, cpu "
                       f"{counts[1]})")
    return bad, loss_gap, r2_gap


def pack_parity(pack, runs, smi):
    """Phase 15 (c): the train CLI of every config of
    ``scripts/results_pack_torch.py`` (``CONFIGS``) on the CPU for
    PACK_EPOCHS epoch, against the first PACK_EPOCHS epoch of phase 16
    (a)'s first card run of the config (``runs``: :func:`pack_runs`),
    both as the pack runs it (a child process, ``run_train``) on the
    same corpus. The weights each run starts from (its checkpoint at
    creation) must be bit-equal, every step's loss and r2 agree within
    LOSS_RTOL (r2 as ``1 - r2``), a ``cls`` run's confusion counts and
    printed F1s equal, and the card's first loss must be the JAX pack's
    committed one (``results/<config>/summary.json``, read as data;
    ``results_pack_torch.start_gap``). Raises on any mismatch, naming
    the config, the batch and the two values."""
    bad = []
    for name, _kind, extra in pack.CONFIGS:
        card, cpu = runs[(name, 0)], runs[(name, "cpu")]
        n = len(cpu["steps"])
        card_epoch = (card["weights"], card["steps"][:n], card["labels"][:n])
        task = "cls" if "cls" in extra else "reg"
        found, loss_gap, r2_gap = _pack_gaps(
            pack, name, task, card_epoch,
            (cpu["weights"], cpu["steps"], cpu["labels"]))
        jax = pack.jax_row(name)
        first = card["steps"][0]["loss"]
        found += [f"{name}: {gap}" for gap in [pack.start_gap(first, jax)]
                  if gap]
        bad += found
        n_w = sum(w.numel() for w in card["weights"].values())
        start = ("DIFFER" if any("starting weight" in b for b in found)
                 else "bit-equal")
        log(f"phase 15 (c): {name}: {len(card['weights'])} starting tensors "
            f"({n_w} values) {start}; {n} steps; loss card {first:.6g} -> "
            f"{card_epoch[1][-1]['loss']:.6g} (the JAX pack's first "
            f"{jax['first_loss']}), cpu {cpu['steps'][0]['loss']:.6g} -> "
            f"{cpu['steps'][-1]['loss']:.6g}; worst gap loss {loss_gap:.3g},"
            f" r2 {r2_gap:.3g} (rtol {LOSS_RTOL}); cpu run "
            f"{cpu['seconds']:.1f} s; {len(found)} mismatches  [{smi}]")
    for b in bad:
        log(f"phase 15 (c): MISMATCH {b}")
    if bad:
        raise AssertionError(f"phase 15 (c): {len(bad)} mismatches, card vs "
                             f"cpu and JAX's first losses; the first: "
                             f"{bad[0]}")
    log(f"phase 15 (c): {len(pack.CONFIGS)} configs' train CLIs on the cpu, "
        f"{PACK_EPOCHS} epoch, against the card's first epoch: ok  [{smi}]")


_PACK_VAL = re.compile(r"^\toverall r2:.*$", re.M)
_BATCH_TEXT = re.compile(r"^e\d+,\S+,b\d+/\d+, .*$", re.M)


def _pack_run(pack, work, data, job):
    """Phases 15 (c) and 16 (a): one run of a pack config's train CLI, as
    the pack runs it (a child process): ``run`` 0 or 1 on the card for
    REPEAT_EPOCHS epochs, ``"cpu"`` on the CPU for PACK_EPOCHS. Returns
    the weights it started from, its steps' metrics at full precision,
    its printed batch lines as ``(label, F1)``, its printed batch and
    validation lines, the state it ended in and its wall seconds."""
    name, kind, extra, run = job
    device, epochs = (("cpu", PACK_EPOCHS) if run == "cpu"
                      else (DEVICE, REPEAT_EPOCHS))
    mdl = os.path.join(work, f"{name}_run{run}")
    t0 = time.perf_counter()
    trace = pack.run_train(mdl, pack.train_args(
        data[kind], mdl, pack.CORPORA[kind]["map_size"], extra, epochs),
        device, timeout=900)
    with open(os.path.join(mdl, "stdout.log")) as f:
        text = f.read()
    weights, steps = pack.read_trace(trace)
    return dict(weights=weights, steps=steps,
                labels=_PACK_LINE.findall(text),
                printed=(_BATCH_TEXT.findall(text), _PACK_VAL.findall(text)),
                final=pack.read_final(trace),
                seconds=time.perf_counter() - t0)


def _leaf_gap(torch, a, b) -> float:
    """max |a - b| over the larger max |x| of the two (inf where a NaN or
    an infinity sits in one and not the other)."""
    a, b = a.double(), b.double()
    scale = max(float(a.abs().max()), float(b.abs().max()), 1e-30)
    return float((a - b).abs().nan_to_num(float("inf")).max()) / scale


def repeat_diffs(torch, name, a, b) -> list:
    """Phase 16: how two runs of one config (:func:`_pack_run`) differ:
    the first step whose full-precision metrics differ, the first printed
    line that differs, the first weight or Adam moment whose bytes
    differ (with its largest gap relative to its max |x|) and how many
    do; empty when the runs are bit-equal."""
    out = []
    steps = (a["steps"], b["steps"])
    if len(steps[0]) != len(steps[1]):
        out.append(f"{name}: {len(steps[0])} and {len(steps[1])} steps")
    for i, (sa, sb) in enumerate(zip(*steps)):
        if json.dumps(sa) != json.dumps(sb):
            out.append(f"{name}: step {i} of {len(steps[0])} differs first: "
                       f"{sa} against {sb}")
            break
    for what, la, lb in zip(("batch line", "validation line"),
                            a["printed"], b["printed"]):
        if la != lb:
            i = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
                     min(len(la), len(lb)))
            out.append(f"{name}: {what} {i} of {len(la)} differs first: "
                       f"{la[i:i + 1]} against {lb[i:i + 1]}")
    fa, fb = a["final"], b["final"]
    leaves = [(f"weight {k}", v, fb["model"][k])
              for k, v in fa["model"].items()]
    leaves += [(f"Adam {k} (flat)", fa["optimizer"][k], fb["optimizer"][k])
               for k in ("mu", "nu")]
    differ = [(what, x, y) for what, x, y in leaves
              if x.shape != y.shape or not torch.equal(
                  x.contiguous().view(-1).view(torch.uint8),
                  y.contiguous().view(-1).view(torch.uint8))]
    if differ:
        what, x, y = differ[0]
        gap = (_leaf_gap(torch, x, y) if x.shape == y.shape
               else float("inf"))
        out.append(f"{name}: {len(differ)} of {len(leaves)} final leaves "
                   f"differ in their bytes, the first {what} by up to "
                   f"{gap:.3g} of its max |x|; all: "
                   f"{[w for w, _x, _y in differ]}")
    if fa["optimizer"]["count"] != fb["optimizer"]["count"]:
        out.append(f"{name}: Adam's step counts {fa['optimizer']['count']}"
                   f" and {fb['optimizer']['count']}")
    return out


def pack_runs(torch, pack, phases, smi, bisect=False) -> dict:
    """The train CLI runs of phases 15 (c) and 16 (a), as one pool of
    PACK_WORKERS child processes (:func:`_pack_run`) on the pack's
    corpora (``build_corpus``, each built once): each config's card run
    0 (both phases), run 1 (phase 16) and CPU run (phase 15). ``bisect``
    (phase 16): first :func:`bisect_step` on each config. Returns the
    runs by ``(config, run)``."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    kinds = sorted({kind for _n, kind, _e in pack.CONFIGS})
    card_runs = (0, 1) if 16 in phases else (0,)
    cpu_runs = ("cpu",) if 15 in phases else ()
    with tempfile.TemporaryDirectory(prefix="prtp_pack_") as work:
        with ThreadPoolExecutor(len(kinds)) as pool:
            data = dict(zip(kinds, pool.map(
                lambda kind: pack.build_corpus(work, kind), kinds)))
        corpora_s = time.perf_counter() - t0
        if bisect and 16 in phases:
            for name, kind, extra in pack.CONFIGS:
                bisect_step(torch, pack, name, data[kind], kind, extra,
                            smi)
        t1 = time.perf_counter()
        # the longest runs (most designs, most epochs) first
        jobs = sorted(((name, kind, extra, run)
                       for name, kind, extra in pack.CONFIGS
                       for run in card_runs + cpu_runs),
                      key=lambda j: (-len(pack.CORPORA[j[1]].get(
                          "designs", ())), j[3] == "cpu"))
        with ThreadPoolExecutor(PACK_WORKERS) as pool:
            runs = dict(zip(((j[0], j[3]) for j in jobs), pool.map(
                lambda job: _pack_run(pack, work, data, job), jobs)))
    log(f"phases 15 (c) and 16 (a): {len(jobs)} train CLI runs "
        f"({len(card_runs)} a config on the card, {REPEAT_EPOCHS} epochs; "
        f"{len(cpu_runs)} on the cpu, {PACK_EPOCHS} epoch), "
        f"{PACK_WORKERS} at once, in {time.perf_counter() - t1:.1f} s; "
        f"corpora built in {corpora_s:.1f} s  [{smi}]")
    return runs


def repeat_phase(torch, np, dev, pack, runs, smi):
    """Phase 16: (a) the train CLI of every config of
    ``scripts/results_pack_torch.py`` twice on the card, REPEAT_EPOCHS
    epochs (``runs``: :func:`pack_runs`). The two runs must be bit for
    bit equal: every step's loss and metrics at full precision, the
    printed batch and validation lines, the final weights and flat
    Adam's moments by their bytes. Raises on a difference, naming the
    config, the first step and line that differ and the first leaf whose
    bytes differ. (b) :func:`deterministic_cost`."""
    bad = []
    for name, _kind, _extra in pack.CONFIGS:
        a, b = runs[(name, 0)], runs[(name, 1)]
        found = repeat_diffs(torch, name, a, b)
        bad += found
        log(f"phase 16: {name}: {len(a['steps'])} steps, loss "
            f"{a['steps'][0]['loss']!r} -> {a['steps'][-1]['loss']!r} and "
            f"{b['steps'][0]['loss']!r} -> {b['steps'][-1]['loss']!r}; "
            f"{'bit-equal' if not found else 'DIFFER'}; runs "
            f"{a['seconds']:.1f} s, {b['seconds']:.1f} s  [{smi}]")
    for b in bad:
        log(f"phase 16: DIFFERS {b}")
    if bad:
        raise AssertionError(f"phase 16: {len(bad)} differences between two "
                             f"runs on the card; the first: {bad[0]}")
    log(f"phase 16: {len(pack.CONFIGS)} configs' train CLIs twice on the "
        f"card, {REPEAT_EPOCHS} epochs, bit-equal  [{smi}]")
    t0 = time.perf_counter()
    deterministic_cost(torch, np, dev, smi)
    log(f"phase 16 (b): {time.perf_counter() - t0:.1f} s  [{smi}]")


def deterministic_cost(torch, np, dev, smi):
    """Phase 16 (b): what the CLIs' deterministic scope
    (``train.use_deterministic``) costs at full width, float32, TF32
    off, in turns (default, deterministic, deterministic, default): the
    headline reg train step and the U-Net's (the headline graph with a
    3 x UNET_HW x UNET_HW raster), each at all 597 paths (device time,
    queue pre-filled, and as launched; busy, idle share and launches
    under torch.profiler), and LayoutNet's forward + backward alone."""
    from prtp_tpu_torch.data.random_design import (bench_level_sizes,
                                                   make_random_design)
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.train import use_deterministic
    from prtp_tpu_torch.trainer import (init_state, make_optimizer,
                                        pad_batch, train_step)

    sizes = bench_level_sizes(NODES, LEVELS, decay=DECAY)
    kw = dict(cell_feat_dim=CELL_FEAT, net_feat_dim=NET_FEAT,
              map_size=MAP_SIZE, mask_nnz_per_path=MASK_NNZ, seed=SEED)
    rasters = {"reg": dict(cnn_hw=CNN_HW),
               "U-Net": dict(cnn_channels=UNET_CHANNELS, cnn_hw=UNET_HW)}
    models = {"reg": {}, "U-Net": dict(unet=True, cnn_channels=UNET_CHANNELS)}
    designs = {what: pack_design(make_random_design(sizes, **raster, **kw),
                                 map_size=MAP_SIZE, device=dev)
               for what, raster in rasters.items()}
    states = {what: init_state(PathModel(
        CELL_FEAT, NET_FEAT, map_size=MAP_SIZE,
        generator=torch.Generator().manual_seed(SEED), **extra),
        make_optimizer(LR), DEVICE) for what, extra in models.items()}
    n = designs["reg"].num_paths
    ids, mask = pad_batch(np.random.default_rng(0).permutation(n), n, dev)
    cnn, x = states["reg"].model.cnn, designs["reg"].cnn_input
    params = list(cnn.parameters())
    cot = torch.randn(cnn(x).shape, device=dev)
    timer = Timer(torch, dev)
    scopes = {"default": contextlib.nullcontext,
              "deterministic": use_deterministic}
    for turn, scope in enumerate(("default", "deterministic",
                                  "deterministic", "default")):
        with scopes[scope]():
            for what, state in states.items():
                t = step_timing(torch, dev, lambda: train_step(
                    state, designs[what], ids, mask), 200)
                log(f"phase 16 (b): turn {turn}, {scope}: {what} train step "
                    f"({n} paths) device time {t['device_ms']:.3f} ms; as "
                    f"launched {t['launched_ms']:.3f} ms; wall "
                    f"{t['wall_ms']:.3f} ms, device busy {t['busy_ms']:.3f} "
                    f"ms, idle share {t['idle']:.3f}; {t['launches']} kernel "
                    f"launches  [{smi}]")
                for name, (tot, cnt) in sorted(t["by_name"].items(),
                                               key=lambda kv: -kv[1][0])[:4]:
                    log(f"    {tot / 1e3:8.3f} ms  x{cnt:<4d} {name[:90]}")
            fb = timer.ms(lambda: torch.autograd.grad(cnn(x), params, cot),
                          queue_ms=20)
            log(f"phase 16 (b): turn {turn}, {scope}: LayoutNet forward + "
                f"backward {fb:.3f} ms  [{smi}]")


def bisect_step(torch, pack, name, data, kind, extra, smi):
    """Phase 16 ``--bisect``: one config's first train batch, forward and
    backward from the train CLI's starting weights, BISECT_REPS times in
    this process, under the CLIs' deterministic scope
    (``train.use_deterministic``) and without it
    (cuDNN's and PyTorch's defaults, TF32 off). Logs which
    of the walk's, the layout CNN's and the head's outputs, the
    cotangents reaching the walk's and the CNN's outputs, and the
    parameters' gradients differ in their bytes from the first rep."""
    from prtp_tpu_torch import train as cli
    from prtp_tpu_torch.data.dataset import get_design_list
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models.fusion import model_from_options
    from prtp_tpu_torch.options import get_options
    from prtp_tpu_torch.trainer import (init_state, loss_backward,
                                        make_optimizer, pad_batch)

    options = get_options(pack.train_args(
        data, "-", pack.CORPORA[kind]["map_size"], extra, 1))
    parsed = cli._load("train", options, get_design_list(data, "train")[0])
    design = pack_design(parsed, map_size=options.map_size, device=DEVICE)
    model = model_from_options(options, parsed["cell_feat"].shape[1],
                               parsed["net_feat"].shape[1],
                               parsed["cnn_input"].shape[-3])
    state = init_state(model, make_optimizer(options.learning_rate), DEVICE)
    ids, mask = pad_batch(parsed["path_ids"][:options.batch_size],
                          options.batch_size, DEVICE)
    seen = {}

    def keep(what):
        def hook(_module, _inputs, out):
            seen[what] = out.detach().clone()
            if out.requires_grad:
                out.register_hook(
                    lambda g: seen.__setitem__(f"d {what}", g.clone()))
        return hook

    for what in ("gnn", "cnn", "mlp_fuse"):
        if hasattr(model, what):
            getattr(model, what).register_forward_hook(keep(what))
    for scope, enter in (("deterministic", cli.use_deterministic),
                         ("default", contextlib.nullcontext)):
        reps = []
        with enter():
            for _ in range(BISECT_REPS):
                seen.clear()
                loss_backward(state, design, ids, mask, options.task)
                torch.cuda.synchronize()
                got = dict(seen)
                got.update((f"grad {k}", p.grad.detach().clone())
                           for k, p in model.named_parameters())
                reps.append(got)
        differ = {}
        for rep in reps[1:]:
            for k, v in rep.items():
                if not torch.equal(v.view(-1).view(torch.uint8),
                                   reps[0][k].view(-1).view(torch.uint8)):
                    differ[k] = max(differ.get(k, 0.0),
                                    _leaf_gap(torch, v, reps[0][k]))
        log(f"phase 16 (bisect): {name} [{scope}]: {BISECT_REPS} reps of "
            f"batch 0; differ from the first: "
            f"{ {k: f'{g:.3g}' for k, g in differ.items()} or 'none'}  "
            f"[{smi}]")


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Drive the PyTorch/CUDA port on one card (module doc).")
    ap.add_argument(
        "--phases", type=int, nargs="+", choices=range(3, 17),
        metavar="N", help="run only these phases (3-16) after the build "
        "(phase 2), then the kernels line and the last line; phase 14 "
        "runs on phase 9's designs, so naming 14 runs 9; phase 15 (c) "
        "reads the first epoch of phase 16 (a)'s first card runs, so "
        "naming 15 runs those. Without it every phase runs")
    ap.add_argument(
        "--bisect", action="store_true", help="phase 16 first runs each "
        "config's first batch several times in this process and logs "
        "which outputs, cotangents and gradients differ between passes")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    phases = set(range(3, 17) if args.phases is None else args.phases)
    if 14 in phases:
        phases.add(9)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.nn.functional as F
    from prtp_tpu_torch.ops import _build
    from prtp_tpu_torch.train import CUBLAS_WORKSPACE_CONFIG

    # PyTorch reads cuBLAS's workspace setting at the process's first
    # cuBLAS call, and phases 7, 10 and 16 enter the CLIs' deterministic
    # scope after earlier phases' matmuls: set it for the whole run
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE_CONFIG
    from prtp_tpu_torch.trainer import make_optimizer

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    tx = make_optimizer(LR)
    # ---- phase 1: the card ----
    smi = card_line()
    log(smi)
    compute_mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    log(f"compute mode {compute_mode}")
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN convolutions (float32 slice)")

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    writer_build = start_fixture_build()
    try:
        report = _build.build()
    except BaseException:
        writer_build[0].kill()
        writer_build[0].wait()
        raise
    early_writer, empty_launch = load_fixtures(writer_build)
    log(f"phase 2: built {len(report)} kernel libraries and the hazard "
        f"check's writer in {time.perf_counter() - t0:.1f} s")
    for name, info in report.items():
        usage = [ln.strip() for ln in info["log"].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        log(f"  {name}: {info['seconds']:.1f} s; " + " | ".join(usage))

    records, launches = [], {}
    if phases & set(range(3, 15)):
        records, launches = headline_phases(
            torch, F, np, dev, tx, smi, compute_mode, early_writer,
            empty_launch, phases)

    # ---- phase 15: the graft-style entry and the results pack ----
    if 15 in phases:
        launches.update(entry_phase(torch, np, dev, smi, compute_mode))
    # ---- phases 15 (c), 16: the pack configs' train CLI runs ----
    if phases & {15, 16}:
        t0 = time.perf_counter()
        pack = _pack_module()
        runs = pack_runs(torch, pack, phases, smi, args.bisect)
        if 15 in phases:
            pack_parity(pack, runs, smi)
        # ---- phase 16: the train CLI's runs repeat bit for bit ----
        if 16 in phases:
            repeat_phase(torch, np, dev, pack, runs, smi)
        log(f"phases 15 (c), 16: {time.perf_counter() - t0:.1f} s  [{smi}]")
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


def headline_phases(torch, F, np, dev, tx, smi, compute_mode, early_writer,
                    empty_launch, phases) -> tuple:
    """Phases 3-14 of ``phases`` (module doc), which share the headline
    and prior-row designs and the model built from seed 7. Returns the
    kernels line's records and each run's launch counts."""
    from prtp_tpu_torch.data.random_design import (bench_level_sizes,
                                                   make_random_design,
                                                   with_prior_net_drivers)
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel

    records, launches = [], {}
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
    num_paths = int(p0["num_paths"])
    if 3 in phases:
        records = kernels_phase(torch, F, dev, graphs, model_cpu, smi,
                                early_writer, empty_launch)
    del graphs

    # ---- phase 4: the slice ----
    if 4 in phases:
        log("phase 4: full-width PathModel, 3 evaluation requests on the "
            "headline and 1 on the prior-row design")
        model = copy.deepcopy(model_cpu).to(dev)
        launches.update({
            f"serve {name}": serve(torch, np, model, model_cpu, p, name,
                                   per_forward[name],
                                   REQUESTS if name == "headline" else 1)
            for name, p in parsed.items()})
        del model
        torch.cuda.empty_cache()

    # ---- phase 5: where one request's and one train step's time goes ----
    if 5 in phases:
        profile_phase(torch, np, dev, parsed, model_cpu, num_paths)
        torch.cuda.empty_cache()

    # ---- phase 6: training ----
    if 6 in phases:
        launches.update(train_phase(torch, np, dev, tx, parsed, model_cpu,
                                    per_step, num_paths))
        torch.cuda.empty_cache()

    # ---- phase 7: the CLIs ----
    if 7 in phases:
        launches.update(cli_phase(torch, np, dev, smi))

    # ---- phase 8: the variants ----
    if 8 in phases:
        launches.update(variants_phase(torch, np, dev, smi,
                                       parsed["headline"], sizes))
        precision_turns(torch, np, parsed["headline"], dev, smi)

    # ---- phase 9: the merged super-graph ----
    if 9 in phases:
        merged_launches, merged_shared = merged_phase(torch, np, dev, smi)
        launches.update(merged_launches)

    # ---- phase 10: data parallelism ----
    if 10 in phases:
        launches.update(dp_phase(torch, np, dev, smi, parsed["headline"],
                                 compute_mode))

    # ---- phase 11: the segment reduce and the (dp, gp) sharded step ----
    if 11 in phases:
        seg_records, seg_launches = segment_phase(
            torch, np, dev, smi, parsed["headline"], compute_mode,
            early_writer)
        records += seg_records
        launches.update(seg_launches)

    # ---- phase 12: --attn under the segment reduce ----
    if 12 in phases:
        attn_records, attn_launches = segment_attn_phase(
            torch, np, dev, smi, parsed["headline"], compute_mode,
            early_writer)
        records += attn_records
        launches.update(attn_launches)

    # ---- phase 13: bf16 under the segment reduce ----
    if 13 in phases:
        launches.update(segment_bf16_phase(torch, np, dev, smi,
                                           parsed["headline"], compute_mode))

    # ---- phase 14: the multi-design step ----
    if 14 in phases:
        launches.update(multi_phase(torch, np, dev, smi, merged_shared,
                                    compute_mode))

    return records, launches




def kernels_phase(torch, F, dev, graphs, model_cpu, smi, early_writer,
                  empty_launch) -> list:
    """Phase 3's checks of every kernel against its plain version on the
    headline and prior-row designs (module doc). Returns the JSON line's
    records of the mailbox walk's kernels and ``flat_adam``."""
    timer = Timer(torch, dev)
    recs = {}
    for name, g in graphs.items():
        log(f"  -- {name} --")
        recs[name] = check_kernels(torch, F, g, dev, timer, name)
        recs[name].update(check_backward_kernels(torch, g, dev, timer, name))
    recs["headline"]["flat_adam"] = check_flat_adam(
        torch, sum(p.numel() for p in model_cpu.parameters()), dev, timer)
    attn_recs = {}
    for nh in ATTN_HEADS:
        log(f"  -- headline, --attn --num_heads {nh} --")
        attn_recs[nh] = check_attn_kernels(torch, graphs["headline"], dev,
                                           timer, "headline", nh)
        attn_bwd_grids(torch, graphs["headline"], dev, timer, nh, smi)
    # the JSON line's attention records: the recorded config's one head
    recs["headline"].update(attn_recs[ATTN_HEADS[0]])
    floors = call_floors(torch, graphs["headline"], dev, timer)
    log("  per-call floor (one-row call, same timer): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in floors.items()))
    log("  the floor's parts (same timer): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in fixture_floors(
            torch, dev, timer, empty_launch).items()) + f"  [{smi}]")
    records = []
    for name, (_src, _rep, design) in KERNEL_INFO.items():
        if name in SEGMENT_KERNELS + SEGMENT_ATTN_KERNELS:  # phases 11, 12
            continue
        rec = recs[design][name]
        rec.floor_ms = floors[name]
        rec.max_abs_err = max(r[name].max_abs_err for r in recs.values()
                              if name in r)
        records.append(rec)
        log(f"  {rec.summary()}")
    for nh in ATTN_HEADS[1:]:
        for rec in attn_recs[nh].values():
            rec.floor_ms = floors[rec.name]
            log(f"  nh {nh}: {rec.summary()}")
    check_edge_shapes(torch, dev)
    check_backward_edge_shapes(torch, dev)
    check_attn_edge_shapes(torch, dev)
    check_attn_back_to_back(torch, dev)
    check_programmatic_hazard(torch, graphs["headline"], dev, early_writer)
    check_attn_hazard(torch, graphs["headline"], dev, early_writer)
    gather_probe(torch, dev, timer)
    del timer
    return records


def profile_phase(torch, np, dev, parsed, model_cpu, num_paths):
    """Phase 5: where one request's and one train step's time goes
    (module doc), on a copy of ``model_cpu`` on the card."""
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.test import evaluate
    from prtp_tpu_torch.trainer import pad_batch

    model = copy.deepcopy(model_cpu).to(dev)
    designs = {name: pack_design(p, map_size=MAP_SIZE, device=dev)
               for name, p in parsed.items()}
    design = designs["headline"]
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


def train_phase(torch, np, dev, tx, parsed, model_cpu, per_step,
                num_paths) -> dict:
    """Phase 6: training from one init on the card and on the CPU
    (module doc). Returns each run's launch counts."""
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.trainer import (batch_count, init_state,
                                        iterate_batches, pad_batch)

    launches = {}
    log(f"phase 6: full-width PathModel from the same init (seed {SEED}), "
        f"flat Adam at lr {LR}, on the card and on the cpu")
    cpu_designs = {name: pack_design(p, map_size=MAP_SIZE, device="cpu")
                   for name, p in parsed.items()}
    card_designs = {name: pack_design(p, map_size=MAP_SIZE, device=dev)
                    for name, p in parsed.items()}
    fixed = np.random.default_rng(0).permutation(num_paths)  # bench.py:308
    flips = {name: pool_winner_flips(torch, model_cpu.cnn, d.cnn_input, dev)
             for name, d in cpu_designs.items()}
    log(f"  LayoutNet max-pool windows whose winner differs, card vs cpu, "
        f"at the init: {flips}")
    cards = {}
    for name, d in cpu_designs.items():
        cards[name], signs = card_branches(torch, model_cpu.cnn, d.cnn_input,
                                           dev)
        log(f"  {name}: LayoutNet conv outputs whose sign differs, card vs "
            f"cpu, at the init: {signs}")
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
                        cpu_designs[name], batches_on("cpu"), what,
                        card=cards[name])
        compare_runs(torch, what, card, cpu, flips[name])
        if what.endswith("fixed batch") and not card[0][-1] < card[0][0]:
            raise AssertionError(f"{what}: the loss did not fall: {card[0]}")
    return launches


if __name__ == "__main__":
    sys.exit(main())
