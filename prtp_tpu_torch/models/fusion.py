"""PathModel — the multimodal fusion head.

Port of ``prtp_tpu/models/fusion.py::PathModel``: the effective
reference model ``(gnn, fcn, mlp_fuse, mlp_alpha)`` with one global
embedding width (64 by default). Forward, batched over path ids:

  h_gnn    = gnn(graph)[endpoints]
  h_cnn    = fcn(mask[p] * flatten(cnn(layout)))
  h_global = mlp_alpha(level_of_path)
  out      = mlp_fuse(concat(h_gnn, h_cnn, h_global))

``fcn`` is applied through the algebra ``fcn(mask * f) = mask @ (f ⊙ W)
+ b``, a plain product. On a merged super-graph
(``graph.merge_parsed_designs``) the path ids are ``(K, Bk)``, row k
holding design k's paths only: the K rasters run as one batched
convolution (the U-Net's BatchNorm takes its statistics over the K
rasters together) and row k reads feature map k, ``rows_k @ (f_k ⊙ W)
+ b`` (JAX's grouped head, ``prtp_tpu/models/fusion.py:97-150``).
The constructor draws the parameters with flax's initialisers (lecun
normal kernels, zero biases, a xavier-uniform ``fcn_kernel``) from the
``torch.Generator`` given; :func:`model_from_options` then draws the
JAX package's own weights for ``--seed`` (``utils/convert.py::
init_from_seed``). The port runs the regression and the
classification heads, LayoutNet or the U-Net, and the GNN's softmax or
``--attn`` cell reduce; ``gnn_reduce="segment"`` (JAX's default is
``"mailbox"``) walks the GNN over the flat edge tables, the reduce of
the 2-D ``(dp, gp)`` edge-sharded step (``parallel/graph_shard.py``),
with the softmax or the ``--attn`` cell reduce, in float32 or bf16.

``compute_dtype`` bfloat16 is JAX's mixed precision (flax style: the
parameters stay float32 and are cast for the products): the walk's MLP
products take bf16 operands and give float32 (the carry stays float32),
the layout CNN runs in bf16, the fcn head rounds ``f ⊙ W``, then
``mask @ (f ⊙ W)`` (each design's, on a merged super-graph), then the
bias sum to bf16, ``mlp_alpha`` and
``mlp_fuse`` are flax's bf16 ``Dense`` (``mlp.dense_bf16``), every part
is cast to bf16 before the concatenation, and the output back to
float32.

The walk has two bf16 roundings (``models/gnn.py``): JAX's fused exact
walk's (``rounding="fused"``) and its padded scan's (``"scan"``).
``forward``'s ``rounding`` picks one; its default, None, which
``trainer.train_step``, ``train_steps``, ``parallel.dp.dp_train_step``
and ``test.evaluate`` pass on unless told otherwise and
``parallel.graph_shard.graph_sharded_train_step`` always, lets the GNN
pick by its reduce: the fused walk's under the mailbox reduce, the
scan's under the segment reduce, the only rounding JAX has for it (a
bf16 segment model refuses ``"fused"``).
``test.evaluate_design`` defaults to ``"scan"``, as JAX's test CLI
evaluates through its padded scan.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.bf16 import BF16, compute_dtype_of, dense_bf16
from ..utils.convert import init_from_seed
from .gnn import TimeGNN
from .layoutnet import LayoutNet
from .mlp import MLP
from .unet import UNet


class PathModel(nn.Module):
    def __init__(self, cell_feat_dim: int, net_feat_dim: int, *,
                 use_gnn: bool = True, use_cnn: bool = True,
                 unet: bool = False, pooling: str = "max",
                 out_dim: int = 128, hidden_dim: int = 256,
                 cnn_outdim: int = 128, map_size: int = 128,
                 global_dim: int = 64, nlabels: int = 1,
                 flag_attn: bool = False, num_heads: int = 1,
                 dgl_parity: bool = True, gnn_reduce: str = "mailbox",
                 compute_dtype=None, cnn_channels: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not (use_gnn or use_cnn):
            raise ValueError("GNN and CNN model can not be both None!")
        dt = self.compute_dtype = compute_dtype_of(compute_dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.use_gnn = use_gnn
        self.gnn_reduce = gnn_reduce  # "segment": pack with segment=True
        self.use_cnn = use_cnn
        self.map_size = map_size
        self.unet = unet
        self.nlabels = nlabels
        if use_gnn:
            self.gnn = TimeGNN(cell_feat_dim, net_feat_dim, generator,
                               out_dim=out_dim, hidden_dim=hidden_dim,
                               dgl_parity=dgl_parity, flag_attn=flag_attn,
                               num_heads=num_heads, mlp_dtype=dt,
                               reduce_mode=gnn_reduce)
        if use_cnn:
            # flax infers the U-Net's input channels from the raster;
            # LayoutNet's Conv_0 takes 2
            self.cnn = (UNet(generator, pooling, cnn_channels, dt) if unet
                        else LayoutNet(generator, pooling, dt))
            # Linear(map^2 -> cnn_outdim) applied via the mask-row algebra
            msq = map_size * map_size
            self.fcn_kernel = nn.Parameter(torch.empty(msq, cnn_outdim))
            nn.init.xavier_uniform_(self.fcn_kernel, generator=generator)
            self.fcn_bias = nn.Parameter(torch.zeros(cnn_outdim))
        self.mlp_alpha = MLP(1, (global_dim * 2, global_dim), generator, dt)
        fuse_in = ((out_dim if use_gnn else 0)
                   + (cnn_outdim if use_cnn else 0) + global_dim)
        self.mlp_fuse = MLP(fuse_in, (fuse_in * 2, nlabels), generator, dt)

    def forward(self, design, path_ids: torch.Tensor,
                rounding: str | None = None, pair_sum=None) -> torch.Tensor:
        """Predict for a batch of path ids (any integer dtype): ``(B,)``,
        or ``(K, Bk)`` on a merged super-graph of K designs, row k holding
        only design k's path ids. ``rounding``: the walk's bf16 rounding
        (``"fused"``, ``"scan"`` or None, the reduce's:
        :meth:`TimeGNN.resolve_rounding`); ``pair_sum``: the walk's
        (:meth:`TimeGNN.forward`).

        Returns an output shaped like ``path_ids`` for ``nlabels == 1``,
        else ``path_ids.shape + (nlabels,)``."""
        flat_ids = path_ids.reshape(-1)
        parts = []
        if self.use_gnn:
            h = self.gnn(design.graph, rounding=rounding, pair_sum=pair_sum)
            parts.append(h.index_select(0, design.path_endpoint[flat_ids]))
        if self.use_cnn:
            parts.append(self._fcn(design, path_ids))
        levels = design.path_level[flat_ids]
        parts.append(self.mlp_alpha(levels[:, None].float()))
        if self.compute_dtype is not None:
            parts = [p.to(self.compute_dtype) for p in parts]
        out = self.mlp_fuse(torch.cat(parts, dim=-1))
        if self.nlabels == 1:
            out = out.squeeze(-1)
        return out.float().reshape(*path_ids.shape, *out.shape[1:])

    def _fcn(self, design, path_ids: torch.Tensor) -> torch.Tensor:
        """The layout branch, ``(B or K x Bk, cnn_outdim)``: the layout
        CNN over the design's K rasters, then ``rows_k @ (f_k ⊙ W) + b``
        for each raster k and its row of ids (one row of flat ids and one
        raster on a design packed alone)."""
        feat_map = self.cnn(design.cnn_input)
        k = feat_map.shape[0]
        if path_ids.dim() == 1 and k != 1:
            # JAX raises here too (prtp_tpu/models/fusion.py:141-144)
            raise ValueError(
                "merged super-graph designs (K CNN rasters) need grouped "
                f"path_ids of shape (K, Bk); got flat ids with {k} rasters")
        if path_ids.dim() == 2 and path_ids.shape[0] != k:
            raise ValueError(f"grouped path_ids {tuple(path_ids.shape)} "
                             f"need one row per raster, got {k} rasters")
        msq = self.fcn_kernel.shape[0]
        if feat_map[0].numel() != msq:
            # JAX fails here too, at the same product
            raise ValueError(
                f"the layout CNN maps the raster "
                f"{tuple(design.cnn_input.shape[2:])} to "
                f"{tuple(feat_map.shape[2:])}, but map_size is "
                f"{self.map_size}: the raster's side must be "
                f"{2 if self.unet else 4} x map_size")
        rows = design.path_masks[path_ids].to(feat_map.dtype).reshape(
            k, -1, msq)
        fmap = feat_map.reshape(k, msq, 1)
        if self.compute_dtype is None:
            fw = fmap * self.fcn_kernel  # (K, map^2, cnn_outdim)
            return (torch.bmm(rows, fw) + self.fcn_bias).reshape(
                -1, self.fcn_bias.shape[0])
        # fw rounded, each design's product rounded, the bias sum rounded
        fw = fmap * self.fcn_kernel.to(BF16)
        return torch.cat([dense_bf16(r, f.t(), self.fcn_bias)
                          for r, f in zip(rows, fw)])


def model_from_options(options, cell_feat_dim: int, net_feat_dim: int,
                       cnn_channels: int, draw: bool = True):
    """Build a PathModel from the parity CLI options (src/train.py:34-81).

    flax infers the feature widths and the U-Net's input channels at
    init, and JAX's ``model_from_options`` never reads
    ``--cell_feat_dim``; so here the caller passes the widths of the
    loaded design (after ``--feat_reduce``) and its raster's channel
    count. The weights are the JAX package's
    ``jax.jit(model.init)(PRNGKey(--seed), ...)``, bit for bit
    (``utils/convert.py::init_from_seed``). ``draw=False`` leaves the
    constructor's placeholder weights for a caller that loads a
    checkpoint over them, as JAX's ``init_state_abstract`` computes
    none."""
    nh = options.num_heads
    if nh > 1 and options.out_dim % nh != 0:
        raise ValueError(
            f"--num_heads {nh} must divide --out_dim {options.out_dim} "
            "(heads read disjoint out_dim/num_heads value slices)")
    model = PathModel(
        cell_feat_dim, net_feat_dim,
        compute_dtype=options.compute_dtype,
        use_gnn=not options.no_gnn,
        use_cnn=not options.no_cnn,
        unet=options.unet,
        pooling=options.pooling,
        out_dim=options.out_dim,
        hidden_dim=options.hidden_dim,
        cnn_outdim=options.cnn_outdim,
        map_size=options.map_size,
        nlabels=options.nlabels,
        flag_attn=options.attn,
        num_heads=options.num_heads,
        cnn_channels=cnn_channels,
    )
    return init_from_seed(model, options.seed) if draw else model
