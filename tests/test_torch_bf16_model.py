"""``--compute_dtype bfloat16`` in the port against the JAX package's
bfloat16, on the CPU: the layout CNNs layer by layer, the whole model
(its parts and its head on JAX's own parts) and five train steps, by
the rules of ``tests/test_torch_bf16.py`` (``REL_GAP`` x JAX's own
bf16-to-float32 distance where a comparison could be loose).

JAX runs op by op here (``apply`` outside ``jax.jit``), so that each
module's output is rounded where flax declares it, and each value JAX
captures is the value its next operation read. Under ``jax.jit`` XLA
may keep a fused intermediate in float32 past such a point (excess
precision, its default): a jitted U-Net ``DoubleConv`` in eval mode
lies 0.68 x the bf16-to-float32 distance from the same block op by op
(``tests/test_torch_bf16.py::test_jax_bf16_is_not_one_function``).
The train steps run JAX's own jitted ``make_train_step``, as its CLI
does.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from prtp_tpu import trainer as jtrainer
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu_torch import trainer
from prtp_tpu_torch.data.random_design import make_random_design
from prtp_tpu_torch.graph import pack_design
from prtp_tpu_torch.models import PathModel
from prtp_tpu_torch.ops.pool import pool_2x2
from prtp_tpu_torch.utils.convert import params_from_flax

from test_torch_bf16 import (BF, _differ, _nchw, _nhwc, _np,
                             assert_near_jax_bf16, no_launches)  # noqa: F401
from test_torch_convert import jax_params

LR, STEPS, BATCH = 1e-3, 5, 4
MODEL_KW = dict(out_dim=16, hidden_dim=32, cnn_outdim=8, map_size=16,
                global_dim=8)


# ---- the layout CNNs, layer by layer ----

def _jittered(module, *xs):
    variables = jax.jit(module.init)(jax.random.PRNGKey(2), *xs)
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_unflatten(
        treedef, [l + 0.1 * jax.random.normal(k, l.shape, l.dtype)
                  for l, k in zip(leaves, keys)]))


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_layoutnet_bf16_layers_match_flax(pooling):
    """The bf16 LayoutNet against flax's ``LayoutNet(dtype=bfloat16)``,
    each conv on JAX's own bf16 input to it (its raster, or the pool and
    activation of JAX's conv before, which the port computes bit for bit
    as JAX does): each output within REL_GAP x the distance between the
    flax conv in bf16 and in float32 on that input. Layer by layer,
    because a float32 sum taken in another order flips about one output
    in 30,000 by an ulp, and a flipped input moves the sums of the next
    layer: over four layers a sixth of the map ends an ulp apart, about
    a tenth of float32's own distance. Then the whole net, map within 1
    bf16 ulp of max |map|."""
    from prtp_tpu.models.layoutnet import LayoutNet as JaxLayoutNet
    from prtp_tpu_torch.models import LayoutNet

    rng = np.random.default_rng(3)
    x = rng.random((1, 64, 64, 2), dtype=np.float32)
    variables = _jittered(JaxLayoutNet(pooling), jnp.asarray(x))
    want, st = JaxLayoutNet(pooling, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x), capture_intermediates=True,
        mutable=["intermediates"])
    outs = {k: v["__call__"][0] for k, v in st["intermediates"].items()
            if k.startswith("Conv_")}
    net = LayoutNet(torch.Generator(), pooling, compute_dtype=BF)
    state = params_from_flax({"cnn": variables["params"]})
    net.load_state_dict({k[len("cnn."):]: t for k, t in state.items()})
    p = variables["params"]
    inp = torch.tensor(_nchw(x)).to(BF)
    for k in range(4):
        name = f"Conv_{k}"
        width = p[name]["kernel"].shape[0]
        flax_conv = nn.Conv(p[name]["kernel"].shape[-1], (width, width),
                            padding="SAME")
        x_k = jnp.asarray(_nhwc(_np(inp)))
        want32 = flax_conv.apply({"params": p[name]}, x_k)
        with torch.no_grad():
            got = getattr(net, name)(inp)
        assert got.dtype == BF
        assert_near_jax_bf16(got, _nchw(outs[name]), _nchw(want32), name)
        act = F.relu(torch.tensor(_nchw(outs[name])).to(BF))
        inp = pool_2x2(act, pooling) if k < 2 else act
    with torch.no_grad():
        got = net(torch.tensor(_nchw(x)))
    assert got.dtype == BF
    scale = _bf16_ulp(float(np.abs(_np(want)).max()))
    assert float(np.abs(_np(got) - _nchw(want)).max()) <= scale


def _unet_blocks(dt):
    from prtp_tpu.models import unet as junet
    from prtp_tpu_torch.models import unet
    gen = torch.Generator().manual_seed(0)
    jdt = jnp.bfloat16 if dt else None
    return {
        "DoubleConv": (junet.DoubleConv(6, dtype=jdt),
                       unet.DoubleConv(3, 6, gen, dt), [(2, 3, 16, 16)]),
        "Down": (junet.Down(6, "max", dtype=jdt),
                 unet.Down(4, 6, "max", gen, dt), [(2, 4, 17, 15)]),
        "Up": (junet.Up(5, 4, dtype=jdt), unet.Up(8, 5, gen, dt),
               [(2, 8, 8, 7), (2, 4, 17, 15)]),
        "OutConv": (junet.OutConv(1, "avg", dtype=jdt),
                    unet.OutConv(4, 1, "avg", gen, dt), [(2, 4, 16, 16)]),
    }


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["DoubleConv", "Down", "Up", "OutConv"])
def test_unet_block_bf16_matches_flax(name, train):
    """Each bf16 U-Net block (odd sides for Down and Up: the pool floors,
    Up pads) against flax's with ``dtype=bfloat16``, from jittered
    weights and running averages, in train and eval mode: the output
    within REL_GAP x flax's bf16-to-float32 distance, and at most 1 in
    1,000 elements an ulp apart. The U-Net joins these blocks as in
    float32 (``tests/test_torch_unet.py``); the whole bf16 U-Net runs in
    ``test_bf16_model_matches_jax``."""
    jblock, _b, shapes = _unet_blocks(None)[name]
    jblock16, block, _s = _unet_blocks(BF)[name]
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jxs = [jnp.asarray(_nhwc(x)) for x in xs]
    variables = _jittered(jblock, *jxs)
    out = {}
    for dt, m in (("bf16", jblock16), ("f32", jblock)):
        if train:
            out[dt] = m.apply(variables, *jxs, train=True,
                              mutable=["batch_stats"])[0]
        else:
            out[dt] = m.apply(variables, *jxs, train=False)
    block.load_state_dict(params_from_flax(variables["params"],
                                           variables.get("batch_stats", {})),
                          strict=True)
    block.train(train)
    with torch.no_grad():
        got = block(*[torch.from_numpy(x) for x in xs])
    assert got.dtype == BF
    want = _nchw(out["bf16"])
    assert_near_jax_bf16(got, want, _nchw(out["f32"]), name)
    assert _differ(got, want) <= want.size // 1000


# ---- the whole model ----

def _wide_parsed(unet=False):
    """A design of 120 paths (the last two net levels' 60 endpoints
    each), so that a head output an ulp apart is one of many."""
    if unet:
        return make_random_design([12, 12, 10, 60, 10, 60], cell_feat_dim=10,
                                  net_feat_dim=3, map_size=8, cnn_channels=3,
                                  cnn_hw=16, mask_nnz_per_path=6, seed=4)
    return make_random_design([12, 12, 10, 60, 10, 60], cell_feat_dim=10,
                              net_feat_dim=3, map_size=16, cnn_hw=64,
                              mask_nnz_per_path=10, seed=2)


# each variant: (PathModel keywords beyond MODEL_KW, the port's extra
# keywords, the task)
VARIANTS = {
    "reg": ({}, {}, "reg"),
    "cls": (dict(nlabels=2), {}, "cls"),
    "unet": (dict(unet=True, map_size=8), dict(cnn_channels=3), "reg"),
    "attn": (dict(flag_attn=True, num_heads=2), {}, "reg"),
    "no_cnn": (dict(use_cnn=False), {}, "reg"),
    "no_gnn": (dict(use_gnn=False), {}, "reg"),
    "avg": (dict(pooling="avg"), {}, "reg"),
}


@functools.lru_cache(maxsize=None)
def _model_case(name):
    """The variant's design (parsed, JAX's exact float32 pack), its
    keywords and a jittered JAX init (float32 parameters, as JAX keeps
    them under any compute dtype)."""
    kw, port_kw, task = VARIANTS[name]
    kw = dict(MODEL_KW, **kw)
    parsed = _wide_parsed(kw.get("unet", False))
    exact = jax_pack_design(parsed, map_size=kw["map_size"],
                            exact_levels=True, cnn_patches=False)
    variables = jax_params(JaxPathModel(**kw), exact,
                           jnp.arange(exact.num_paths, dtype=jnp.int32))
    return parsed, exact, kw, port_kw, task, variables


def _port_model(parsed, kw, port_kw, variables, dtype="bfloat16"):
    model = PathModel(parsed["cell_feat"].shape[1],
                      parsed["net_feat"].shape[1], compute_dtype=dtype,
                      **kw, **port_kw)
    model.load_state_dict(params_from_flax(variables["params"],
                                           variables.get("batch_stats")))
    return model


def _bf16_ulp(x):
    """One bf16 ulp at ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


class _Fixed(torch.nn.Module):
    """Stands in for a part of the model: returns ``value`` whatever it
    is given."""

    def __init__(self, value):
        super().__init__()
        self.value = value

    def forward(self, *_args, **_kwargs):
        return self.value


@pytest.mark.parametrize("name", list(VARIANTS))
def test_bf16_model_matches_jax(name):
    """``PathModel(compute_dtype="bfloat16")`` against JAX's
    ``PathModel(compute_dtype=jnp.bfloat16)`` from one converted init, on
    every path of a 120-path design (the U-Net's BatchNorm in train
    mode). The predictions are float32, within 4 bf16 ulps of max |out|
    of JAX's bf16 (measured 0-3: an element whose float32 sum was taken
    in another order rounds an ulp the other way and moves what follows,
    through the layout CNN most; JAX's float32 lies 0.9-6.9 ulps away,
    so this bound alone could not tell a misplaced rounding). In the
    U-Net's train mode a BatchNorm whose batch holds one element an ulp
    apart moves its statistics, and so every element of its channel, by
    a hair, and some flip: through 14 BatchNorms much of its map ends an
    ulp apart. The parts of one forward, each within REL_GAP x JAX's own
    bf16-to-float32 distance: the walk's h and
    ``mlp_alpha``'s output; and the head (the fcn products, the casts,
    the concatenation and ``mlp_fuse``) run by the port on JAX's bf16
    parts (its layout map and h) against JAX's predictions. The layout
    CNNs are held layer by layer above."""
    parsed, exact, kw, port_kw, _task, variables = _model_case(name)
    train = kw.get("unet", False)
    pids = jnp.arange(exact.num_paths, dtype=jnp.int32)
    out, parts = {}, {}
    for dt in (jnp.bfloat16, None):
        model = JaxPathModel(compute_dtype=dt, **kw)
        out[dt], st = model.apply(
            variables, exact, pids, train=train,
            capture_intermediates=lambda m, _n: m.name in (
                "gnn", "cnn", "mlp_alpha"),
            mutable=["intermediates", "batch_stats"])
        parts[dt] = {k: v["__call__"][0]
                     for k, v in st["intermediates"].items()}
        assert out[dt].dtype == jnp.float32
    port = _port_model(parsed, kw, port_kw, variables).train(train)
    design = pack_design(parsed, map_size=kw["map_size"], device="cpu")
    ids = torch.arange(design.num_paths)
    with torch.no_grad():
        got = port(design, ids)
        got_parts = {"mlp_alpha": port.mlp_alpha(design.path_level[:, None])}
        if "gnn" in parts[None]:
            got_parts["gnn"] = port.gnn(design.graph)
    assert got.dtype == torch.float32
    want = np.asarray(out[jnp.bfloat16])
    ulp = _bf16_ulp(float(np.abs(want).max()))
    worst = float(np.abs(_np(got) - want).max())
    assert worst <= 4 * ulp, f"{worst / ulp} ulps"
    for key, val in got_parts.items():
        assert_near_jax_bf16(val, parts[jnp.bfloat16][key],
                             parts[None][key], key)
    if "cnn" in parts[None]:
        port.cnn = _Fixed(torch.tensor(_nchw(parts[jnp.bfloat16]["cnn"]))
                          .to(BF))
    if "gnn" in parts[None]:
        port.gnn = _Fixed(torch.tensor(np.asarray(parts[jnp.bfloat16]["gnn"])))
    with torch.no_grad():
        head = port(design, ids)
    assert_near_jax_bf16(head, want, out[None], "head")


# ---- training ----

def _jax_state(params, tx, stats=None):
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return jtrainer.TrainState(
        params=params, batch_stats=stats or {}, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), best_f1=jnp.zeros(()),
        best_r2=jnp.zeros(()))


def _port_flat(vec, params, model):
    """JAX's flat Adam vector (the leaves of ``params`` in tree order) in
    the port's FlatAdam order and layouts."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    parts, off = [], 0
    for leaf in leaves:
        parts.append(np.asarray(vec[off: off + leaf.size]).reshape(
            leaf.shape))
        off += leaf.size
    state = params_from_flax(jax.tree_util.tree_unflatten(treedef, parts))
    return torch.cat([state[k].reshape(-1)
                      for k, _p in model.named_parameters()])


@pytest.mark.parametrize("name", ["reg", "attn"])
def test_bf16_train_steps_match_jax_make_train_step(name):
    """STEPS steps of the bf16 model (flat Adam) against JAX's
    ``make_train_step`` with ``make_flat_adam`` on its bf16 model. Each
    port step starts from JAX's state before it (parameters and Adam's
    moments and count): Adam moves a weight by about LR whatever its
    gradient's size, so a gradient element whose sign rounding flips
    would take free runs apart. Each step's loss within rtol 1e-5 of
    JAX's bf16 loss (measured: equal) and within REL_GAP x its distance
    from JAX's float32 loss at the same state. The first step's
    gradients: the walk's leaves within REL_GAP x JAX's bf16-to-float32
    distance; every leaf within 0.1 x its max |g| and every weight of a
    product within 0.02 x (measured 0.057 and 0.0095: the transpose of a
    broadcast, a bf16 bias's gradient or the fcn map's cotangent, is a
    sum that XLA takes in bf16 and the port in float32); the parameters,
    the gradients and Adam's state stay float32."""
    parsed, exact, kw, port_kw, task, variables = _model_case(name)
    tx = jtrainer.make_optimizer(LR, flat=True)
    models = {dt: JaxPathModel(compute_dtype=dt, **kw)
              for dt in (jnp.bfloat16, None)}
    steps = {dt: jtrainer.make_train_step(m, tx, task, donate=False)
             for dt, m in models.items()}

    def jax_grads(dt, p, ids, mask):
        def loss_fn(q):
            preds = models[dt].apply({"params": q}, exact, ids)
            return jtrainer._task_loss_and_metrics(task, preds, exact, ids,
                                                   mask)[0]
        return params_from_flax(jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss_fn))(p)))

    rng = np.random.default_rng(0)
    batches = []
    while len(batches) < STEPS:
        batches += [(np.asarray(i), np.asarray(m)) for i, m in
                    jtrainer.iterate_batches(np.arange(parsed["num_paths"]),
                                             BATCH, rng)]
    model = _port_model(parsed, kw, port_kw, variables)
    state = trainer.init_state(model, trainer.make_optimizer(LR), "cpu")
    design = pack_design(parsed, map_size=kw["map_size"], device="cpu",
                         compute_dtype=BF)
    jstate = _jax_state(variables["params"], tx)
    for t, (ids, mask) in enumerate(batches[:STEPS]):
        jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
        to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
        model.load_state_dict(params_from_flax(to_np(jstate.params)))
        opt = jstate.opt_state
        state.optimizer.load_state_dict({
            "mu": _port_flat(opt["mu"], jstate.params, model),
            "nu": _port_flat(opt["nu"], jstate.params, model),
            "count": int(opt["count"])})
        if t == 0:
            want = {dt: jax_grads(dt, jstate.params, jids, jmask)
                    for dt in models}
        loss32 = float(steps[None](jstate, exact, jids, jmask)[1]["loss"])
        jstate, jmets = steps[jnp.bfloat16](jstate, exact, jids, jmask)
        mets = trainer.train_step(state, design,
                                  torch.from_numpy(ids.astype(np.int64)),
                                  torch.from_numpy(mask.copy()), task)
        loss, want_loss = float(mets["loss"]), float(jmets["loss"])
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5,
                                   err_msg=f"step {t}")
        assert_near_jax_bf16(np.float32(loss), np.float32(want_loss),
                             np.float32(loss32), f"step {t} loss")
        if t == 0:
            for key, p in model.named_parameters():
                assert p.dtype == p.grad.dtype == torch.float32, key
                w16 = _np(want[jnp.bfloat16][key])
                bound = (0.02 if p.ndim > 1 else 0.1) * np.abs(w16).max()
                np.testing.assert_allclose(_np(p.grad), w16, rtol=0,
                                           atol=bound, err_msg=key)
                if key.startswith("gnn."):
                    assert_near_jax_bf16(p.grad, w16, want[None][key],
                                         f"gradient of {key}")
    assert state.optimizer.flat.dtype == state.optimizer.mu.dtype == \
        torch.float32
