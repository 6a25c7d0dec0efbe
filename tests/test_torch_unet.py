"""The port's U-Net layout branch (``--unet``) against the JAX package's:
each block in train and eval mode, BatchNorm's running averages, the
ConvTranspose weight rule, the weights bridge with ``batch_stats``, and
train steps of ``PathModel(unet=True)`` against JAX's
``make_train_step``, running averages included."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu import trainer as jtrainer
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu.models import unet as junet
from prtp_tpu_torch import test as port_test
from prtp_tpu_torch import trainer
from prtp_tpu_torch.data.random_design import make_random_design
from prtp_tpu_torch.graph import pack_design
from prtp_tpu_torch.models import PathModel, unet
from prtp_tpu_torch.ops import KERNELS
from prtp_tpu_torch.utils.convert import (batch_stats_to_flax,
                                          params_from_flax, params_to_flax)

from test_torch_convert import jax_params

TOL = 1e-5
MAP = 8  # the U-Net halves the raster: a 16 x 16 raster gives an 8 x 8 map
KW = dict(out_dim=16, hidden_dim=32, cnn_outdim=8, map_size=MAP,
          global_dim=8, unet=True)
LR, STEPS, BATCH = 1e-3, 5, 4


def _np(t):
    return np.asarray(t, np.float32)


def _nchw(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def _nhwc(x):
    return jnp.asarray(np.asarray(x).transpose(0, 2, 3, 1))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---- the blocks, in train and eval mode ----

def _blocks():
    """name -> (flax block, port block, input shapes NCHW): an odd raster
    side for Down and Up, so that the pool floors and Up pads."""
    gen = torch.Generator().manual_seed(0)
    return {
        "DoubleConv": (junet.DoubleConv(6), unet.DoubleConv(3, 6, gen),
                       [(2, 3, 9, 7)]),
        "Down": (junet.Down(6, "max"), unet.Down(4, 6, "max", gen),
                 [(2, 4, 9, 11)]),
        "Up": (junet.Up(5, 4), unet.Up(8, 5, gen),
               [(2, 8, 4, 5), (2, 4, 9, 11)]),
        "OutConv": (junet.OutConv(1, "avg"), unet.OutConv(4, 1, "avg", gen),
                    [(2, 4, 10, 6)]),
        "UNet": (junet.UNet("max"), unet.UNet(gen, "max", in_channels=3),
                 [(1, 3, 22, 18)]),
    }


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["DoubleConv", "Down", "Up", "OutConv",
                                  "UNet"])
def test_block_matches_flax(name, train):
    """Forward, the gradients of ``sum(out * cot)`` with respect to every
    parameter and input, and (train mode) the updated running averages,
    from jittered flax weights and running averages, rtol/atol 1e-5 (of
    each gradient's largest |g|). The whole U-Net's train-mode gradients
    pass 14 BatchNorms: there the port's float32 gradients lie within
    1.4e-5 of its float64 ones and JAX's within 8e-6, so the two are held
    to 5e-5 of each leaf's largest |g|."""
    jblock, block, shapes = _blocks()[name]
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jxs = [_nhwc(x) for x in xs]
    variables = jax.jit(jblock.init)(jax.random.PRNGKey(2), *jxs)
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    variables = jax.tree_util.tree_map(_np, jax.tree_util.tree_unflatten(
        treedef, [l + 0.1 * jax.random.normal(k, l.shape)
                  for l, k in zip(leaves, keys)]))
    params, stats = variables["params"], variables.get("batch_stats", {})
    out_shape = jax.eval_shape(
        lambda *a: jblock.apply(variables, *a, train=False), *jxs).shape
    cot = rng.standard_normal(out_shape).astype(np.float32)

    def loss(p, *a):
        v = {"params": p, "batch_stats": stats}
        if train:
            out, upd = jblock.apply(v, *a, train=True,
                                    mutable=["batch_stats"])
            new_stats = upd["batch_stats"]
        else:
            out, new_stats = jblock.apply(v, *a, train=False), stats
        return (out * cot).sum(), (out, new_stats)

    (_l, (want, want_stats)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(1 + len(xs))), has_aux=True))(params, *jxs)
    grad_tol = 5e-5 if name == "UNet" and train else TOL
    block.load_state_dict(params_from_flax(params, stats), strict=True)
    block.train(train)
    txs = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = block(*txs)
    (out * torch.from_numpy(_nchw(cot))).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _nchw(want), rtol=TOL,
                               atol=TOL)
    got_grads = params_to_flax({k: p.grad for k, p in
                                block.named_parameters()})
    want_grads = dict(_leaves(jax.tree_util.tree_map(_np, grads[0])))
    assert sorted(dict(_leaves(got_grads))) == sorted(want_grads)
    for key, g in _leaves(got_grads):
        w = want_grads[key]
        np.testing.assert_allclose(g, w, rtol=TOL,
                                   atol=grad_tol * np.abs(w).max(),
                                   err_msg=key)
    for x, g in zip(txs, grads[1:]):
        w = _nchw(g)
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=TOL,
                                   atol=grad_tol * np.abs(w).max())
    got_stats = dict(_leaves(batch_stats_to_flax(block.state_dict())))
    want_stats = dict(_leaves(jax.tree_util.tree_map(_np, want_stats)))
    assert sorted(got_stats) == sorted(want_stats)
    for key, w in want_stats.items():
        np.testing.assert_allclose(got_stats[key], w, rtol=TOL, atol=TOL,
                                   err_msg=key)
    if not train:
        for key, w in dict(_leaves(stats)).items():
            np.testing.assert_array_equal(got_stats[key], w, err_msg=key)


def test_batchnorm_running_stats_after_two_train_calls_match_flax():
    """The case of tests/test_tasks.py's momentum check: from the init's
    running averages, the same input twice in train mode. flax's update
    uses the biased batch variance; nn.BatchNorm2d's unbiased one would
    miss by the factor n / (n - 1) in the update."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 3, 8, 8)).astype(np.float32)
    jblock = junet.DoubleConv(4)
    v = jax.jit(functools.partial(jblock.init, train=True))(
        jax.random.PRNGKey(0), _nhwc(x))
    block = unet.DoubleConv(3, 4, torch.Generator().manual_seed(0))
    block.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(_np, v["params"]),
        jax.tree_util.tree_map(_np, v["batch_stats"])))
    block.train()
    stats = v["batch_stats"]
    for _ in range(2):
        _, upd = jblock.apply({"params": v["params"], "batch_stats": stats},
                              _nhwc(x), train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        block(torch.from_numpy(x))
    got = dict(_leaves(batch_stats_to_flax(block.state_dict())))
    want = dict(_leaves(jax.tree_util.tree_map(_np, stats)))
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=TOL, atol=1e-7,
                                   err_msg=key)
    # the biased variance: the running var moved from 1 by 0.19 of the
    # batch's biased variance minus 1, not of its unbiased one
    bn = block.BatchNorm_0
    h = block.Conv_0(torch.from_numpy(x)).detach()
    biased = h.var(dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_var, 0.81 + 0.19 * biased,
                               rtol=1e-5, atol=1e-6)
    assert not torch.allclose(
        bn.running_var, 0.81 + 0.19 * h.var(dim=(0, 2, 3)), rtol=1e-3)


@pytest.mark.parametrize("flip", [True, False], ids=["rule", "mutant"])
def test_conv_transpose_rule_needs_the_flip(flip):
    """flax's ConvTranspose (kernel (kh, kw, in, out)) equals
    ``F.conv_transpose2d`` only with the kernel flipped in space, as
    ``utils/convert.py`` maps it; without the flip the outputs differ."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 4, 5, 6)).astype(np.float32)
    import flax.linen as fnn
    conv = fnn.ConvTranspose(3, (2, 2), strides=(2, 2))
    v = jax.tree_util.tree_map(_np, jax.jit(conv.init)(
        jax.random.PRNGKey(0), _nhwc(x)))
    want = _nchw(conv.apply(v, _nhwc(x)))
    state = params_from_flax({"ConvTranspose_0": v["params"]})
    w = state["ConvTranspose_0.weight"]
    k = v["params"]["kernel"]
    assert tuple(w.shape) == (4, 3, 2, 2)
    if not flip:
        w = torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
    got = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x), w, torch.from_numpy(v["params"]["bias"].copy()),
        stride=2).numpy()
    assert got.shape == want.shape
    if flip:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        assert np.abs(got - want).max() > 0.1


# ---- PathModel(unet=True): the bridge, train steps, evaluation ----

@pytest.fixture(scope="module")
def unet_case():
    """A small random design with a 3 x 16 x 16 raster, a jittered JAX
    init (running averages jittered too; pooling adds no weight) and
    STEPS batches of BATCH paths (JAX's iterator, numpy seed 0)."""
    parsed = make_random_design([6, 6, 5, 5, 4, 4], cell_feat_dim=10,
                                net_feat_dim=3, map_size=MAP,
                                cnn_channels=3, cnn_hw=2 * MAP,
                                mask_nnz_per_path=6, seed=4)
    exact = jax_pack_design(parsed, map_size=MAP, exact_levels=True,
                            cnn_patches=False)
    variables = jax_params(JaxPathModel(**KW), exact,
                           jnp.arange(exact.num_paths, dtype=jnp.int32))
    rng = np.random.default_rng(0)
    batches = []
    while len(batches) < STEPS:
        batches += [(np.asarray(i), np.asarray(m)) for i, m in
                    jtrainer.iterate_batches(np.arange(parsed["num_paths"]),
                                             BATCH, rng)]
    return parsed, exact, variables, batches[:STEPS]


def _port(parsed, variables, pooling):
    model = PathModel(parsed["cell_feat"].shape[1],
                      parsed["net_feat"].shape[1], pooling=pooling,
                      cnn_channels=3, **KW)
    model.load_state_dict(params_from_flax(variables["params"],
                                           variables["batch_stats"]),
                          strict=True)
    return model


def test_round_trip_with_batch_stats_is_exact(unet_case):
    parsed, _e, variables, _b = unet_case
    state = _port(parsed, variables, "max").state_dict()
    assert sum(k.endswith("running_var") for k in state) == 14
    assert not any(k.endswith("num_batches_tracked") for k in state)
    for tree, back in ((variables["params"], params_to_flax(state)),
                       (variables["batch_stats"], batch_stats_to_flax(state))):
        want, got = dict(_leaves(tree)), dict(_leaves(back))
        assert sorted(got) == sorted(want)
        for key, val in want.items():
            assert got[key].shape == val.shape, key
            np.testing.assert_array_equal(got[key], val, err_msg=key)


def _port_flat(vec, params, model):
    """A vector of JAX's flat Adam (leaves of ``params`` in tree order) in
    the port's FlatAdam order (``model.parameters()``, torch layouts)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    parts, off = [], 0
    for leaf in leaves:
        parts.append(_np(vec[off: off + leaf.size]).reshape(leaf.shape))
        off += leaf.size
    state = params_from_flax(jax.tree_util.tree_unflatten(treedef, parts))
    return torch.cat([state[k].reshape(-1)
                      for k, _p in model.named_parameters()])


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_unet_train_steps_match_jax_make_train_step(unet_case, pooling):
    """STEPS steps of ``PathModel(unet=True)``, flat Adam, against JAX's
    ``make_train_step`` with ``make_flat_adam``, which threads
    ``batch_stats``, from a converted init (running averages jittered).
    Each port step starts from JAX's state before that step (parameters,
    running averages, Adam's moments and count), so that what one step
    rounds differently does not feed the next: Adam moves a weight by
    about LR whatever its gradient's size, so a gradient element near 0
    whose sign rounding flips moves by 2 x LR (here, with avg pooling,
    one weight of Down_1's Conv_1 at the first step), and the steps after
    it would see other weights. Each step's loss at rtol 1e-5; its
    gradients leaf by leaf at rtol 1e-4 and atol 5e-5 x the leaf's
    largest |g| (the block test's bound for the U-Net's BatchNorms); the
    running averages after it at 1e-5; the parameters after it at rtol
    1e-4 and atol 2e-5 where JAX's gradient lies above that rounding
    bound, and within 2 x LR where it does not. Then an evaluation of
    every path (eval mode, the running averages) at 1e-5."""
    parsed, exact, variables, batches = unet_case
    jmodel = JaxPathModel(pooling=pooling, **KW)
    tx = jtrainer.make_optimizer(LR, flat=True)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jtrainer.TrainState(
        params=params, batch_stats=variables["batch_stats"],
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        best_f1=jnp.zeros(()), best_r2=jnp.zeros(()))

    @jax.jit
    def jax_grads(p, stats, ids, mask):
        def loss_fn(q):
            preds, _s = jtrainer._forward(jmodel, q, stats, exact, ids,
                                          train=True)
            return jtrainer._task_loss_and_metrics("reg", preds, exact, ids,
                                                   mask)[0]
        return jax.grad(loss_fn)(p)

    step = jtrainer.make_train_step(jmodel, tx, donate=False)
    to_np = functools.partial(jax.tree_util.tree_map, _np)
    model = _port(parsed, variables, pooling)
    state = trainer.init_state(model, trainer.make_optimizer(LR), "cpu")
    design = pack_design(parsed, map_size=MAP, device="cpu")
    flipped = 0
    for t, (ids, mask) in enumerate(batches):
        jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
        grads = params_from_flax(to_np(jax_grads(jstate.params,
                                                 jstate.batch_stats, jids,
                                                 jmask)))
        model.load_state_dict(params_from_flax(to_np(jstate.params),
                                               to_np(jstate.batch_stats)))
        opt = jstate.opt_state
        state.optimizer.load_state_dict({
            "mu": _port_flat(opt["mu"], jstate.params, model),
            "nu": _port_flat(opt["nu"], jstate.params, model),
            "count": int(opt["count"])})
        jstate, jmets = step(jstate, exact, jids, jmask)
        mets = trainer.train_step(state, design,
                                  torch.from_numpy(ids.astype(np.int64)),
                                  torch.from_numpy(mask.copy()))
        np.testing.assert_allclose(float(mets["loss"]), float(jmets["loss"]),
                                   rtol=1e-5, err_msg=f"step {t}")
        want = params_from_flax(to_np(jstate.params),
                                to_np(jstate.batch_stats))
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        for key, p in model.named_parameters():
            g, w = p.grad.numpy(), grads[key].numpy()
            bound = 5e-5 * np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=bound,
                                       err_msg=f"step {t} grad {key}")
            sure = np.abs(w) > bound
            a, b = got[key].numpy(), want[key].numpy()
            np.testing.assert_allclose(a[sure], b[sure], rtol=1e-4,
                                       atol=2e-5, err_msg=f"step {t} {key}")
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR,
                                       err_msg=f"step {t} {key}")
            flipped += int((np.abs(a - b) > 2e-5 + 1e-4 * np.abs(b)).sum())
        for key in want:
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[key].numpy(),
                                           want[key].numpy(), rtol=1e-5,
                                           atol=1e-5,
                                           err_msg=f"step {t} {key}")
    assert flipped <= 10
    n = design.num_paths
    jpreds, _m = jtrainer.make_eval_step(jmodel)(
        jstate, exact, *jtrainer.pad_batch(np.arange(n), n))
    model.load_state_dict(params_from_flax(to_np(jstate.params),
                                           to_np(jstate.batch_stats)))
    preds, _m = port_test.evaluate(model, design,
                                   *trainer.pad_batch(np.arange(n), n, "cpu"))
    assert not model.training
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), rtol=1e-5,
                               atol=1e-5)
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_map_that_does_not_fit_raises(unet_case):
    """A raster whose side is not 2 x map_size fails where JAX fails (the
    fcn product), with both sizes named."""
    parsed = unet_case[0]
    model = PathModel(10, 3, cnn_channels=3, **dict(KW, map_size=4))
    design = pack_design(parsed, map_size=MAP, device="cpu")
    with pytest.raises(ValueError, match=r"\(16, 16\) to \(8, 8\).*map_size "
                                         r"is 4.*2 x map_size"):
        model(design, torch.arange(3))
