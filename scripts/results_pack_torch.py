"""Train-to-convergence results pack of the PyTorch/CUDA port.

The counterpart of ``scripts/results_pack.py`` on ``prtp_tpu_torch``:
the same seven configurations (``CONFIGS``), corpora (``CORPORA``),
flags (``BASE``) and 150-epoch default, driven through the port's CLIs
(``prtp_tpu_torch.train`` / ``prtp_tpu_torch.test``, each in a clean
child process with the device passed to its ``main(argv, device=...)``)
on synthetic corpora built by the port's ``data.synthetic`` and
``data.generate``. Writes ``<out>/<config>/{summary.json, predict.txt,
config.json, visual/}`` and ``<out>/RESULTS.md``, which sets each
config's final row beside the JAX package's committed one
(``results/<config>/summary.json``, read as data) and names the device
and its power limit beside every time. Each config's summary is also
printed on stdout, one JSON line.

Each summary also holds the digests of every train step's metrics at
full precision and of the final weights and Adam moments, by which
``--compare`` says whether two packs repeat bit for bit.

Usage:  python scripts/results_pack_torch.py [--device cuda|cpu]
        [--work DIR] [--out DIR] [--epochs N] [--configs NAME ...]
        python scripts/results_pack_torch.py --compare OUT_A OUT_B

The default device is ``cuda``: without a card the pack raises.
"""

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RESULTS = os.path.join(REPO, "results")

BASE = ["--cnn_outdim", "8", "--out_dim", "16", "--hidden_dim", "32",
        "--batch_size", "64", "--learning_rate", "3e-3",
        "--cell_feat_dim", "13", "--net_feat_dim", "3"]

# the reference's 14-design corpus names ('ae18' is 'ae18core': the
# generate CLI skips a raw directory named 'ae18', as the reference does)
TOP14 = ("darkriscv", "sha3", "smallboom", "rocket", "xgate", "ae18core",
         "or1200", "hwacha", "steelcore", "tinyrocket", "chacha",
         "arm9", "r8051", "jpeg")

# (name, corpus, extra CLI flags). Corpus 'L': 2-channel 64px rasters ->
# LayoutNet's /4 pooling gives 16x16 maps. Corpus 'U': 3-channel 128px
# rasters -> the U-Net's /2 gives 64x64 maps. Corpus 'L14': the 14
# reference design names at different sizes.
CONFIGS = [
    ("reg_fusion", "L", []),
    ("reg_gnn_only", "L", ["--no_cnn"]),
    ("reg_cnn_only", "L", ["--no_gnn"]),
    ("reg_fusion_attn", "L", ["--attn"]),
    ("reg_fusion_unet", "U", ["--unet"]),
    ("cls_fusion", "L", ["--task", "cls", "--nlabels", "2"]),
    ("reg_fusion_14", "L14", []),
]

CORPORA = {
    "L": dict(cnn_channels=2, cnn_hw=64, map_size=16),
    "U": dict(cnn_channels=3, cnn_hw=128, map_size=64),
    "L14": dict(cnn_channels=2, cnn_hw=64, map_size=16, designs=TOP14),
}

# a config misses convergence where (its findings, RESULTS.md):
R2_SLACK = 0.05      # a reg config's final R2 below the JAX package's less this
LOSS_SHARE = 0.01    # its last per-batch loss not below this x its first

METRICS = ("loss", "r2", "acc", "recall", "precision", "f1")

_CHILD = ("import sys\nfrom prtp_tpu_torch import {mod}\n"
          "{mod}.main(sys.argv[1:], device={device!r})\n")

# the train CLI as _CHILD runs it, which also keeps, in the directory
# given first, the checkpoint it writes at creation (INITIAL, before a
# save overwrites it), every train step's metrics at full precision
# (STEPS: one dict a step) and the state it returns (FINAL: the weights
# and flat Adam's moments after the last step)
INITIAL, STEPS, FINAL = "initial.pt", "steps.json", "final.pt"
_TRACED_TRAIN = """
import json, os, shutil, sys
import torch
from prtp_tpu_torch import train
from prtp_tpu_torch.utils import checkpoint
trace = sys.argv.pop(1)
save, train_steps, steps = checkpoint.save_checkpoint, train.train_steps, []

def save_checkpoint(save_dir, *args, **kwargs):
    path = save(save_dir, *args, **kwargs)
    if not os.path.exists(os.path.join(trace, {initial!r})):
        shutil.copy(path, os.path.join(trace, {initial!r}))
    return path

def traced_steps(*args, **kwargs):
    mets = train_steps(*args, **kwargs)
    cols = {{k: v.tolist() for k, v in mets.items()}}
    steps.extend(dict(zip(cols, row)) for row in zip(*cols.values()))
    return mets

checkpoint.save_checkpoint, train.train_steps = save_checkpoint, traced_steps
os.makedirs(trace, exist_ok=True)
state = train.main(sys.argv[1:], device={device!r})
with open(os.path.join(trace, {steps!r}), "w") as f:
    json.dump(steps, f)
torch.save({{"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}},
           os.path.join(trace, {final!r}))
"""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_line(device) -> str:
    """The device every time of the pack was taken on: a card's name and
    power limit as ``nvidia-smi`` gives them, or the CPU."""
    if not device.startswith("cuda"):
        return "CPU (plain PyTorch versions)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def _run(cmd, timeout):
    proc = subprocess.run(cmd, env=_env(), cwd=REPO, timeout=timeout,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{' '.join(cmd[:3])} ... failed rc={proc.returncode}:\n"
            + proc.stdout.decode()[-3000:])
    return proc.stdout.decode()


def run_cli(mod, args, device, timeout):
    """The port's ``train`` or ``test`` CLI in a child process on
    ``device``; returns its output."""
    code = _CHILD.format(mod=mod, device=device)
    return _run([sys.executable, "-c", code] + args, timeout)


def run_train(mdl, args, device, timeout):
    """The train CLI as :func:`run_cli` runs it, in a fresh ``mdl`` (its
    ``--model_saving_dir``), traced into a fresh ``mdl + "_trace"``;
    returns the trace's directory (:func:`read_trace`)."""
    trace = mdl + "_trace"
    for path in (mdl, trace):
        shutil.rmtree(path, ignore_errors=True)
    code = _TRACED_TRAIN.format(device=device, initial=INITIAL, steps=STEPS,
                                final=FINAL)
    _run([sys.executable, "-c", code, trace] + args, timeout)
    return trace


def read_trace(trace):
    """``(state_dict, steps)`` of a :func:`run_train` trace: the model's
    weights as the train CLI started (on the host), and one dict of
    ``loss, r2, tp, fp, tn, fn`` a train step, in order."""
    import torch

    blob = torch.load(os.path.join(trace, INITIAL), map_location="cpu",
                      weights_only=True)
    with open(os.path.join(trace, STEPS)) as f:
        return blob["model"], json.load(f)


def read_final(trace):
    """The state a :func:`run_train` trace's CLI returned, on the host:
    ``{"model": state_dict, "optimizer": {"mu", "nu", "count"}}``."""
    import torch

    return torch.load(os.path.join(trace, FINAL), map_location="cpu",
                      weights_only=True)


def train_args(data, mdl, map_size, extra, epochs):
    """The train and test CLIs' arguments for one config of the pack."""
    return (["--data_save_path", data, "--model_saving_dir", mdl,
             "--map_size", str(map_size), "--num_epoch", str(epochs),
             "--val_interval", "50"] + BASE + extra)


def build_corpus(work, kind):
    from prtp_tpu_torch.data import synthetic

    raw = os.path.join(work, f"raw_{kind}")
    data = os.path.join(work, f"data_{kind}")
    if os.path.exists(os.path.join(data, "traindata_list.txt")):
        return data
    cfg = CORPORA[kind]
    # >= 30 paths a design: every 3rd synthetic path is critical and the
    # val split takes 1/5 of each class, so val keeps some criticals
    # (the cls task's best-F1 checkpoint needs them)
    synthetic.generate_corpus(
        raw, designs=cfg.get("designs", ("syn_a", "syn_b", "syn_c")),
        num_paths=30, depth=5,
        cnn_channels=cfg["cnn_channels"], cnn_hw=cfg["cnn_hw"])
    _run([sys.executable, "-m", "prtp_tpu_torch.data.generate",
          "--rawdata_path", raw, "--data_save_path", data,
          "--map_size", str(cfg["map_size"])], timeout=600)
    return data


_VAL_RE = re.compile(r"\toverall r2:([-\d.]+), rc:([-\d.]+), F1:([-\d.]+)")
_BATCH_RE = re.compile(
    r"e(\d+),\S+,b\d+/\d+, l:([-\d.]+), r2:([-\d.]+), r:[-\d.]+, "
    r"F1:([-\d.]+)")
_BATCH_LINE = re.compile(r"^e\d+,\S+,b\d+/\d+, ", re.M)


def parse_curve(stdout_log):
    """(batch lines, val rows) from a train ``stdout.log``: each batch
    line ``(epoch, loss, r2)``, each validation ``(r2, recall, F1)``.
    Raises where a batch line does not parse (a diverged run prints
    ``l:nan``) or there is none."""
    with open(stdout_log) as f:
        text = f.read()
    batches = [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
               for m in _BATCH_RE.finditer(text)]
    lines = len(_BATCH_LINE.findall(text))
    if not batches or len(batches) != lines:
        raise ValueError(f"{stdout_log}: {len(batches)} of {lines} batch "
                         "lines hold numbers")
    vals = [(float(m.group(1)), float(m.group(2)), float(m.group(3)))
            for m in _VAL_RE.finditer(text)]
    return batches, vals


def run_config(name, data, map_size, extra, epochs, out_root, device):
    mdl = os.path.join(out_root, name)
    args = train_args(data, mdl, map_size, extra, epochs)
    t0 = time.time()
    log(f"--- {name}: train ({epochs} epochs) on {device}")
    trace = run_train(mdl, args, device, timeout=7200)
    t_train = time.time() - t0
    t0 = time.time()
    log(f"--- {name}: eval on {device}")
    eval_out = run_cli("test", args, device, timeout=1200)
    t_eval = time.time() - t0
    runtimes = [float(m) for m in
                re.findall(r"case \d+, runtime: ([\d.e-]+)", eval_out)]
    batches, vals = parse_curve(os.path.join(mdl, "stdout.log"))
    with open(os.path.join(mdl, "predict.txt")) as f:
        final = [float(x) for x in f.read().strip().splitlines()[-1].split()]
    _weights, steps = read_trace(trace)
    return dict(name=name, flags=" ".join(extra) or "(default)",
                steps=len(batches), train_s=round(t_train, 1),
                eval_s=round(t_eval, 1),
                eval_runtimes=[round(t, 4) for t in runtimes],
                first_loss=batches[0][1], last_loss=batches[-1][1],
                last_loss_exact=steps[-1]["loss"], curve=vals,
                final=dict(zip(METRICS, final)),
                steps_sha256=steps_digest(steps),
                final_sha256=state_digest(read_final(trace)),
                model_dir=mdl, trace=trace)


def steps_digest(steps) -> str:
    """SHA-256 of a trace's steps (:func:`read_trace`): every train step's
    loss and metrics at full precision, in order."""
    return hashlib.sha256(json.dumps(steps).encode()).hexdigest()


def state_digest(blob) -> str:
    """SHA-256 of a :func:`read_final` state's bytes: every weight, by
    name, then flat Adam's two moments and its step count."""
    import torch

    h = hashlib.sha256()
    tensors = sorted(blob["model"].items()) + [
        (k, blob["optimizer"][k]) for k in ("mu", "nu")]
    for key, t in tensors:
        h.update(key.encode())
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy())
    h.update(str(blob["optimizer"]["count"]).encode())
    return h.hexdigest()


def repeat_diffs(out_a, out_b) -> list:
    """How two packs written to ``out_a`` and ``out_b`` differ: one line a
    config that only one ran, or whose steps (:func:`steps_digest`) or
    final state (:func:`state_digest`) are not bit-equal in both; empty
    when every config repeats."""
    names = [[n for n, _k, _e in CONFIGS if os.path.exists(
        os.path.join(out, n, "summary.json"))] for out in (out_a, out_b)]
    out = ([] if names[0] == names[1] else
           [f"the packs ran other configs: {names[0]} and {names[1]}"])
    for name in names[0]:
        if name not in names[1]:
            continue
        rows = []
        for root in (out_a, out_b):
            with open(os.path.join(root, name, "summary.json")) as f:
                rows.append(json.load(f))
        for key in ("steps_sha256", "final_sha256"):
            if rows[0].get(key) is None or rows[0].get(key) != rows[1].get(
                    key):
                out.append(f"{name}: {key} differs, last loss "
                           f"{rows[0].get('last_loss_exact')!r} and "
                           f"{rows[1].get('last_loss_exact')!r}")
    return out


def start_diffs(a, b):
    """How two train runs' starting weights (:func:`read_trace`'s state
    dicts) differ: one line a tensor that only one names or that is not
    bit-equal in both; empty when they are bit-equal."""
    import torch

    out = ([] if sorted(a) == sorted(b) else
           [f"starting weights name other tensors: "
            f"{sorted(set(a) ^ set(b))}"])
    for key in sorted(set(a) & set(b)):
        if not torch.equal(a[key], b[key]):
            diff = (a[key].double() - b[key].double()).abs().max()
            out.append(f"starting weight {key} differs by up to "
                       f"{float(diff):.6g}")
    return out


def cpu_start(name, data, map_size, extra, out_root, trace):
    """The config's train CLI for one epoch on the CPU, beside a run on a
    card whose trace is ``trace``: the CPU run's first per-batch loss
    (``cpu_first_loss``, as printed) and whether the two runs started
    from bit-equal weights (``cpu_start_equal``, :func:`start_diffs`)."""
    mdl = os.path.join(out_root, f"{name}_cpu")
    log(f"--- {name}: train (1 epoch) on cpu, the start beside the card's")
    cpu_trace = run_train(mdl, train_args(data, mdl, map_size, extra, 1),
                          "cpu", timeout=1200)
    batches, _vals = parse_curve(os.path.join(mdl, "stdout.log"))
    return dict(cpu_first_loss=batches[0][1], cpu_start_equal=not start_diffs(
        read_trace(trace)[0], read_trace(cpu_trace)[0]))


def jax_row(name):
    """The JAX package's committed summary of ``name``, or None."""
    path = os.path.join(JAX_RESULTS, name, "summary.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def findings(r, jax) -> list:
    """Where a config misses convergence: a reg config's final R2 more
    than R2_SLACK below JAX's, its last per-batch loss not below
    LOSS_SHARE x its first, ``cls`` F1 below JAX's."""
    out = []
    f = r["final"]
    if not r["last_loss"] < LOSS_SHARE * r["first_loss"]:
        out.append(f"per-batch loss {r['first_loss']:.3f} -> "
                   f"{r['last_loss']:.3f}, not below {LOSS_SHARE:g} x the "
                   "first")
    if jax is None:
        return out
    if r["name"].startswith("reg") and not (
            f["r2"] >= jax["final"]["r2"] - R2_SLACK):
        out.append(f"R2 {f['r2']:.3f} against JAX's "
                   f"{jax['final']['r2']:.3f}")
    if r["name"].startswith("cls") and not f["f1"] >= jax["final"]["f1"]:
        out.append(f"F1 {f['f1']:.3f} against JAX's "
                   f"{jax['final']['f1']:.3f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work", default=os.path.join(
        tempfile.gettempdir(), "prtp_results_torch_work"))
    ap.add_argument("--out", default=os.path.join(REPO, "results_torch"))
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--configs", nargs="+", default=None,
                    help="subset of config names to run")
    ap.add_argument("--compare", nargs=2, metavar="OUT",
                    help="train nothing: say whether the packs written to "
                    "these two --out directories repeat bit for bit")
    args = ap.parse_args(argv)
    if args.compare:
        diffs = repeat_diffs(*args.compare)
        for d in diffs:
            log(f"--- differs: {d}")
        print(json.dumps({"repeat": not diffs, "differ": diffs}), flush=True)
        return 1 if diffs else 0
    known = {name for name, _k, _e in CONFIGS}
    if args.configs and set(args.configs) - known:
        raise SystemExit(f"unknown configs {set(args.configs) - known}")
    sys.path.insert(0, REPO)
    import torch

    from prtp_tpu_torch import resolve_device
    resolve_device(args.device)
    where = device_line(args.device)
    os.makedirs(args.work, exist_ok=True)
    os.makedirs(args.out, exist_ok=True)

    t_pack, ran = time.time(), 0
    for name, kind, extra in CONFIGS:
        if args.configs and name not in args.configs:
            continue
        ran += 1
        data = build_corpus(args.work, kind)
        r = run_config(name, data, CORPORA[kind]["map_size"], extra,
                       args.epochs, args.work, args.device)
        r.update(epochs=args.epochs, device=where, torch=torch.__version__)
        if args.device != "cpu":
            r.update(cpu_start(name, data, CORPORA[kind]["map_size"], extra,
                               args.work, r["trace"]))
        keep = os.path.join(args.out, name)
        shutil.rmtree(keep, ignore_errors=True)
        os.makedirs(keep, exist_ok=True)
        for art in ("predict.txt", "config.json"):
            src = os.path.join(r["model_dir"], art)
            if os.path.exists(src):
                shutil.copy(src, keep)
        vis = os.path.join(r["model_dir"], "visual")
        if os.path.isdir(vis):
            shutil.copytree(vis, os.path.join(keep, "visual"))
        summary = {k: v for k, v in r.items()
                   if k not in ("model_dir", "trace")}
        with open(os.path.join(keep, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(summary), flush=True)
        log(f"--- {name}: final {r['final']}")

    rows = []
    for name, _kind, _extra in CONFIGS:
        summ = os.path.join(args.out, name, "summary.json")
        if os.path.exists(summ):
            with open(summ) as f:
                rows.append(json.load(f))
    write_results_md(args.out, rows)
    log(f"--- pack: {ran} configs in {time.time() - t_pack:.1f} s on {where}"
        " (the corpora, the train and eval runs and, on a card, each "
        "config's CPU epoch)")
    print(json.dumps({r["name"]: r["final"] for r in rows}), flush=True)


def _row(label, f):
    return (f"| {label} | {f['loss']:.3f} | {f['r2']:.3f} | {f['acc']:.3f} "
            f"| {f['recall']:.3f} | {f['precision']:.3f} | {f['f1']:.3f} |")


def write_results_md(out, rows):
    lines = [
        "# RESULTS (port) — train-to-convergence pack on prtp_tpu_torch",
        "",
        "Produced by `python scripts/results_pack_torch.py`, which drives",
        "the port's CLIs (`prtp_tpu_torch.train` / `prtp_tpu_torch.test`,",
        "each in a clean child process) on the synthetic corpora of",
        "`scripts/results_pack.py` (`prtp_tpu_torch.data.synthetic`),",
        "with its flags, configs and epochs. Each config's final row is",
        "set beside the JAX package's committed one",
        "(`results/<config>/summary.json`); the two start from different",
        "random weights (a torch `Generator` against a JAX `PRNGKey`), so",
        "their curves differ. On a card each config's train CLI also runs",
        "one epoch on the CPU of the same machine: its first loss stands",
        "beside the card's, both from the same weights (`models/mlp.py`",
        "draws them from the seed alone). Every time here is the port's,",
        "on the device named beside it. This file is regenerated from the",
        "`summary.json` files next to it; do not edit it by hand.",
        "",
        "## Final eval metrics (the `predict.txt` row of each config)",
        "",
        "| config, side | loss | R2 | acc | recall | precision | F1 |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        jax = jax_row(r["name"])
        lines.append(_row(f"{r['name']} `{r['flags']}`, port", r["final"]))
        lines.append(_row(f"{r['name']}, JAX (results/)", jax["final"])
                     if jax else f"| {r['name']}, JAX | no committed row "
                     "| | | | | |")
    lines += [
        "",
        "## Convergence",
        "",
        f"A config misses it where a reg config's final R2 lies more than "
        f"{R2_SLACK} below JAX's, its last per-batch loss is not below "
        f"{LOSS_SHARE} x its first, or `cls` has an F1 below JAX's.",
        "",
        "| config | epochs | batches | per-batch loss, first -> last | "
        "CPU's first loss (1 epoch, same start) | JAX's first -> last | "
        "misses |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        jax = jax_row(r["name"])
        miss = findings(r, jax)
        cpu = ("not run" if "cpu_first_loss" not in r else
               f"{r['cpu_first_loss']:.3f}" + (
                   "" if r["cpu_start_equal"] else
                   " (other starting weights)"))
        jax_curve = (f"{jax['first_loss']:.3f} -> {jax['last_loss']:.3f}"
                     if jax else "no committed row")
        lines.append(f"| {r['name']} | {r.get('epochs', '?')} | "
                     f"{r['steps']} | {r['first_loss']:.3f} -> "
                     f"{r['last_loss']:.3f} | {cpu} | {jax_curve} | "
                     f"{'; '.join(miss) or 'none'} |")
    lines += [
        "",
        "## Times and learning curves",
        "",
        "Validation fires every 50 train batches and at each design's",
        "last (`--val_interval 50`); its rows are (R2, recall, F1)",
        "averaged over the designs' val splits.",
        "",
    ]
    for r in rows:
        lines.append(f"### {r['name']}  (`{r['flags']}`)")
        lines.append("")
        lines.append(f"- train: {r['steps']} batches"
                     f" ({r.get('epochs', '?')} epochs) in {r['train_s']} s,"
                     f" eval {r['eval_s']} s (each a child process, its"
                     f" start included), on {r['device']}, PyTorch "
                     f"{r.get('torch', 'not recorded')}")
        rts = r.get("eval_runtimes") or []
        if rts:
            lines.append(
                f"- per-design eval runtime over {len(rts)} designs: "
                f"mean {sum(rts) / len(rts):.4f} s, max {max(rts):.4f} s, "
                f"min {min(rts):.4f} s, on {r['device']}")
        lines.append("")
        lines.append("| val # | R2 | recall | F1 |")
        lines.append("|---|---|---|---|")
        curve = r["curve"]
        # first 3, every 5th, last 3
        idx = sorted(set(list(range(min(3, len(curve))))
                         + list(range(0, len(curve), 5))
                         + list(range(max(0, len(curve) - 3), len(curve)))))
        for i in idx:
            v = curve[i]
            lines.append(f"| {i} | {v[0]:.3f} | {v[1]:.3f} | {v[2]:.3f} |")
        lines.append("")
    with open(os.path.join(out, "RESULTS.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    log(f"wrote {os.path.join(out, 'RESULTS.md')}")


if __name__ == "__main__":
    sys.exit(main())
