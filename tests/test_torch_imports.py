"""The PyTorch port stands alone: it imports neither JAX nor prtp_tpu, and
its entry points refuse to fall back to the CPU without being asked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a worker)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "prtp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "prtp_tpu")

_CHILD = """
import importlib, pkgutil, sys
import prtp_tpu_torch
for mod in pkgutil.walk_packages(prtp_tpu_torch.__path__, "prtp_tpu_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print("LOADED", len([m for m in sys.modules if m.startswith("prtp_tpu_torch")]))
print("BAD", bad)
"""


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _CHILD.format(forbidden=set(FORBIDDEN))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["LOADED"]) >= 15
    assert lines["BAD"] == "[]"


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO))
                                        for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py", "__graft_entry_torch__.py",
                            "scripts/results_pack_torch.py"])
def test_no_module_imports_jax_or_prtp_tpu(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_resolve_device_raises_without_a_card():
    from prtp_tpu_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda:0")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card, so the CUDA default is valid")
    from prtp_tpu_torch.data.random_design import make_random_design
    from prtp_tpu_torch.graph import pack_design
    from prtp_tpu_torch.models import PathModel
    from prtp_tpu_torch.test import evaluate_design, pad_batch
    parsed = make_random_design([4, 4, 4, 4], map_size=8, cnn_hw=16,
                                mask_nnz_per_path=4, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        pack_design(parsed, map_size=8)
    with pytest.raises(RuntimeError, match="cuda"):
        pad_batch(np.arange(3), 4)
    model = PathModel(36, 3, out_dim=8, hidden_dim=8, cnn_outdim=4,
                      map_size=8, global_dim=4)
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_design(model, parsed)
