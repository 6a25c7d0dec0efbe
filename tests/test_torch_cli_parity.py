"""The port's CLIs against the JAX package's, on the CPU: (a) the
synthetic raw designs are the same files byte for byte, (b) generate
writes the same ``.npz`` arrays, (c) from one initial state, converted
from JAX's, both train CLIs print the same per-batch and validation
values and both test CLIs the same ``predict.txt`` row and
``predict_critical`` lists (``tests/_cli_parity.py``): here with the
default flags, with ``--attn --num_heads 2``, with ``--merge_designs``
and with ``--compute_dtype bfloat16`` under JAX's default flags (its
train steps take its padded scan). ``test_torch_cli_parity_tasks.py``
runs the classification task and the U-Net,
``test_torch_cli_parity_flags.py`` a set of non-default flags and
``--compute_dtype bfloat16 --exact_levels``.

Run as a script, the module measures how far the two packages' CLIs lie
apart on any flag set (:func:`_cli_parity.main`):

    PYTHONPATH=. python tests/test_torch_cli_parity.py [flag ...]
"""

import os
import sys

import numpy as np
import pytest

from prtp_tpu.data import generate as jax_generate
from prtp_tpu.data import synthetic as jax_synthetic
from prtp_tpu_torch.data import generate, synthetic

from _cli_parity import (CORPUS_ARGS, cli_runs_fixture,  # noqa: F401
                         corpus_data, main,
                         test_test_cli_writes_jax_predictions,
                         test_train_cli_prints_jax_values,
                         test_train_cli_saves_jax_config)

import _torch_threads  # noqa: F401  (one torch thread a worker)

cli_runs = cli_runs_fixture(["default", "attn", "merged", "bf16_default"])
BIG_KW = dict(num_paths=8, stages=4, grps=2)


def _files(root):
    out = {}
    for base, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Each package's synthetic raw data: the small corpus (by each
    ``synthetic.main``) and a small big-stress design, with libraries."""
    out = {}
    for name, mod in (("jax", jax_synthetic), ("port", synthetic)):
        corpus = str(tmp_path_factory.mktemp(f"{name}_corpus"))
        mod.main(["--out", corpus] + CORPUS_ARGS)
        big = str(tmp_path_factory.mktemp(f"{name}_big"))
        mod.write_libs(big)
        mod.generate_big_design(os.path.join(big, "big"), **BIG_KW)
        out[name] = {"corpus": corpus, "big": big}
    return out


@pytest.mark.parametrize("kind", ["corpus", "big"])
def test_synthetic_files_are_byte_equal(raw, kind):
    want, got = _files(raw["jax"][kind]), _files(raw["port"][kind])
    assert sorted(got) == sorted(want)
    assert len(want) > 5
    for rel in want:
        assert got[rel] == want[rel], rel


@pytest.fixture(scope="module")
def datasets(raw, tmp_path_factory):
    """Each package's generate on the port's raw data."""
    out = {}
    for name, mod in (("jax", jax_generate), ("port", generate)):
        for kind in ("corpus", "big"):
            data = str(tmp_path_factory.mktemp(f"{name}_{kind}_data"))
            mod.main(["--rawdata_path", raw["port"][kind],
                      "--data_save_path", data, "--map_size", "16"])
            out[name, kind] = data
    return out


@pytest.mark.parametrize("kind", ["corpus", "big"])
def test_generate_arrays_are_equal(datasets, kind):
    want_dir, got_dir = datasets["jax", kind], datasets["port", kind]
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    npz = [f for f in os.listdir(want_dir) if f.endswith(".npz")]
    assert npz
    for name in npz:
        with np.load(os.path.join(want_dir, name)) as want, \
                np.load(os.path.join(got_dir, name)) as got:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                assert got[key].dtype == want[key].dtype, (name, key)
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{name}:{key}")
    for lst in ("traindata_list.txt", "testdata_list.txt"):
        with open(os.path.join(want_dir, lst)) as a, \
                open(os.path.join(got_dir, lst)) as b:
            assert a.read() == b.read()


if __name__ == "__main__":
    main(sys.argv[1:])
