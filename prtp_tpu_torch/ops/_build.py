"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``; no PyTorch header is compiled, so a build takes seconds.
Libraries are built at first use — never at import — from the sources
in this package only, into ``prtp_tpu_torch/_build/`` (git-ignored),
under a name that hashes the sources and flags, so an edit rebuilds.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
all of them. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_NAMES = ("gather_rows", "softmax_sum", "local_mean", "softmax_sum_bwd",
                "mailbox_scatter", "flat_adam", "attn_sum", "attn_bwd",
                "segment_softmax_sum", "segment_mean",
                "segment_softmax_sum_bwd", "segment_attn_sum",
                "segment_attn_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, the standard install prefix, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in (SRC_DIR / f"{name}.cu", SRC_DIR / "common.cuh"):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names=KERNEL_NAMES) -> dict:
    """Compile every library of ``names`` not built yet, in parallel.

    Returns ``{name: {"seconds": s, "log": ptxas report}}`` for the
    libraries compiled by this call."""
    unknown = set(names) - set(KERNEL_NAMES)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, target, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch(name: str, argtypes, *args, entry: str | None = None) -> None:
    """Call ``<entry>_launch(*args)`` (``entry`` defaults to ``name``) of
    kernel ``name``'s library and raise if it returns a CUDA error.
    Pointers and the stream are passed as ``c_void_p`` (Python ints), so
    ctypes never truncates them."""
    lib = library(name)
    fn = getattr(lib, f"{entry or name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{entry or name} kernel launch failed: cuda "
                           f"error {err} ({msg})")
