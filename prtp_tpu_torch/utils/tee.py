"""stdio tee logging.

A copy of ``prtp_tpu/utils/tee.py``, kept in the port
so that the port imports nothing of the JAX package.

Same capability as the reference's ``src/tee.py``: context managers that
duplicate stdout/stderr into log files (used around the train loop at
``src/train.py:603-606``). Fresh implementation: a single ``_Tee`` stream
wrapper with flush-through. Under data parallelism only rank 0 writes a
log (``parallel.is_main_process``): the other ranks' stdout goes nowhere
(:func:`main_process_stdout`) and their stderr to the stream alone.
"""

from __future__ import annotations

import contextlib
import os
import sys

from ..parallel.distributed import is_main_process


class _Tee:
    def __init__(self, stream, fileobj):
        self._stream = stream
        self._file = fileobj

    def write(self, data):
        self._stream.write(data)
        self._file.write(data)
        self._file.flush()
        return len(data)

    def flush(self):
        self._stream.flush()
        self._file.flush()

    def isatty(self):
        return getattr(self._stream, "isatty", lambda: False)()

    def fileno(self):
        return self._stream.fileno()

    @property
    def encoding(self):
        return getattr(self._stream, "encoding", "utf-8")


@contextlib.contextmanager
def main_process_stdout():
    """sys.stdout as it is on rank 0 (or without a process group), and
    discarded on the other ranks, while the context is active."""
    if is_main_process():
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


class StdoutTee:
    """Duplicate sys.stdout into ``path`` while the context is active; on
    a rank other than 0, discard it instead."""

    def __init__(self, path, mode="a"):
        self.path = path
        self.mode = mode

    def __enter__(self):
        self._orig = sys.stdout
        self._file = open(self.path if is_main_process() else os.devnull,
                          self.mode)
        sys.stdout = (_Tee(self._orig, self._file) if is_main_process()
                      else self._file)
        return self

    def __exit__(self, *exc):
        sys.stdout = self._orig
        self._file.close()
        return False


class StderrTee:
    """Duplicate sys.stderr into ``path`` while the context is active (on
    rank 0, or without a process group)."""

    def __init__(self, path, mode="a"):
        self.path = path
        self.mode = mode

    def __enter__(self):
        self._file = open(self.path if is_main_process() else os.devnull,
                          self.mode)
        self._orig = sys.stderr
        sys.stderr = _Tee(self._orig, self._file)
        return self

    def __exit__(self, *exc):
        sys.stderr = self._orig
        self._file.close()
        return False
