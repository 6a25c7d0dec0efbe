"""stdio tee logging.

A copy of ``prtp_tpu/utils/tee.py``, kept in the port
so that the port imports nothing of the JAX package.

Same capability as the reference's ``src/tee.py``: context managers that
duplicate stdout/stderr into log files (used around the train loop at
``src/train.py:603-606``). Fresh implementation: a single ``_Tee`` stream
wrapper with flush-through.
"""

from __future__ import annotations

import sys


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


class StdoutTee:
    """Duplicate sys.stdout into ``path`` while the context is active."""

    def __init__(self, path, mode="a"):
        self.path = path
        self.mode = mode

    def __enter__(self):
        self._file = open(self.path, self.mode)
        self._orig = sys.stdout
        sys.stdout = _Tee(self._orig, self._file)
        return self

    def __exit__(self, *exc):
        sys.stdout = self._orig
        self._file.close()
        return False


class StderrTee:
    """Duplicate sys.stderr into ``path`` while the context is active."""

    def __init__(self, path, mode="a"):
        self.path = path
        self.mode = mode

    def __enter__(self):
        self._file = open(self.path, self.mode)
        self._orig = sys.stderr
        sys.stderr = _Tee(self._orig, self._file)
        return self

    def __exit__(self, *exc):
        sys.stderr = self._orig
        self._file.close()
        return False
