"""Native (C++) host-pipeline accelerators, loaded via ctypes.

A copy of ``prtp_tpu/native/__init__.py``, kept in the port
so that the port imports nothing of the JAX package.

The shared library is built lazily from source with the system g++
(``-O3 -shared -fPIC``) into the git-ignored ``prtp_tpu_torch/_build/``
(never beside the source, so nothing is written into the package's
sources, nor into the JAX package's); every entry
point has a pure-Python fallback so the package works without a
toolchain.
"""

from .raster import rasterize_paths_native, native_available  # noqa: F401
