"""Persistent build directory of the CUDA kernels (port of
``tol_tpu/utils/cache.py``).

The JAX package points XLA's persistent compilation cache at a directory
and seeds it from the committed ``assets/aot_cache``.  The port compiles
no program ahead of time: its only compiled artifacts are the kernel
libraries that ``ops/_build.py`` builds with nvcc, keyed by a hash of
their sources and flags, so their build directory is its whole compile
cache.  The XLA seed has no counterpart here: a fresh checkout builds the
libraries on first use (seconds).
"""

from __future__ import annotations

import os


def enable_compile_cache(cache_dir: str | None = None) -> None:
    """Build and load the kernel libraries under ``cache_dir`` (default:
    ``<repo root>/build/tol_tpu_torch``, which ``.gitignore`` lists).
    Takes effect for libraries not loaded yet in this process."""
    from tol_tpu_torch.ops import _build

    if cache_dir is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        cache_dir = os.path.join(root, "build", "tol_tpu_torch")
    _build.BUILD_ROOT = os.path.abspath(cache_dir)
