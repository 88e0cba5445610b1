"""Build and load the CUDA kernels of ``tol_tpu_torch/csrc``.

At first use ``nvcc`` compiles every ``.cu`` file under ``csrc/`` into a
shared library of its own with a plain C interface (``lib<name>.so``), all
compilers started together, under ``build/tol_tpu_torch/<hash>/`` at the
repository root (listed in ``.gitignore``).  The hash covers every source
and header under ``csrc/`` and the flags.  ``ctypes`` loads the libraries.
No PyTorch header is compiled, so a build takes seconds.  Pivots need
correctly rounded square roots and divisions: no ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "tol_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
# library (csrc/<name>.cu) -> entry point -> argument types; every entry
# point returns the CUDA error of its launch.
_SIGNATURES = {
    "crkern": {
        "crp_factor_fwd_pass": [_P] * 9 + [_L, _I, _I, _P],
        "crp_factor_pass": [_P] * 6 + [_L, _I, _P],
        "crp_fwd_pass": [_P] * 7 + [_L, _I, _I, _P],
        "crp_bwd_pass": [_P] * 6 + [_L, _I, _I, _P],
    },
    "chainkern": {
        "chain_factor": [_P] * 7 + [_I, _I, _L, _I, _I, _P],
        "chain_rhs_forward": [_P] * 6 + [_I, _I, _L, _I, _I, _P],
        "chain_back_sub": [_P] * 4 + [_I, _I, _L, _I, _I, _P],
        "fast_ops_check": [_L, _P, _P],
    },
    "nodekern": {
        "node_blocks": [_P, _L] * 3 + [_P, _P, _L, _I, _I] + [_P] * 4,
        "node_blocks_f64": [_P, _L] * 3 + [_P, _P, _L, _I, _I] + [_P] * 4,
        "defect_blocks": [_P, _L] * 2 + [_P, _P, _L, _I] + [_P] * 3,
        "defect_blocks_f64": [_P, _L] * 2 + [_P, _P, _L, _I] + [_P] * 3,
        "node_blocks_grid": [_P, _L] * 3 + [_P] * 8 + [_I] * 3
                            + [_L, _I, _I] + [_P] * 4,
        "node_blocks_grid_f64": [_P, _L] * 3 + [_P] * 8 + [_I] * 3
                                + [_L, _I, _I] + [_P] * 4,
        "defect_blocks_grid": [_P, _L] * 2 + [_P] * 8 + [_I] * 3
                              + [_L, _I] + [_P] * 3,
        "defect_blocks_grid_f64": [_P, _L] * 2 + [_P] * 8 + [_I] * 3
                                  + [_L, _I] + [_P] * 3,
    },
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(f for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> dict[str, tuple[str, str]]:
    """Compile every ``csrc/*.cu`` that has no library for this source hash
    yet, one ``nvcc`` per file, all running at once.

    Returns ``{name: (path of the library, its ptxas report)}``."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    os.makedirs(out_dir, exist_ok=True)
    out, running = {}, []
    for src in (f for f in _sources() if f.endswith(".cu")):
        name = src[:-3]
        lib = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(lib):
            report = os.path.join(out_dir, f"ptxas_{name}.txt")
            out[name] = (lib, open(report).read()
                         if os.path.exists(report) else "")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)]
        running.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, lib, tmp, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, lib)
        with open(os.path.join(out_dir, f"ptxas_{name}.txt"), "w") as f:
            f.write(err)
        out[name] = (lib, err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str = "crkern") -> ctypes.CDLL:
    """The kernel library ``csrc/<name>.cu``, built on first call and loaded
    once per process."""
    lib = ctypes.CDLL(build()[name][0])
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        raise RuntimeError(
            f"{name}: CUDA error {code}: "
            f"{lib.kernel_error_string(code).decode()}")
