"""Build and load the CUDA kernels of ``tol_tpu_torch/csrc``.

At first use ``nvcc`` compiles ``csrc/crkern.cu`` into a shared library with
a plain C interface under ``build/tol_tpu_torch/<hash>/`` at the repository
root (listed in ``.gitignore``), keyed by a hash of the sources and flags,
and ``ctypes`` loads it.  No PyTorch header is compiled, so the build takes
seconds.  Pivots need correctly rounded ``1/sqrt``: no ``--use_fast_math``.
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
_SOURCES = ("crkern.cu", "crkern_block.cuh")
_MAIN = "crkern.cu"
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "tol_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    "crp_factor_fwd_level": [_P] * 12 + [ctypes.c_long, ctypes.c_int, _P],
    "crp_fwd_level": [_P] * 7 + [ctypes.c_long, ctypes.c_int, _P],
    "crp_bwd_level": [_P] * 7 + [ctypes.c_long, ctypes.c_int, _P],
    "crp_root": [_P] * 4 + [ctypes.c_long, ctypes.c_int, ctypes.c_int, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> tuple[str, str]:
    """Compile the kernels if this source hash has no library yet.

    Returns (path of the library, ptxas report of this build or "" when
    the library was already there)."""
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    lib = os.path.join(out_dir, "libcrkern.so")
    if os.path.exists(lib):
        return lib, ""
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, _MAIN)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    report = os.path.join(out_dir, "ptxas.txt")
    with open(report, "w") as f:
        f.write(proc.stderr)
    return lib, proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.crp_error_string.argtypes = [ctypes.c_int]
    lib.crp_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        raise RuntimeError(
            f"{name}: CUDA error {code}: {lib.crp_error_string(code).decode()}")
