"""Solution checkpoint / warm-start persistence (port of
``tol_tpu/utils/checkpoint.py``).

Solver state (primal + duals) round-trips to disk so legs, replans and
interrupted sweeps warm-start: ``alm.solve(..., v0=..., y0=...)`` takes the
loaded state once it is a tensor on the solve's device.  The file is the
JAX package's: an ``.npz`` with the keys ``v``, ``y`` and ``meta_<key>``,
so a file written by either package loads in the other, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_solution(path: str, v, y=None, meta: Optional[dict] = None) -> None:
    """Write ``v``, ``y`` and ``meta`` (tensors on any device, arrays or
    scalars) to ``path`` as numpy arrays."""
    arrays = {"v": _host(v)}
    if y is not None:
        arrays["y"] = _host(y)
    if meta:
        for k, val in meta.items():
            arrays[f"meta_{k}"] = _host(val)
    np.savez(path, **arrays)


def load_solution(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], dict]:
    """``(v, y or None, meta)`` as numpy arrays, as the JAX package returns
    them."""
    data = np.load(path, allow_pickle=False)
    v = data["v"]
    y = data["y"] if "y" in data else None
    meta = {k[5:]: data[k] for k in data.files if k.startswith("meta_")}
    return v, y, meta
