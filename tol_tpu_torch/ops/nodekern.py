"""The collocation node blocks in closed form, by the CUDA kernel K9
(``csrc/nodekern.cu``).

Under a wind field affine in position (wind models 0 and 1), the per-node
derivative blocks of the collocation NLP that the solver otherwise takes by
``torch.func`` transforms (``solver/canonical.py`` ``constraint_jac_blocks``,
``solver/kkt_condensed.py`` ``derivative_blocks``) have a closed form:

    Hn (12, 12)  the Hessian over [z_i, dt] of y_i . defect(z_i, 0, dt)
    A  (8, 11)   d defect_i / d z_i
    d  (8,)      d defect_i / d dt

in the scaled NLP's variables.  :func:`node_blocks` writes all three for
every node of every lane in one launch, :func:`defect_blocks` A and d
alone.  Those two callers choose between the kernel and the transforms;
this module takes CUDA tensors only, float32 or float64 (its arithmetic is
held to the transforms on the CPU through a host build of
``csrc/nodekern_block.cuh``, ``tests/test_torch_nodekern.py``).  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tol_tpu_torch.config import GRAVITY, RHO
from tol_tpu_torch.ops import _build

NV, NS = 11, 8
PAR_FLOATS = 17   # nk::PAR_FLOATS


def params(ac, d_z: torch.Tensor, d_dt: torch.Tensor) -> torch.Tensor:
    """The kernel's per-call numbers, on the airframe's device: mass, wing
    area, zero-lift drag, aspect ratio, Oswald factor (``ac`` an
    AircraftParams of 0-d tensors), the variable scales ``d_z`` (11,) and
    ``d_dt``.  Read from the device at every launch, so a captured graph
    follows an Instance refilled in place."""
    return torch.cat([torch.stack([ac.mm, ac.SS, ac.Cd0, ac.AR, ac.ee]),
                      d_z, d_dt.reshape(1)])


def field(W0, G) -> ctypes.Array:
    """The launch's host constants: air density, gravity, the affine wind's
    value at the origin ``W0`` (3,) and gradient ``G`` (3, 3)."""
    c = np.concatenate([[RHO, GRAVITY], np.asarray(W0, dtype=np.float64),
                        np.asarray(G, dtype=np.float64).reshape(9)])
    return (ctypes.c_double * len(c))(*c)


# dtype -> the suffix of its entry points
_ENTRY = {torch.float32: "", torch.float64: "_f64"}


def _check(name, Z, dt, par, T):
    if Z.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors only (the CPU takes the "
                         "torch.func transforms)")
    for t in (Z, dt, par):
        if (Z.dtype not in _ENTRY or t.dtype != Z.dtype
                or t.device != Z.device):
            raise TypeError(f"{name}: float32 or float64 operands of one "
                            "dtype on one device")
    B = Z.shape[0]
    if (Z.dim() != 3 or Z.shape[1:] != (T + 1, NV) or Z.stride(2) != 1
            or Z.stride(1) != NV or dt.shape != (B,)
            or par.shape != (PAR_FLOATS,) or not par.is_contiguous()):
        raise ValueError(f"{name}: Z (B, T+1, 11) with unit node stride, dt "
                         f"(B,), par ({PAR_FLOATS},); got {tuple(Z.shape)}, "
                         f"{tuple(Z.stride())}, {tuple(dt.shape)}, "
                         f"{tuple(par.shape)}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def node_blocks(Z, dt, y, par, fld):
    """K9 over every node.  ``Z`` (B, T+1, 11) node points (node stride
    11, any lane stride: a view into v), ``dt`` (B,), ``y`` (B, T, 8) defect
    multipliers (node T takes none), ``par`` from :func:`params`, ``fld``
    from :func:`field` -> Hn (B, T+1, 12, 12), A (B, T+1, 8, 11), d
    (B, T+1, 8); node T's A and d are those of a defect it does not have."""
    B, T = Z.shape[0], Z.shape[1] - 1
    _check("node_blocks", Z, dt, par, T)
    if (y.dtype != Z.dtype or y.device != Z.device or y.shape != (B, T, NS)
            or y.stride(2) != 1 or y.stride(1) != NS):
        raise ValueError(f"node_blocks: y (B, T, 8) with unit node stride; "
                         f"got {tuple(y.shape)}, {tuple(y.stride())}")
    new = lambda *s: torch.empty(B, T + 1, *s, dtype=Z.dtype, device=Z.device)
    Hn, A, d = new(NV + 1, NV + 1), new(NS, NV), new(NS)
    lib = _build.load_library("nodekern")
    entry = getattr(lib, "node_blocks" + _ENTRY[Z.dtype])
    code = entry(Z.data_ptr(), Z.stride(0), dt.data_ptr(), dt.stride(0),
                 y.data_ptr(), y.stride(0), par.data_ptr(), fld, B, T + 1, T,
                 Hn.data_ptr(), A.data_ptr(), d.data_ptr(), _stream(Z))
    node_blocks.launches += 1
    _build.check(lib, code, "node_blocks")
    return Hn, A, d


def defect_blocks(Z, dt, par, fld):
    """K9 without the Hessian, over nodes 0..T-1: ``Z`` (B, T+1, 11), ``dt``
    (B,), ``par``, ``fld`` as :func:`node_blocks` -> A (B, T, 8, 11), d
    (B, T, 8)."""
    B, T = Z.shape[0], Z.shape[1] - 1
    _check("defect_blocks", Z, dt, par, T)
    A = torch.empty(B, T, NS, NV, dtype=Z.dtype, device=Z.device)
    d = torch.empty(B, T, NS, dtype=Z.dtype, device=Z.device)
    lib = _build.load_library("nodekern")
    entry = getattr(lib, "defect_blocks" + _ENTRY[Z.dtype])
    code = entry(Z.data_ptr(), Z.stride(0), dt.data_ptr(), dt.stride(0),
                 par.data_ptr(), fld, B, T, A.data_ptr(), d.data_ptr(),
                 _stream(Z))
    defect_blocks.launches += 1
    _build.check(lib, code, "defect_blocks")
    return A, d


KERNELS = (node_blocks, defect_blocks)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
