"""The collocation node blocks in closed form, by the CUDA kernel K9
(``csrc/nodekern.cu``).

Under a wind field affine in position (wind models 0 and 1), and under the
gridded storm field's quadratic B-spline (wind model 3 at order 2), the
per-node derivative blocks of the collocation NLP that the solver otherwise
takes by ``torch.func`` transforms (``solver/canonical.py``
``constraint_jac_blocks``, ``solver/kkt_condensed.py`` ``derivative_blocks``)
have a closed form:

    Hn (12, 12)  the Hessian over [z_i, dt] of y_i . defect(z_i, 0, dt)
    A  (8, 11)   d defect_i / d z_i
    d  (8,)      d defect_i / d dt

in the scaled NLP's variables.  :func:`node_blocks` writes all three for
every node of every lane in one launch, :func:`defect_blocks` A and d
alone; the wind is either :func:`field` (affine) or :func:`grid_field`.  Those two callers choose between the kernel and the transforms;
this module takes CUDA tensors only, float32 or float64 (its arithmetic is
held to the transforms on the CPU through a host build of
``csrc/nodekern_block.cuh``, ``tests/test_torch_nodekern.py``).  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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


class GridField(NamedTuple):
    """The launch's wind under the gridded field: ``consts`` the host
    doubles air density, gravity, east0, north0, up0; the rest the
    ``WindGrid``'s device tensors, read at every launch (so a captured graph
    follows a grid refilled in place)."""

    consts: ctypes.Array
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    origin: torch.Tensor
    spacing: torch.Tensor
    live: torch.Tensor


def grid_field(cfg) -> GridField:
    """The launch's wind for ``cfg`` (a WindConfig of wind model 3 at order
    2 with its grid): the quadratic B-spline over ``cfg.grid``, as
    ``models/wind.py`` evaluates it."""
    g = cfg.grid
    c = np.array([RHO, GRAVITY, cfg.east0, cfg.north0, cfg.up0],
                 dtype=np.float64)
    return GridField((ctypes.c_double * len(c))(*c), g.u, g.v, g.w,
                     g.origin, g.spacing, g.live)


# dtype -> the suffix of its entry points
_ENTRY = {torch.float32: "", torch.float64: "_f64"}


def _wind_args(name, fld, Z):
    """(entry point suffix, its wind arguments) for ``fld`` from
    :func:`field` or :func:`grid_field`.  The grid's origin and spacing go
    to the kernel in the nodes' dtype (a cast on the device where they
    differ), the samples and live mask as float32."""
    if not isinstance(fld, GridField):
        return "", (fld,)
    shape = fld.u.shape
    if (len(shape) != 3 or min(shape) < 3
            or any(t.shape != shape or t.dtype != torch.float32
                   or not t.is_contiguous() or t.device != Z.device
                   for t in (fld.u, fld.v, fld.w))):
        raise ValueError(f"{name}: grid samples u, v, w (nx, ny, nz), every "
                         "axis >= 3, float32, contiguous, on the nodes' "
                         "device")
    origin = fld.origin.to(Z.dtype).contiguous()
    spacing = fld.spacing.to(Z.dtype).contiguous()
    live = fld.live.to(torch.float32).contiguous()
    for t in (origin, spacing, live):
        if t.shape != (3,) or t.device != Z.device:
            raise ValueError(f"{name}: grid origin, spacing, live (3,) on "
                             "the nodes' device")
    return "_grid", (fld.consts, fld.u.data_ptr(), fld.v.data_ptr(),
                     fld.w.data_ptr(), origin.data_ptr(), spacing.data_ptr(),
                     live.data_ptr(), *shape)


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
    from :func:`field` or :func:`grid_field` -> Hn (B, T+1, 12, 12), A
    (B, T+1, 8, 11), d (B, T+1, 8); node T's A and d are those of a defect
    it does not have."""
    B, T = Z.shape[0], Z.shape[1] - 1
    _check("node_blocks", Z, dt, par, T)
    if (y.dtype != Z.dtype or y.device != Z.device or y.shape != (B, T, NS)
            or y.stride(2) != 1 or y.stride(1) != NS):
        raise ValueError(f"node_blocks: y (B, T, 8) with unit node stride; "
                         f"got {tuple(y.shape)}, {tuple(y.stride())}")
    new = lambda *s: torch.empty(B, T + 1, *s, dtype=Z.dtype, device=Z.device)
    Hn, A, d = new(NV + 1, NV + 1), new(NS, NV), new(NS)
    kind, wind = _wind_args("node_blocks", fld, Z)
    lib = _build.load_library("nodekern")
    entry = getattr(lib, "node_blocks" + kind + _ENTRY[Z.dtype])
    code = entry(Z.data_ptr(), Z.stride(0), dt.data_ptr(), dt.stride(0),
                 y.data_ptr(), y.stride(0), par.data_ptr(), *wind, B, T + 1,
                 T, Hn.data_ptr(), A.data_ptr(), d.data_ptr(), _stream(Z))
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
    kind, wind = _wind_args("defect_blocks", fld, Z)
    lib = _build.load_library("nodekern")
    entry = getattr(lib, "defect_blocks" + kind + _ENTRY[Z.dtype])
    code = entry(Z.data_ptr(), Z.stride(0), dt.data_ptr(), dt.stride(0),
                 par.data_ptr(), *wind, B, T, A.data_ptr(), d.data_ptr(),
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
