"""Wind-field models (port of ``tol_tpu/models/wind.py``).

    0 zero wind            1 linear boundary layer     2 single thermal
    3 gridded storm field  4 dual thermals             5 cyclic wind

Each model is a differentiable function of the field-ENU position; the
3x3 spatial gradient comes from forward-mode AD (``torch.func.jvp``) as
``jax.jacfwd`` gives it in the JAX package.  Model 3 interpolates a
:class:`WindGrid` (built by ``tol_tpu_torch.io.storm``) trilinearly
(``order=1``) or by a quadratic B-spline (``order=2``) through one of three
lowerings that compute the same value: ``separable`` (axis-separated
contraction, one matmul per query batch), ``onehot`` and ``gather``.

Every function takes positions of any leading shape ``(..., 3)``.  The
stencil's integer index comes from a rounding that carries no tangent, so
the lowerings run under nested ``torch.func`` transforms (the solver takes
the wind gradient by one ``jvp`` and Hessians by another on top).

Each model-3 evaluation is the program's span ``wind.grid``, and adds the
positions it interpolates (replica axes included) to the recorder's
counter ``wind.grid.queries`` (``utils/profiling.py``; both nothing while
the recorder is off).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import torch
from torch.func import jvp

from tol_tpu_torch.utils.profiling import count, span

# the models whose field is affine in position, W(p) = W0 + G p
AFFINE_MODELS = (0, 1)


class WindGrid(NamedTuple):
    """Uniform ENU wind grid.

    ``u/v/w`` (nx, ny, nz) float32 samples indexed by (east, north, up)
    cells; ``origin`` the ENU position of node [0, 0, 0] and ``spacing`` the
    (dx, dy, dz) cell sizes, both (3,) in the dtype the grid was built for;
    ``live`` (3,) masks the (u, v, w) components."""

    origin: torch.Tensor
    spacing: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    live: torch.Tensor


@dataclasses.dataclass(frozen=True)
class WindConfig:
    """Parameters for all wind models; ``model`` selects code and is static.

    The numeric fields stay Python floats (they carry no batch axis in the
    port: one instance is shared by every lane of a solve).
    """

    model: int = 1
    # model 3: "separable", "onehot", "gather", or "auto" (separable up to
    # 65536 cells, else gather); order 1 trilinear, 2 quadratic B-spline
    interp: str = "auto"
    order: int = 1
    vref: float = 2.4
    href: float = 10.0
    xth: float = 0.0
    yth: float = 0.0
    vcore: float = 3.0
    rlift: float = 30.0
    xth2: float = 200.0
    yth2: float = 0.0
    vcore2: float = -3.0
    rlift2: float = 30.0
    east0: float = 17400.0
    north0: float = 25800.0
    up0: float = 200.0
    grid: Optional[WindGrid] = None


def _local_ned_to_field_enu(cfg: WindConfig, p_ned: torch.Tensor) -> torch.Tensor:
    x_e = p_ned[..., 1] + cfg.east0
    y_n = p_ned[..., 0] + cfg.north0
    z_u = -p_ned[..., 2] + cfg.up0
    return torch.stack([x_e, y_n, z_u], dim=-1)


def _zero_wind(cfg: WindConfig, p_enu: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p_enu)


def _boundary_layer(cfg: WindConfig, p_enu: torch.Tensor) -> torch.Tensor:
    """Linear boundary layer v = -Vref * z_local / href (datum-independent)."""
    z_local = p_enu[..., 2] - cfg.up0
    v = -cfg.vref * z_local / cfg.href
    zero = torch.zeros_like(v)
    return torch.stack([zero, v, zero], dim=-1)


def _thermal_updraft(p_enu, xth, yth, vcore, rlift):
    """Gaussian thermal w_up = vcore * exp(-r^2 / rlift^2)."""
    r2 = (p_enu[..., 0] - xth) ** 2 + (p_enu[..., 1] - yth) ** 2
    return vcore * torch.exp(-r2 / (rlift * rlift))


def _thermal(cfg: WindConfig, p_enu: torch.Tensor) -> torch.Tensor:
    w = _thermal_updraft(p_enu, cfg.xth, cfg.yth, cfg.vcore, cfg.rlift)
    zero = torch.zeros_like(w)
    return torch.stack([zero, zero, w], dim=-1)


def _dual_thermal(cfg: WindConfig, p_enu: torch.Tensor) -> torch.Tensor:
    """Source + sink pair."""
    w = (_thermal_updraft(p_enu, cfg.xth, cfg.yth, cfg.vcore, cfg.rlift)
         + _thermal_updraft(p_enu, cfg.xth2, cfg.yth2, cfg.vcore2, cfg.rlift2))
    zero = torch.zeros_like(w)
    return torch.stack([zero, zero, w], dim=-1)


def _cyclic(cfg: WindConfig, p_enu: torch.Tensor) -> torch.Tensor:
    """Horizontal vortex of speed vcore about (xth, yth); still at the core."""
    dx = p_enu[..., 0] - cfg.xth
    dy = p_enu[..., 1] - cfg.yth
    r = torch.sqrt(dx * dx + dy * dy)
    away = r > 0
    safe_r = torch.where(away, r, torch.ones_like(r))
    zero = torch.zeros_like(r)
    wx = torch.where(away, -cfg.vcore * dy / safe_r, zero)
    wy = torch.where(away, cfg.vcore * dx / safe_r, zero)
    return torch.stack([wx, wy, zero], dim=-1)


@functools.lru_cache(maxsize=None)
def _index_tensor(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant int64 index tensor, made once per device: a tensor built
    from a Python list on the card is a host-to-device copy that waits for
    the stream."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def _clip(x, lo, hi):
    """``jnp.clip``: max with ``lo`` first, so ``lo > hi`` gives ``hi``."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _axis_weights(grid: WindGrid, p_enu: torch.Tensor, order: int):
    """Stencil base node (..., 3) int64 and per-axis weights (..., 3, k) of
    the gridded field, stencil width k; the three axes are computed as one
    tensor.

    ``order=1``: trilinear.  ``order=2``: uniform quadratic B-spline (C1,
    27 nodes, linear precision).  Positions clamp to the grid interior, so
    queries outside extrapolate from the edge cells."""
    rel = (p_enu - grid.origin) / grid.spacing
    shape = _index_tensor(tuple(grid.u.shape), p_enu.device)
    if order == 1:
        idx = _clip(torch.floor(rel).to(torch.int64),
                    torch.zeros_like(shape), shape - 2)
        frac = rel - idx.to(rel.dtype)
        return idx, torch.stack([1.0 - frac, frac], dim=-1), 2
    if order == 2:
        jc = _clip(torch.round(rel).to(torch.int64), torch.ones_like(shape),
                   shape - 2)
        f = rel - jc.to(rel.dtype)
        w = torch.stack([0.5 * (0.5 - f) ** 2, 0.75 - f ** 2,
                         0.5 * (0.5 + f) ** 2], dim=-1)
        return jc - 1, w, 3
    raise ValueError(f"unsupported interpolation order {order}")


def _cell_weights(grid: WindGrid, p_enu: torch.Tensor, order: int):
    """Flat stencil addressing for the gather/onehot lowerings: base cell
    (...,), x-major tensor-product weights (..., k^3), flat offsets."""
    base_idx, w, k = _axis_weights(grid, p_enu, order)
    _, ny, nz = grid.u.shape
    wgt = (w[..., 0, :, None, None] * w[..., 1, None, :, None]
           * w[..., 2, None, None, :]).reshape(*w.shape[:-2], k ** 3)
    base = (base_idx[..., 0] * ny + base_idx[..., 1]) * nz + base_idx[..., 2]
    offs = [(dx * ny + dy) * nz + dz
            for dx in range(k) for dy in range(k) for dz in range(k)]
    return base, wgt, offs


def _flat_field(grid: WindGrid) -> torch.Tensor:
    return torch.stack([grid.u.reshape(-1), grid.v.reshape(-1),
                        grid.w.reshape(-1)])                   # (3, n)


def _grid_interp_separable(grid: WindGrid, p_enu: torch.Tensor,
                           order: int) -> torch.Tensor:
    """Axis-separated contraction: each axis's k weights are scattered into
    a dense length-n_axis vector by compares against an iota (no gather),
    (y, z) are contracted in one product against the field reshaped
    (3*nx, ny*nz), and x by an elementwise reduction.  The field is cast to
    the query dtype first, as the JAX package does.  The three axes share
    one iota of the longest axis; a stencil node past an axis's end (or
    before its start) meets no column of that axis, as in the JAX
    package."""
    base_idx, w, k = _axis_weights(grid, p_enu, order)
    nx, ny, nz = grid.u.shape
    dt = w.dtype
    dev = p_enu.device
    steps = torch.arange(k, dtype=torch.int64, device=dev)
    iota = torch.arange(max(nx, ny, nz), dtype=torch.int64, device=dev)
    sel = iota == (base_idx[..., None] + steps)[..., None]     # (..., 3, k, n)
    s = (w[..., None] * sel.to(dt)).sum(-2)                    # (..., 3, n)
    s_yz = (s[..., 1, :ny, None] * s[..., 2, None, :nz]).reshape(
        *s.shape[:-2], ny * nz)
    F = torch.stack([grid.u, grid.v, grid.w]).to(dt).reshape(3 * nx, ny * nz)
    t1 = torch.matmul(s_yz, F.T)                               # (..., 3*nx)
    uvw = (t1.reshape(*t1.shape[:-1], 3, nx) * s[..., 0, None, :nx]).sum(-1)
    return uvw * grid.live.to(dt)


def _grid_interp_onehot(grid: WindGrid, p_enu: torch.Tensor,
                        order: int) -> torch.Tensor:
    """One-hot contraction against the per-cell stencil tables (k^3, 3, n)."""
    nx, ny, nz = grid.u.shape
    n = nx * ny * nz
    base, wgt, offs = _cell_weights(grid, p_enu, order)
    dt = wgt.dtype
    flatp = torch.nn.functional.pad(_flat_field(grid), (0, offs[-1]))
    table = torch.stack([flatp[:, o:o + n] for o in offs]).to(dt)
    onehot = (torch.arange(n, dtype=torch.int64, device=p_enu.device)
              == base[..., None]).to(dt)                       # (..., n)
    corners = torch.einsum("ocn,...n->...co", table, onehot)   # (..., 3, k^3)
    uvw = torch.matmul(corners, wgt[..., :, None])[..., 0]
    return uvw * grid.live.to(dt)


def _grid_interp_gather(grid: WindGrid, p_enu: torch.Tensor,
                        order: int) -> torch.Tensor:
    """One fused stencil gather of the k^3 corners, then the weighted sum.
    A negative flat index wraps, as the JAX package's gather does."""
    base, wgt, offs = _cell_weights(grid, p_enu, order)
    flat = _flat_field(grid)
    idx = base[..., None] + _index_tensor(tuple(offs), p_enu.device)
    n = flat.shape[1]
    idx = torch.where(idx < 0, idx + n, idx)
    corners = flat[:, idx].movedim(0, -2)                      # (..., 3, k^3)
    dt = torch.promote_types(corners.dtype, wgt.dtype)
    uvw = torch.matmul(corners.to(dt), wgt.to(dt)[..., :, None])[..., 0]
    return uvw * grid.live.to(dt)


def wind_enu(cfg: WindConfig, p_enu: torch.Tensor) -> torch.Tensor:
    """ENU wind (u east, v north, w up) at field-ENU positions (..., 3)."""
    model = int(cfg.model)
    if model == 0:
        return _zero_wind(cfg, p_enu)
    if model == 1:
        return _boundary_layer(cfg, p_enu)
    if model == 2:
        return _thermal(cfg, p_enu)
    if model == 3:
        if cfg.grid is None:
            raise ValueError("wind model 3 requires a WindGrid")
        nx, ny, nz = cfg.grid.u.shape
        with span("wind.grid"):
            count("wind.grid.queries", math.prod(p_enu.shape[:-1]))
            if (cfg.interp == "separable"
                    or (cfg.interp == "auto" and nx * ny * nz <= 65536)):
                return _grid_interp_separable(cfg.grid, p_enu, cfg.order)
            if cfg.interp == "onehot":
                return _grid_interp_onehot(cfg.grid, p_enu, cfg.order)
            return _grid_interp_gather(cfg.grid, p_enu, cfg.order)
    if model == 4:
        return _dual_thermal(cfg, p_enu)
    if model == 5:
        return _cyclic(cfg, p_enu)
    raise ValueError(f"unknown wind model {model}")


def wind_ned(cfg: WindConfig, p_ned: torch.Tensor) -> torch.Tensor:
    """NED wind at aircraft-local NED positions: (Wx, Wy, Wz) = (v, u, -w)."""
    w_enu = wind_enu(cfg, _local_ned_to_field_enu(cfg, p_ned))
    return torch.stack([w_enu[..., 1], w_enu[..., 0], -w_enu[..., 2]], dim=-1)


def wind_with_gradient_ned(cfg: WindConfig, p_ned: torch.Tensor):
    """Wind (..., 3) and its spatial gradient (..., 3, 3),
    ``grad[..., i, j] = dW_i/dp_j``, by forward-mode AD.

    The three basis directions ride a replica axis of one ``jvp`` (what
    ``jacfwd`` does with ``vmap``), so no dual tensor is ever 0-d: torch's
    forward mode promotes a 0-d float32 dual times a Python float to
    float64."""
    w = wind_ned(cfg, p_ned)
    P = p_ned.unsqueeze(-2).expand(*p_ned.shape[:-1], 3, 3)   # replica j
    eye = torch.eye(3, dtype=p_ned.dtype, device=p_ned.device)
    _, dW = jvp(lambda q: wind_ned(cfg, q), (P.contiguous(),),
                (eye.expand_as(P).contiguous(),))
    return w, dW.transpose(-1, -2)


@functools.lru_cache(maxsize=None)
def affine_wind(cfg: WindConfig):
    """``(W0, G)`` of a field affine in position (``cfg.model`` in
    :data:`AFFINE_MODELS`): the NED wind at the local origin (3,) and its
    constant gradient (3, 3), as float64 numpy, taken once per
    configuration from :func:`wind_with_gradient_ned` itself."""
    if int(cfg.model) not in AFFINE_MODELS:
        raise ValueError(f"wind model {cfg.model} is not affine in position")
    w, g = wind_with_gradient_ned(cfg, torch.zeros(1, 3, dtype=torch.float64))
    out = w[0].numpy(), g[0].numpy()
    for a in out:
        a.setflags(write=False)     # shared by every caller of the cache
    return out
