"""Wind-field models (port of ``tol_tpu/models/wind.py``).

    0 zero wind            1 linear boundary layer     2 single thermal
    3 gridded storm field  4 dual thermals             5 cyclic wind

Each model is a differentiable function of the field-ENU position; the
3x3 spatial gradient comes from forward-mode AD (``torch.func.jvp``) as
``jax.jacfwd`` gives it in the JAX package.  Model 3 (with ``io/storm.py``
and ``io/native.py``) is not ported yet (ROADMAP queue A item 11) and
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.func import jvp


@dataclasses.dataclass(frozen=True)
class WindConfig:
    """Parameters for all wind models; ``model`` selects code and is static.

    The numeric fields stay Python floats (they carry no batch axis in the
    port: one instance is shared by every lane of a solve).
    """

    model: int = 1
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
    grid: Optional[object] = None


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
        raise NotImplementedError(
            "wind model 3 (gridded storm field) is not ported yet: "
            "ROADMAP.md queue A item 11, 'The remaining solve configs'")
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
