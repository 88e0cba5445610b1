"""3-D point-mass aircraft dynamics in a wind field (port of
``tol_tpu/models/dynamics.py``; the derivation is in that module).

Written on the last axis so one call covers any leading batch axes:
``z`` (..., 11), ``wind`` (..., 3), ``wind_grad`` (..., 3, 3).
"""

from __future__ import annotations

import math

import torch

from tol_tpu_torch.config import GRAVITY, RHO, AircraftParams

IDX_X, IDX_Y, IDX_Z, IDX_VA, IDX_GAM, IDX_CHI, IDX_PHI, IDX_CL = range(8)
IDX_DPHI, IDX_DCL, IDX_T = 8, 9, 10
NUM_VARS = 11
NUM_STATES = 8

NODE_VAR_NAMES = ("x", "y", "z", "Va", "gam", "chi", "phi", "CL",
                  "dphi", "dCL", "T")


def state_derivatives(z: torch.Tensor, wind: torch.Tensor,
                      wind_grad: torch.Tensor,
                      ac: AircraftParams) -> torch.Tensor:
    """(..., 8) time derivative ``[xdot, ydot, zdot, Vadot, gamdot, chidot,
    phidot, CLdot]`` of the dynamic states at each node."""
    Va = z[..., IDX_VA]
    gam = z[..., IDX_GAM]
    chi = z[..., IDX_CHI]
    phi = z[..., IDX_PHI]
    CL = z[..., IDX_CL]
    dphi = z[..., IDX_DPHI]
    dCL = z[..., IDX_DCL]
    T = z[..., IDX_T]

    cg, sg = torch.cos(gam), torch.sin(gam)
    cc, sc = torch.cos(chi), torch.sin(chi)

    e_a = torch.stack([cc * cg, sc * cg, -sg], dim=-1)
    e_gam = torch.stack([cc * sg, sc * sg, cg], dim=-1)
    e_chi = torch.stack([-sc, cc, torch.zeros_like(sc)], dim=-1)

    v_g = wind + Va[..., None] * e_a
    wind_rate = (wind_grad * v_g[..., None, :]).sum(-1)   # gradW @ v_g

    q = 0.5 * RHO * ac.SS * Va * Va
    L = q * CL
    D = q * (ac.Cd0 + CL * CL / (math.pi * ac.AR * ac.ee))

    Va_dot = T / ac.mm - GRAVITY * sg - D / ac.mm - (e_a * wind_rate).sum(-1)
    gam_dot = (L * torch.cos(phi) / ac.mm - GRAVITY * cg
               + (e_gam * wind_rate).sum(-1)) / Va
    chi_dot = (L * torch.sin(phi) / ac.mm
               - (e_chi * wind_rate).sum(-1)) / (Va * cg)

    return torch.stack([
        v_g[..., 0], v_g[..., 1], v_g[..., 2],
        Va_dot, gam_dot, chi_dot,
        dphi, dCL,
    ], dim=-1)
