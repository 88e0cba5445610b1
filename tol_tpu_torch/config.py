"""Typed configuration records (port of ``tol_tpu/config.py``).

Plain NamedTuples of Python floats: the readers fill them, and
``problems/base.make_instance`` turns the numeric ones into tensors on the
chosen device.  All angles are radians.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

# Physical constants (ref: include/problem.h:72-73)
GRAVITY = 9.81
RHO = 1.2682

# "Infinity" as used by SNOPT-era bound conventions (ref: src/problem.cpp:279)
INF_BOUND = 1e20


class AircraftParams(NamedTuple):
    """Airframe parameters in file order; phimax/gammamax/phidotmax in rad."""

    mm: float
    b: float
    SS: float
    ee: float
    AR: float
    Cd0: float
    CLmin: float
    CLmax: float
    phimax: float
    Vamin: float
    Vamax: float
    gammamax: float
    phidotmax: float
    Tmin: float
    Tmax: float


class Gains(NamedTuple):
    kT: float
    kp: float
    kv: float
    ka: float
    kdt: float


class Limits(NamedTuple):
    dtmin: float
    dtmax: float
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    zmin: float
    zmax: float


class SolverDims(NamedTuple):
    ts: int
    numinp: int
    numstates: int
    numbounds: int
    opt_tol: float
    feas_tol: float


class MissionBoxes(NamedTuple):
    """Hardcoded per-mission node-0 state boxes (ref: src/problem.cpp:80-134)."""

    Va1: float
    Va2: float
    gamma1: float
    gamma2: float
    chi1: float
    chi2: float
    phi1: float
    phi2: float
    CL1: float
    CL2: float
    phidot1: float
    phidot2: float
    CLdot1: float
    CLdot2: float


S10_BOXES = MissionBoxes(
    Va1=4.0, Va2=50.0,
    gamma1=0.0, gamma2=0.0,
    chi1=-1.7453292519943296e18, chi2=1.7453292519943296e18,
    phi1=-1.5707963267948966, phi2=1.5707963267948966,
    CL1=-0.5, CL2=3.0,
    phidot1=-3.4906585039886591, phidot2=3.4906585039886591,
    CLdot1=-200.0, CLdot2=200.0,
)

G7_BOXES = MissionBoxes(
    Va1=4.0, Va2=50.0,
    gamma1=0.0, gamma2=0.0,
    chi1=-INF_BOUND * math.pi / 180.0, chi2=INF_BOUND * math.pi / 180.0,
    phi1=-math.pi / 2.0, phi2=math.pi / 2.0,
    CL1=-0.5, CL2=3.0,
    phidot1=-3.4906585039886591, phidot2=3.4906585039886591,
    CLdot1=-200.0, CLdot2=200.0,
)


class Goal(NamedTuple):
    """Mission goal in NED coordinates."""

    xg: float
    yg: float
    zg: float
    rg: float


class StitchState(NamedTuple):
    """Previous-leg terminal state (node-0 stitch bounds of the next leg)."""

    Va: float
    gam: float
    chi: float
    phi: float
    CL: float
    dphi: float
    dCL: float
    T: float


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Full static description of one mission NLP instance family."""

    mission: str                  # "G7" | "S10"
    aircraft: AircraftParams
    gains: Gains
    limits: Limits
    dims: SolverDims
    boxes: MissionBoxes
    wind_model: int = 1
    jacobian_mode: str = "exact"  # "exact" | "reference" (frozen wind)
