"""``.param`` file readers (port of ``tol_tpu/io/params.py``).

Same semantics as the reference's ``parameters::readparams``: each line is
split on the first ``'/'``, the leading float of the head is parsed (trailing
junk such as the literal ``\\n`` text in ``aircraft/tempest.param`` is
ignored, as ``std::stod`` does), and lines without a leading number are
skipped.
"""

from __future__ import annotations

import math
import os
import re
from typing import List

from tol_tpu_torch.config import AircraftParams, Gains, Limits, SolverDims

_FLOAT_PREFIX = re.compile(r"^\s*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)")


def _parse_line(line: str) -> float | None:
    head = line.split("/", 1)[0]
    m = _FLOAT_PREFIX.match(head)
    if m is None:
        return None
    return float(m.group(1))


def read_param_file(path: str) -> List[float]:
    """Read every numeric line of a ``.param`` file."""
    values: List[float] = []
    with open(path, "r") as f:
        for line in f:
            v = _parse_line(line)
            if v is not None:
                values.append(v)
    return values


def _expect(values: List[float], count: int, what: str) -> None:
    if len(values) != count:
        raise ValueError(
            f"Wrong number of parameters for {what}: expected {count}, got {len(values)}"
        )


_DEG = math.pi / 180.0


def load_aircraft(name: str, root_path: str) -> AircraftParams:
    """``<root>/aircraft/<name>.param`` (15 fields; degrees -> radians)."""
    path = os.path.join(root_path, "aircraft", name + ".param")
    v = read_param_file(path)
    _expect(v, 15, f"{name}.param")
    return AircraftParams(
        mm=v[0], b=v[1], SS=v[2], ee=v[3], AR=v[4], Cd0=v[5],
        CLmin=v[6], CLmax=v[7], phimax=v[8] * _DEG,
        Vamin=v[9], Vamax=v[10], gammamax=v[11] * _DEG,
        phidotmax=v[12] * _DEG, Tmin=v[13], Tmax=v[14],
    )


def load_gains(mission: str, root_path: str) -> Gains:
    """``<root>/problems/<mission>/gains.param`` (5 fields)."""
    path = os.path.join(root_path, "problems", mission, "gains.param")
    v = read_param_file(path)
    _expect(v, 5, f"problems/{mission}/gains.param")
    return Gains(kT=v[0], kp=v[1], kv=v[2], ka=v[3], kdt=v[4])


def load_limits(mission: str, root_path: str) -> Limits:
    """``<root>/problems/<mission>/limits.param`` (8 fields)."""
    path = os.path.join(root_path, "problems", mission, "limits.param")
    v = read_param_file(path)
    _expect(v, 8, f"problems/{mission}/limits.param")
    return Limits(
        dtmin=v[0], dtmax=v[1], xmin=v[2], xmax=v[3],
        ymin=v[4], ymax=v[5], zmin=v[6], zmax=v[7],
    )


def load_solver_dims(mission: str, root_path: str) -> SolverDims:
    """``<root>/problems/<mission>/snopt.param`` (6 fields)."""
    path = os.path.join(root_path, "problems", mission, "snopt.param")
    v = read_param_file(path)
    _expect(v, 6, f"problems/{mission}/snopt.param")
    return SolverDims(
        ts=int(v[0]), numinp=int(v[1]), numstates=int(v[2]), numbounds=int(v[3]),
        opt_tol=v[4], feas_tol=v[5],
    )


def assets_root() -> str:
    """The repository's shared ``assets/`` directory (beside ``tol_tpu/``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(os.path.dirname(here)), "assets")
