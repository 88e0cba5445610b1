"""The benchmark's plain float64 reference of the storm deployment
(``benchmark/reference/storm.py``) against the port's own float64
evaluation on the CPU: the demo field's samples, wind model 3's value and
gradient (order 2, the ``separable`` and ``gather`` lowerings) inside the
grid, on its cells' faces and outside it, the S10 storm NLP's rows and
cost at ts=8, the storm golden, and a field that is not the program's
caught on a program answer.

This file imports neither JAX nor the JAX package.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from tol_tpu_torch.api import make_problem
from tol_tpu_torch.io.storm import make_demo_storm_grid
from tol_tpu_torch.models.wind import WindConfig, wind_with_gradient_ned
from tol_tpu_torch.solver import alm
from tol_tpu_torch.solver.canonical import canonicalize
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
TS = 8
TOL = 1e-12


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load(os.path.join(BENCH, "reference", "storm.py"), "storm_reference")
with open(os.path.join(BENCH, "configs", "s10_storm.json")) as f:
    CFG = json.load(f)
with open(os.path.join(BENCH, "checks", "storm_batch.json")) as f:
    VIOL_ERR = json.load(f)["viol_err"]["limit"]
FEAS = CFG["gate"]["feas"]


def _wind(**over):
    """The configuration's ``wind`` with keys replaced (``args``: the
    field builder's)."""
    w = json.loads(json.dumps(CFG["wind"]))
    w["grid"]["args"].update(over.pop("args", {}))
    return {**w, **over}


def _program_wind(interp="separable"):
    w = CFG["wind"]
    return WindConfig(model=3, order=w["order"], interp=interp,
                      east0=w["east0"], north0=w["north0"], up0=w["up0"],
                      grid=make_demo_storm_grid(device="cpu"))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("args", [{}, {"nx": 6, "vortex_v": 3.0,
                                       "thermal_center": (17200.0, 25600.0)}])
def test_field_samples_are_the_programs_bit_for_bit(args):
    ref = REF.StormWind(_wind(args=args))
    grid = make_demo_storm_grid(**args, dtype=torch.float64, device="cpu")
    for c, name in enumerate("uvw"):
        assert torch.equal(ref.samples[c], getattr(grid, name).to(torch.float64))
    assert torch.equal(ref.origin, grid.origin)
    assert torch.equal(ref.spacing, grid.spacing)
    assert torch.equal(grid.live, torch.ones(3))


def _points(where: str) -> torch.Tensor:
    """Aircraft-local NED points: inside the grid (which spans about
    -300..750 m north, -400..650 m east and -550..200 m down of the datum),
    on the faces between the order-2 stencils' cells (half a spacing off
    a node on every axis) and outside the grid."""
    rng = np.random.default_rng(5)
    if where == "inside":
        P = rng.uniform([-250, -350, -500], [700, 600, 150], (40, 3))
    elif where == "outside":
        P = rng.uniform([-900, -900, -900], [1200, 1200, 400], (400, 3))
        inside = ((P >= [-300, -400, -550]) & (P <= [750, 650, 200])).all(1)
        P = P[~inside][:40]
    else:
        ijk = rng.integers(0, [8, 8, 6], (40, 3)) + 0.5
        enu = np.array([17000.0, 25500.0, 0.0]) + 150.0 * ijk
        w = CFG["wind"]
        P = np.stack([enu[:, 1] - w["north0"], enu[:, 0] - w["east0"],
                      w["up0"] - enu[:, 2]], 1)
    return torch.as_tensor(P)


@pytest.mark.parametrize("where", ["inside", "faces", "outside"])
@pytest.mark.parametrize("interp", ["separable", "gather"])
def test_wind_and_gradient_agree_with_the_program(interp, where):
    P = _points(where)
    want_w, want_g = wind_with_gradient_ned(_program_wind(interp), P)
    got_w, got_g = REF.StormWind(_wind()).ned(P)
    _close(got_w, want_w)
    _close(got_g, want_g)


def _storm_can(interp="separable"):
    nlp = make_problem("S10", aircraft="tempest", ts=TS, wind_model=3,
                       wind=_program_wind(interp), dtype=torch.float64,
                       device="cpu")
    return nlp, canonicalize(nlp, scaling="auto")


@pytest.mark.parametrize("interp", ["separable", "gather"])
def test_rows_cost_and_judge_agree_with_the_programs_evaluation(interp):
    nlp, can = _storm_can(interp)
    prob = REF.Problem("S10", "tempest", ts=TS, wind=_wind())
    sc = REF.Scaling(prob)
    for got, want in ((sc.d_z, can.scaling.d_z), (sc.r_b, can.scaling.r_b)):
        assert torch.allclose(got, want, rtol=1e-13, atol=0)
    assert sc.d_dt == pytest.approx(float(can.scaling.d_dt), rel=1e-15)
    assert sc.s_f == pytest.approx(float(can.scaling.s_f), rel=1e-12)
    lb, ub, fixed = can.bounds(nlp.inst0)
    g = torch.Generator().manual_seed(11)
    v = can.initial_point()[None] + 0.05 * torch.randn(4, can.n, generator=g,
                                                      dtype=torch.float64)
    v = torch.where(fixed, lb, torch.minimum(torch.maximum(v, lb), ub))
    Z, dt, s = REF.split(v * sc.v_scale(), TS)
    d = prob.defects(Z, dt) / sc.d_z[:8]
    c = can.c(v, None)
    _close(d.flatten(-2), c[:, :TS * 8])
    J = REF.judge_scaled(prob, sc, v.numpy())
    assert torch.allclose(J["row_viol"], c.abs().max(-1).values,
                          rtol=1e-12, atol=1e-14)
    assert torch.allclose(J["viol"], J["row_viol"])           # inside the boxes
    assert torch.allclose(J["f"], can.f(v, None), rtol=1e-12, atol=0)


def test_storm_golden_is_feasible_under_the_reference():
    prob = REF.Problem("S10", "tempest", wind=_wind())
    sc = REF.Scaling(prob)
    g = torch.as_tensor(np.load(os.path.join(BENCH, CFG["gate"]["golden"])))
    J = REF.judge_scaled(prob, sc, (g / sc.v_scale()).numpy()[None])
    assert float(J["viol"][0]) < 1e-4 * FEAS
    F = REF.golden_cost(prob, os.path.join(BENCH, CFG["gate"]["golden"]))
    assert float(J["F"][0]) == pytest.approx(F, rel=1e-14)


@pytest.fixture(scope="module")
def answer():
    """One lane solved by the port at ts=8 in float64, to the endgame's
    tolerances: its scaled answer and the violation it claims."""
    nlp, can = _storm_can()
    lb, ub, fixed = can.bounds(nlp.inst0)
    noise = 0.01 * np.random.default_rng(2).standard_normal((1, can.n))
    v0 = torch.minimum(torch.maximum(can.initial_point() + torch.as_tensor(
        noise), lb), ub)
    p = dict(CFG["params"]["base"], **CFG["params"]["endgame"])
    params = alm.ALMParams(
        **{k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()},
        max_iter=torch.tensor(200, dtype=torch.int32))
    sv = CFG["solver"]
    res = alm.solve(can, make_condensed_kkt(can, refine=sv["refine"]),
                    alm.ALMOptions(max_iter=2000, max_ls=sv["max_ls"],
                                   dual_refine_k=sv["dual_refine_k"]),
                    v0=torch.where(fixed, lb, v0), params=params)
    assert bool(res.converged[0]) and float(res.constr_viol[0]) < FEAS
    return res.v.numpy(), float(res.constr_viol[0])


def _viol_err(answer, wind) -> float:
    """``viol_err`` of the benchmark's check (``kinds/grouped_batch.py``)
    on the program's answer, judged in ``wind``."""
    v, claimed = answer
    prob = REF.Problem("S10", "tempest", ts=TS, wind=wind)
    J = REF.judge_scaled(prob, REF.Scaling(prob), v)
    return abs(claimed - float(J["viol"][0])) / FEAS


@pytest.mark.parametrize("fault", [dict(order=1),
                                   dict(args={"vortex_v": 2.6}),
                                   dict(args={"thermal_r0": 160.0})])
def test_a_field_that_is_not_the_programs_fails_viol_err(answer, fault):
    """The program's answer reads ``viol_err`` far under the cell's limit
    in the configuration's field, and over it in a trilinear or slightly
    perturbed one."""
    assert _viol_err(answer, _wind()) < 0.01 * VIOL_ERR
    assert _viol_err(answer, _wind(**fault)) > VIOL_ERR
