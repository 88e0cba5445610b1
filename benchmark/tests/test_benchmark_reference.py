"""The plain float64 reference: the goldens are feasible at their own
costs, it agrees with the program's own float64 evaluation on the CPU,
and it loads nothing of the program."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from harness.spec import load_cell, reference

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = reference(load_cell("s10_batch"))


def _scaled(prob, sc, name):
    v = torch.as_tensor(np.load(os.path.join(REF.DATA, name)))
    return (v / sc.v_scale()).numpy()


def test_s10_golden_is_feasible_at_its_own_cost():
    prob = REF.Problem("S10", "tempest")
    sc = REF.Scaling(prob)
    J = REF.judge_scaled(prob, sc, _scaled(prob, sc, "golden_s10_ts100.npy")[None])
    assert float(J["viol"][0]) < 1e-6
    F = REF.golden_cost(prob, "golden_s10_ts100.npy")
    assert float(J["F"][0]) == pytest.approx(F, rel=1e-14)
    assert sc.s_f == 1.0
    assert 0.2 < F < 0.5          # the loiter's cost is about its dt


def test_g7_best_known_is_feasible():
    prob = REF.Problem("G7", "skywalker")
    sc = REF.Scaling(prob)
    J = REF.judge_scaled(prob, sc, _scaled(prob, sc, "g7_bestknown_ts100.npy")[None])
    assert float(J["viol"][0]) < 1e-4
    assert float(J["F"][0]) > 0.0


def test_judges_a_leg_with_its_stitch_box():
    prob = REF.Problem("G7", "skywalker")
    sc = REF.Scaling(prob)
    v = np.load(os.path.join(REF.DATA, "g7_bestknown_ts100.npy"))
    Z = v[1:1 + 101 * 11].reshape(101, 11)
    stitch = Z[0, 3:].copy()
    ok = REF.judge_physical(REF.Problem("G7", "skywalker", stitch=stitch), sc,
                            Z, v[0])
    assert float(ok["viol"]) < 1e-4
    stitch[0] -= 3.0                                  # Va off by 3 m/s: 2 allowed
    bad = REF.judge_physical(REF.Problem("G7", "skywalker", stitch=stitch), sc,
                             Z, v[0])
    assert float(bad["viol"]) == pytest.approx(1.0 / sc.d_z[3].item(), rel=1e-9)


def test_certificate_of_the_goldens_and_of_a_feasible_point_off_optimum():
    prob = REF.Problem("S10", "tempest")
    sc = REF.Scaling(prob)
    v = _scaled(prob, sc, "golden_s10_ts100.npy")[None]
    assert REF.certificate(prob, sc, v)[0] < 1e-5
    # rounded to float32, as the program answers, it stays far under 5e-3
    assert REF.certificate(prob, sc, v.astype(np.float32))[0] < 1e-3
    # the same feasible point is no optimum once thrust costs something
    prob.gains = {**prob.gains, "kT": 2.0}
    assert REF.certificate(prob, sc, v)[0] > 1.0
    g7 = REF.Problem("G7", "skywalker")
    sc7 = REF.Scaling(g7)
    assert REF.certificate(g7, sc7, _scaled(g7, sc7, "g7_bestknown_ts100.npy")[None])[0] < 5e-3


def test_certificate_of_a_leg_document():
    prob = REF.Problem("G7", "skywalker")
    sc = REF.Scaling(prob)
    v = np.load(os.path.join(REF.DATA, "g7_bestknown_ts100.npy"))
    Z = v[1:1 + 101 * 11].reshape(101, 11)
    e = REF.certificate_physical(prob, sc, Z, v[0])
    assert e == pytest.approx(REF.certificate(prob, sc, _scaled(prob, sc, "g7_bestknown_ts100.npy")[None])[0], rel=1e-3, abs=1e-6)


@pytest.mark.parametrize("mission,airframe", [("S10", "tempest"),
                                               ("S10", "tempest_will"),
                                               ("G7", "skywalker")])
def test_agrees_with_the_programs_float64_evaluation(mission, airframe):
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.solver.canonical import canonicalize

    nlp = make_problem(mission, aircraft=airframe, ts=100, wind_model=1,
                       dtype=torch.float64, device="cpu")
    can = canonicalize(nlp, scaling="auto")
    prob = REF.Problem(mission, airframe)
    sc = REF.Scaling(prob)
    for got, want in ((sc.d_z, can.scaling.d_z), (sc.r_b, can.scaling.r_b)):
        assert torch.allclose(got, want, rtol=1e-13, atol=0)
    assert sc.d_dt == pytest.approx(float(can.scaling.d_dt), rel=1e-15)
    assert sc.s_f == pytest.approx(float(can.scaling.s_f), rel=1e-12)
    lb, ub, fixed = can.bounds(nlp.inst0)
    g = torch.Generator().manual_seed(3)
    v = can.initial_point()[None] + 0.05 * torch.randn(4, can.n, generator=g,
                                                      dtype=torch.float64)
    v = torch.where(fixed, lb, torch.minimum(torch.maximum(v, lb), ub))
    J = REF.judge_scaled(prob, sc, v.numpy())
    assert torch.allclose(J["row_viol"], can.c(v, None).abs().max(-1).values,
                          rtol=1e-12, atol=1e-14)
    assert torch.allclose(J["viol"], J["row_viol"])           # inside the boxes
    assert torch.allclose(J["f"], can.f(v, None), rtol=1e-12, atol=0)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.collocation, reference.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % BENCH
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH).stdout
    names = set(eval(out))
    assert not names & {"tol_tpu_torch", "tol_tpu", "jax", "jaxlib", "flax"}
