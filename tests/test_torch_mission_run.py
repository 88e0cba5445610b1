"""A whole receding-horizon mission through the real single-lane leg solver
(``MissionConfig()``'s defaults but ts and the leg tolerance: chain "cr",
one lane per leg, warm starts with a cold retry) in both packages on the
same goal (float64, CPU).

G7's default scaling differs between the packages in one row (ROADMAP.md
queue C), so the port's canonicalize takes tol_tpu's scaling of G7, as
tests/test_torch_mission.py does: both packages then solve the same legs.
"""

import jax
import numpy as np
import pytest
import torch

from tol_tpu.api import make_problem as jmake_problem
from tol_tpu.mission import mission as jmission
from tol_tpu.mission.autopilot import FakeAutopilot as JFake
from tol_tpu.solver import canonicalize as jcanonicalize
from tol_tpu_torch.mission import mission as tmission
from tol_tpu_torch.mission.autopilot import FakeAutopilot as TFake
from tol_tpu_torch.solver import canonical as tcanonical

TS = 8
# The aircraft starts about (96, 170) m east and north of the datum: three
# G7 legs (the second and third warm-started) bring it within the 100 m
# ring, then the S10 loiter ends the mission.
GOAL = (275.0, 170.0, 0.0, 100.0)
TOL = 1e-8


def _carry_jax_scaling(monkeypatch, aircraft):
    real = tcanonical.default_scaling

    def jax_scaling(nlp, dtype=None):
        if nlp.mission != "G7":
            return real(nlp, dtype)
        jn = jmake_problem("G7", aircraft, ts=TS, wind_model=1)
        sc = jcanonicalize(jn, scaling="auto").scaling
        return tcanonical.scaling_from_numpy(
            jax.tree_util.tree_map(np.asarray, sc)._asdict(), device="cpu")

    monkeypatch.setattr(tcanonical, "default_scaling", jax_scaling)


def test_single_lane_mission_run_matches(monkeypatch):
    """``Mission.run`` with the default leg solver: the same legs (mission
    type, goal, flags, iterations, warm starts, cold retries) and log;
    each leg's cost and trajectory and the stitched trajectory within 1e-8
    (relative to each column's scale).  A leg tolerance of 1e-2 keeps the
    legs at 5-100 iterations on the CPU."""
    kw = dict(ts=TS, leg_feas_tol=1e-2, max_legs=6)
    jcfg = jmission.MissionConfig(**kw)
    tcfg = tmission.MissionConfig(device="cpu", dtype=torch.float64, **kw)
    assert (tcfg.leg_ensemble, tcfg.leg_chain) == (0, "cr")
    assert (jcfg.leg_ensemble, jcfg.leg_chain) == (0, "cr")
    _carry_jax_scaling(monkeypatch, tcfg.aircraft)
    jm = jmission.Mission(jcfg, JFake())
    tm = tmission.Mission(tcfg, TFake())
    jtraj, ttraj = jm.run(GOAL), tm.run(GOAL)

    kinds = [len(d["trajectory"]["x"]) for d in jm.legs]
    assert len(tm.legs) == len(jm.legs) >= 3
    assert [d["converged"] for d in jm.legs] == [True] * len(jm.legs)
    assert any(d["used_warm"] for d in jm.legs)
    assert tm.log == jm.log
    assert "S10" in jm.log[-1] and kinds == [TS + 1] * len(kinds)
    for dt_, dj in zip(tm.legs, jm.legs):
        for key in ("converged", "iterations", "used_warm", "cold_retry"):
            assert dt_[key] == dj[key], key
        assert dt_["FinalCost"] == pytest.approx(dj["FinalCost"], rel=TOL)
        for k, col in dj["trajectory"].items():
            np.testing.assert_allclose(dt_["trajectory"][k], col, rtol=0,
                                       atol=TOL * max(1.0, np.abs(col).max()))
    jd, td = jtraj.to_json(), ttraj.to_json()
    assert sorted(td) == sorted(jd)
    for k, col in jd.items():
        if isinstance(col, list) and col and isinstance(col[0], float):
            np.testing.assert_allclose(td[k], col, rtol=0,
                                       atol=TOL * max(1.0, np.abs(col).max()),
                                       err_msg=k)
        else:
            assert td[k] == col, k
