"""The multi-airframe sweep of bench.py (config 3) through the port's grouped
solver against tol_tpu's (float64, CPU, S10 / wind model 1 at ts=12): one
canonical problem (scaled on tempest's default instance), one Instance per
group, here tempest and tempest_wences.

Seeds as bench.py's ``seeds_for``: each lane's own initial point and bounds,
numpy noise for both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_solver import DIVE, END, TS, _dive, _endgame, _problem
from tol_tpu import api as japi
from tol_tpu.models.wind import WindConfig as JWindConfig
from tol_tpu.problems.base import make_instance as jmake_instance
from tol_tpu.solver import alm as jalm
from tol_tpu.solver.batch import make_grouped_solver as jgrouped
from tol_tpu.solver.kkt_condensed import make_condensed_kkt as jcondensed
from tol_tpu_torch import api as tapi
from tol_tpu_torch.models.wind import WindConfig as TWindConfig
from tol_tpu_torch.problems.base import make_instance as tmake_instance
from tol_tpu_torch.solver import alm as talm
from tol_tpu_torch.solver.batch import make_grouped_solver as tgrouped
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt as tcondensed

AIRFRAMES = ["tempest", "tempest_wences"]


def test_grouped_airframe_sweep_matches_jax():
    """Two groups of two lanes, one airframe each; dive 10, group cap 20,
    budget 30, which every lane spends, so the drain runs one chunk per
    airframe (lanes that share an Instance share a chunk)."""
    jc, tc = _problem()
    GB, n1, cap1, full = 2, 10, 20, 30
    N = GB * len(AIRFRAMES)
    jinsts = [jmake_instance(japi.make_config("S10", a, ts=TS, wind_model=1),
                             japi.default_goal("S10"), JWindConfig(model=1))
              for a in AIRFRAMES]
    tinsts = [tmake_instance(tapi.make_config("S10", a, ts=TS, wind_model=1),
                             tapi.default_goal("S10"), TWindConfig(model=1),
                             device="cpu") for a in AIRFRAMES]
    noise = 0.01 * np.random.default_rng(2).standard_normal((N, jc.n))
    V = []
    for i in range(N):
        inst = jinsts[i // GB]
        lb, ub, fixed = [np.asarray(x) for x in jc.bounds(inst)]
        v0 = np.asarray(jc.initial_point(inst))
        V.append(np.where(fixed, lb, np.clip(v0 + noise[i], lb, ub)))
        # the port builds the same lane from its own Instance
        np.testing.assert_allclose(
            tc.initial_point(tinsts[i // GB]).numpy(), v0, rtol=0, atol=1e-12)
    V = np.stack(V)
    assert np.abs(V[0] - V[GB]).max() > 1e-3      # the airframes do differ

    p1j, p1t = _dive(full)
    p2j, p2t = _endgame(cap1)
    p2dj, p2dt = _endgame(full)
    gj = jgrouped(jc, jcondensed(jc, refine=1, chain="crp"),
                  jalm.ALMOptions(**END), group_size=GB, drain_size=GB,
                  dive_opts=jalm.ALMOptions(**DIVE),
                  dive_kkt=jcondensed(jc, refine=0, chain="crp"))
    gt = tgrouped(tc, tcondensed(tc, refine=1, chain="crp"),
                  talm.ALMOptions(**END), group_size=GB, drain_size=GB,
                  dive_opts=talm.ALMOptions(**DIVE),
                  dive_kkt=tcondensed(tc, refine=0, chain="crp"))
    lane_insts = jax.tree_util.tree_map(
        lambda *x: jnp.stack(x), *[jinsts[i // GB] for i in range(N)])
    rj = gj(jinsts, lane_insts, jnp.asarray(V), p1j, p2j, p2dj, n1, -1.0)
    rt = gt(tinsts, None, torch.as_tensor(V), p1t, p2t, p2dt, n1, -1.0)
    assert rt.group_iters == rj.group_iters
    assert rt.drain_iters == rj.drain_iters
    np.testing.assert_array_equal(rt.converged, np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.iterations, np.asarray(rj.iterations))
    # 30 Newton steps, each amplifying round-off by the dual recovery's
    # 1/gamma
    np.testing.assert_allclose(rt.f, np.asarray(rj.f, np.float64), rtol=1e-6)
    np.testing.assert_allclose(rt.v, np.asarray(rj.v), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(rj.v)).max())
    np.testing.assert_allclose(rt.constr_viol, np.asarray(rj.constr_viol),
                               rtol=1e-5, atol=1e-9)
