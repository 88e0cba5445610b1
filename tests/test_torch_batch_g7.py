"""The second slice's G7 path as a whole: the grouped two-body + drain
solver on G7 / skywalker / wind model 1 at ts=8 against tol_tpu's (float64,
CPU), chain "crp" in both bodies, bench.py's G7 numerics with short caps,
tol_tpu's scaling carried across (tests/test_torch_g7.py says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_g7 import g7_pair, g7_params, g7_seeds
from test_torch_solver import DIVE, END
from tol_tpu.solver import alm as jalm
from tol_tpu.solver.batch import make_grouped_solver as jgrouped
from tol_tpu.solver.kkt_condensed import make_condensed_kkt as jcondensed
from tol_tpu_torch.solver import alm as talm
from tol_tpu_torch.solver.batch import make_grouped_solver as tgrouped
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt as tcondensed


def test_grouped_g7_matches_jax():
    """Dive 10, group cap 25, budget 45: no lane converges that early, so
    both drain and spend the budget, and the final points are compared."""
    _, _, jc, tc = g7_pair()
    N, GB, DB, n1, cap1, full = 2, 2, 2, 10, 25, 45
    V = g7_seeds(jc, N)
    p1j, p1t = g7_params(tol=1e-12, feas_tol=1e-12, mu_init=1e-5,
                         gamma_min=1e-6, gamma_shrink=0.2, kappa_inner=1.0,
                         prox=0.0, gamma_eager=0.0, max_iter=600)
    p2j, p2t = g7_params(max_iter=cap1)
    p2dj, p2dt = g7_params(max_iter=full)
    gj = jgrouped(jc, jcondensed(jc, refine=1, chain="crp"),
                  jalm.ALMOptions(**END), group_size=GB, drain_size=DB,
                  dive_opts=jalm.ALMOptions(**DIVE),
                  dive_kkt=jcondensed(jc, refine=0, chain="crp"))
    gt = tgrouped(tc, tcondensed(tc, refine=1, chain="crp"),
                  talm.ALMOptions(**END), group_size=GB, drain_size=DB,
                  dive_opts=talm.ALMOptions(**DIVE),
                  dive_kkt=tcondensed(tc, refine=0, chain="crp"))
    inst = jc.nlp.inst0
    insts = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *([inst] * N))
    rj = gj([inst] * (N // GB), insts, jnp.asarray(V), p1j, p2j, p2dj, n1, -1.0)
    rt = gt([tc.nlp.inst0] * (N // GB), None, torch.as_tensor(V), p1t, p2t,
            p2dt, n1, -1.0)
    assert rt.drain_iters == rj.drain_iters == full - cap1
    np.testing.assert_array_equal(rt.converged, np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.iterations, np.asarray(rj.iterations))
    # 45 Newton steps, each amplifying round-off by the dual recovery's
    # 1/gamma
    np.testing.assert_allclose(rt.f, np.asarray(rj.f, np.float64), rtol=1e-6)
    np.testing.assert_allclose(rt.v, np.asarray(rj.v), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(rj.v)).max())
    np.testing.assert_allclose(rt.constr_viol, np.asarray(rj.constr_viol),
                               rtol=1e-5, atol=1e-9)
