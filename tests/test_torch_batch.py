"""The slice as a whole: the port's grouped two-body + drain solver against
tol_tpu's (float64, CPU, S10 / tempest / wind model 1 at ts=12).

Both run from the same numpy seeds with bench.py's constants.  Branchy
decisions (Armijo acceptance, outer updates) may flip on round-off only in
flat valleys, hence "iterations within 2"; batches that are not a multiple
of 128 take the JAX package's reference CR path, as its own tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_solver import DIVE, END, _dive, _endgame, _problem, _seeds
from tol_tpu.solver import alm as jalm
from tol_tpu.solver.batch import make_grouped_solver as jgrouped
from tol_tpu.solver.kkt_condensed import make_condensed_kkt as jcondensed
from tol_tpu_torch.solver import alm as talm
from tol_tpu_torch.solver.batch import make_grouped_solver as tgrouped
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt as tcondensed


def test_grouped_two_body_drain_matches_jax():
    """The slice as a whole: make_grouped_solver with the two-body dive +
    endgame group and the drain, bench.py's constants with small caps
    (dive 30, group cap 60, budget 150) so that both lanes drain, each in
    a drain chunk of its own."""
    jc, tc = _problem()
    N, GB, DB, n1, cap1, full = 2, 2, 1, 30, 60, 150
    V = _seeds(jc, N)
    p1j, p1t = _dive(full)
    p2j, p2t = _endgame(cap1)
    p2dj, p2dt = _endgame(full)
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
    assert rt.drain_iters > 0               # lanes really drained
    np.testing.assert_array_equal(rt.converged, np.asarray(rj.converged))
    np.testing.assert_allclose(rt.f, np.asarray(rj.f, np.float64), rtol=1e-6)
    assert np.abs(rt.iterations - np.asarray(rj.iterations)).max() <= 2
    assert abs(rt.group_iters - rj.group_iters) <= 2 * (N // GB)
    assert np.isfinite(rt.v).all() and rt.v.shape == (N, tc.n)
