"""The second slice's S10 path as a whole: the grouped two-body + drain
solver with the sequential chain ("pallas") in the dive and cyclic
reduction ("crp") in the endgame, against tol_tpu's (float64, CPU, S10 /
tempest / wind model 1 at ts=12).

Same seeds and constants as tests/test_torch_batch.py, with shorter caps.
With 2 lanes tol_tpu's pallas chain takes its scan reference path under
vmap, as its own tests run it on the CPU; the port runs the plain twins of
K6-K8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_solver import DIVE, END, _dive, _endgame, _problem, _seeds
from tol_tpu.solver import alm as jalm
from tol_tpu.solver.batch import make_grouped_solver as jgrouped
from tol_tpu.solver.kkt_condensed import make_condensed_kkt as jcondensed
from tol_tpu_torch.ops import chainkern as tch
from tol_tpu_torch.solver import alm as talm
from tol_tpu_torch.solver.batch import make_grouped_solver as tgrouped
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt as tcondensed


def test_grouped_pallas_dive_matches_jax(monkeypatch):
    """Dive 20, group cap 35, budget 60: both lanes drain.  The dive must
    really go through the chain ops: one factor, one rhs pass and one
    back-substitution per dive step (refine=0), none in the endgame."""
    jc, tc = _problem()
    N, GB, DB, n1, cap1, full = 2, 2, 2, 20, 35, 60
    V = _seeds(jc, N)
    p1j, p1t = _dive(full)
    p2j, p2t = _endgame(cap1)
    p2dj, p2dt = _endgame(full)
    gj = jgrouped(jc, jcondensed(jc, refine=1, chain="crp"),
                  jalm.ALMOptions(**END), group_size=GB, drain_size=DB,
                  dive_opts=jalm.ALMOptions(**DIVE),
                  dive_kkt=jcondensed(jc, refine=0, chain="pallas"))
    gt = tgrouped(tc, tcondensed(tc, refine=1, chain="crp"),
                  talm.ALMOptions(**END), group_size=GB, drain_size=DB,
                  dive_opts=talm.ALMOptions(**DIVE),
                  dive_kkt=tcondensed(tc, refine=0, chain="pallas"))
    calls = {k.kernel: 0 for k in tch.KERNELS}
    for name in ("factor_eliminate_plain", "rhs_forward_plain",
                 "back_substitute_plain"):
        def counted(*a, _f=getattr(tch, name), _k=name):
            calls[_k] = calls.get(_k, 0) + 1
            return _f(*a)
        monkeypatch.setattr(tch, name, counted)
    inst = jc.nlp.inst0
    insts = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *([inst] * N))
    rj = gj([inst] * (N // GB), insts, jnp.asarray(V), p1j, p2j, p2dj, n1, -1.0)
    rt = gt([tc.nlp.inst0] * (N // GB), None, torch.as_tensor(V), p1t, p2t,
            p2dt, n1, -1.0)
    assert (calls["factor_eliminate_plain"], calls["rhs_forward_plain"],
            calls["back_substitute_plain"]) == (n1, n1, n1)
    assert rt.drain_iters > 0
    np.testing.assert_array_equal(rt.converged, np.asarray(rj.converged))
    # the two dives sum their block products in different orders (XLA's
    # against the kernels'), 20 + 40 Newton steps amplify that
    np.testing.assert_allclose(rt.f, np.asarray(rj.f, np.float64), rtol=1e-5)
    assert np.abs(rt.iterations - np.asarray(rj.iterations)).max() <= 2
    assert np.isfinite(rt.v).all() and rt.v.shape == (N, tc.n)
