"""The port's ALM solver against tol_tpu's (float64, CPU, S10 / tempest /
wind model 1 at ts=12).

The per-step tests feed JAX's carried state into the port (through
alm_state_from_numpy) and compare one step at a time, so each comparison
is of one step's arithmetic.  The helpers here are shared with
tests/test_torch_batch.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tol_tpu.api import make_problem as jmake_problem
from tol_tpu.solver import alm as jalm
from tol_tpu.solver import canonicalize as jcanonicalize
from tol_tpu.solver.kkt_condensed import make_condensed_kkt as jcondensed
from tol_tpu_torch.api import make_problem as tmake_problem
from tol_tpu_torch.solver import alm as talm
from tol_tpu_torch.solver.canonical import canonicalize as tcanonicalize
from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt as tcondensed

TS = 12
# bench.py's option sets: endgame (8 Armijo trials, dual CG k=4, refine=1)
# and dive (4 trials, no dual CG, refine=0).
END = dict(max_iter=2000, dual_refine_k=4, max_ls=8)
DIVE = dict(max_iter=2000, dual_refine_k=0, max_ls=4)


def _bench_params(**kw):
    """bench.py:_params in float64 for both packages."""
    base = dict(tol=5e-3, feas_tol=1e-4, mu_init=1e-5, mu_min=1e-5,
                mu_shrink=0.1, theta_mu=1.2, gamma_init=0.01, gamma_min=1e-6,
                gamma_shrink=0.2, prox=3e-3, eta=1e-4, tau_min=0.99,
                kappa_inner=1.0, delta_decay=0.2, gamma_eager=1.0, max_iter=400)
    base.update(kw)
    mi = base.pop("max_iter")
    pj = jalm.ALMParams(**{k: jnp.asarray(v, jnp.float64)
                           for k, v in base.items()},
                        max_iter=jnp.asarray(mi, jnp.int32))
    pt = talm.alm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, pj)._asdict(), device="cpu")
    return pj, pt


def _endgame(max_iter):
    return _bench_params(tol=5e-3, feas_tol=1e-4, mu_init=6e-5,
                         kappa_inner=2.0, prox=2.5e-3, max_iter=max_iter)


def _dive(max_iter):
    return _bench_params(tol=1e-12, feas_tol=1e-12, prox=0.0, gamma_eager=0.0,
                         max_iter=max_iter)


@functools.lru_cache(maxsize=None)
def _problem():
    jc = jcanonicalize(jmake_problem("S10", "tempest", ts=TS, wind_model=1),
                       scaling="auto")
    tc = tcanonicalize(tmake_problem("S10", "tempest", ts=TS, wind_model=1,
                                     device="cpu"), scaling="auto")
    return jc, tc


def _seeds(jc, n):
    """bench.py's seeds: 0.01 N(0, 1) around the initial point, clipped into
    the bounds, fixed variables at their bound (numpy noise for both)."""
    lb, ub, fixed = [np.asarray(x) for x in jc.bounds(jc.nlp.inst0)]
    v0 = np.asarray(jc.initial_point())
    dv = 0.01 * np.random.default_rng(0).standard_normal((n, jc.n))
    return np.where(fixed, lb, np.clip(v0 + dv, lb, ub))


def _to_torch_state(sj):
    fields = {k: np.asarray(v)[None] for k, v in sj._asdict().items()}
    return talm.alm_state_from_numpy(fields, device="cpu")


def _assert_state_close(st, sj, what):
    for k in talm.ALMState._fields:
        got = getattr(st, k)[0].numpy()
        want = np.asarray(getattr(sj, k))
        if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
            assert np.array_equal(got, want), (what, k, got, want)
        else:
            # one Newton step: the KKT solve's round-off, amplified by the
            # dual recovery's 1/gamma (gamma >= 1e-6 here)
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-8 * max(1.0, np.abs(want).max()),
                err_msg=f"{what}: {k}")


@pytest.mark.parametrize("mode", ["dive", "continuation"])
def test_alm_substeps_match_jax(mode):
    """Six substeps from the same carried states, after five JAX steps from
    the seed (the first five steps at the seed are factorization failures
    that only grow the primal shift).  "dive": the dive body (dive params,
    refine=0, 4 trials).  "continuation": the endgame body with the in-loop
    Phase1 switch (dive -> endgame at iteration 8), the drain's program."""
    jc, tc = _problem()
    v0 = _seeds(jc, 1)[0]
    p1j, p1t = _dive(250)
    p2j, p2t = _endgame(250)
    if mode == "dive":
        oj, ot, refine = jalm.ALMOptions(**DIVE), talm.ALMOptions(**DIVE), 0
        phj = pht = None
        p1j, p1t, p2j, p2t = p1j, p1t, p1j, p1t
    else:
        oj, ot, refine = jalm.ALMOptions(**END), talm.ALMOptions(**END), 1
        phj = jalm.Phase1(params=p1j, n_max=jnp.asarray(8, jnp.int32),
                          exit_df=jnp.asarray(-1.0), patience=3)
        pht = talm.Phase1(params=p1t, n_max=torch.tensor(8, dtype=torch.int32),
                          exit_df=torch.tensor(-1.0, dtype=torch.float64))
    kj = jalm.make_kernel(jc, jcondensed(jc, refine=refine, chain="crp"), oj,
                          jc.nlp.inst0, jnp.asarray(v0))
    kt = talm.make_kernel(tc, tcondensed(tc, refine=refine, chain="crp"), ot,
                          tc.nlp.inst0, torch.as_tensor(v0)[None])
    sj = kj.init_state(p1j, p2j, phj is not None)
    _assert_state_close(kt.init_state(p1t, p2t, pht is not None), sj, "init")
    step = jax.jit(lambda s: kj.substep(s, None, p1j, p2j, phj)[0])
    for _ in range(5):
        sj = step(sj)
    moved = 0.0
    for k in range(6):
        st, _ = kt.substep(_to_torch_state(sj), None, p1t, p2t, pht)
        sj_next = step(sj)
        _assert_state_close(st, sj_next, f"step {k}")
        moved = max(moved, float(np.abs(np.asarray(sj_next.v)
                                        - np.asarray(sj.v)).max()))
        sj = sj_next
    assert moved > 0.0                      # the steps really moved v
    if mode == "continuation":
        assert int(sj.phase) == 1           # the phase switch happened


def test_phase_switch_state_matches_jax():
    jc, tc = _problem()
    v0 = _seeds(jc, 1)[0]
    p1j, p1t = _dive(250)
    p2j, p2t = _endgame(145)
    kj = jalm.make_kernel(jc, jcondensed(jc, refine=0, chain="crp"),
                          jalm.ALMOptions(**DIVE), jc.nlp.inst0, jnp.asarray(v0))
    sj = kj.init_state(p1j, p1j, False)
    sj = jax.jit(lambda s: kj.substep(s, None, p1j, p1j, None)[0])(sj)
    want = jalm.phase_switch_state(jc, sj, p2j)
    got = talm.phase_switch_state(tc, _to_torch_state(sj), p2t)
    _assert_state_close(got, want, "switch")


def test_results_do_not_depend_on_check_every(monkeypatch):
    """A finished lane is frozen, so how often the host tests for "all lanes
    done" cannot change any lane's result."""
    _, tc = _problem()
    jc, _ = _problem()
    V = torch.as_tensor(_seeds(jc, 3))
    _, p1t = _dive(12)
    kkt = tcondensed(tc, refine=0, chain="crp")
    opts = talm.ALMOptions(**DIVE)
    state0 = talm.solve(tc, kkt, opts, v0=V, params=p1t._replace(
        max_iter=torch.tensor(3, dtype=torch.int32)), keep_state=True).state
    # lanes stop at different counters: 3 more, 5 more, 9 more steps
    state0 = state0._replace(it=state0.it + torch.tensor([6, 4, 0],
                                                         dtype=torch.int32))
    runs = []
    for k in (1, 4, 50):
        monkeypatch.setattr(talm, "_CHECK_EVERY", k)
        runs.append(talm.solve(tc, kkt, opts, params=p1t, state0=state0))
    for r in runs[1:]:
        for a, b in zip(r[:9], runs[0][:9]):
            assert torch.equal(a, b)
    assert runs[0].iterations.tolist() == [12, 12, 12]
