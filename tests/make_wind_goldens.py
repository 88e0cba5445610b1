"""Write the JAX package's solve of S10 / tempest at ts=100 under wind
models 2, 4 and 5 as goldens for the PyTorch port's smoke on the card.

One float64 lane from the problem's initial point (no noise) goes through
``tol_tpu.solver.batch.make_grouped_solver`` with bench.py's config-1
constants (two-body dive of 90 iterations with 4 trials and a refine=0
crp KKT, endgame of 8 trials with dual CG k=4 and a refine=1 crp KKT,
group cap 145, budget 250; bench.py:160-233), each wind model at its
``WindConfig`` defaults.  For each model it writes the final point in
physical units as ``golden_wind<k>_ts100.npy`` (the layout of
``golden_s10_ts100.npy``) and, in ``golden_wind_ts100.json``, the
iterations, the flags and the cost the JAX package reached.

    JAX_PLATFORMS=cpu python tests/make_wind_goldens.py

``chip_smoke.py``'s ``paths`` phase holds the port's float32 lane from the
same point to these: converged, cost within 1e-2 of the golden's.
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
MODELS = (2, 4, 5)
TS = 100
N1, CAP, BUDGET = 90, 145, 250


def _params(**kw):
    """bench.py's ``_params`` in float64."""
    from tol_tpu.solver.alm import ALMParams

    base = dict(tol=5e-3, feas_tol=1e-4, mu_init=1e-5, mu_min=1e-5,
                mu_shrink=0.1, theta_mu=1.2, gamma_init=0.01, gamma_min=1e-6,
                gamma_shrink=0.2, prox=3e-3, eta=1e-4, tau_min=0.99,
                kappa_inner=1.0, delta_decay=0.2, gamma_eager=1.0,
                max_iter=400)
    base.update(kw)
    mi = base.pop("max_iter")
    return ALMParams(**{k: jnp.asarray(v, jnp.float64)
                        for k, v in base.items()},
                     max_iter=jnp.asarray(mi, jnp.int32))


def solve(model: int) -> dict:
    from tol_tpu.api import make_problem
    from tol_tpu.solver import canonicalize
    from tol_tpu.solver.alm import ALMOptions
    from tol_tpu.solver.batch import make_grouped_solver
    from tol_tpu.solver.kkt_condensed import make_condensed_kkt

    can = canonicalize(make_problem("S10", aircraft="tempest", ts=TS,
                                    wind_model=model, dtype=jnp.float64),
                       scaling="auto")
    gsolve = make_grouped_solver(
        can, make_condensed_kkt(can, refine=1, chain="crp"),
        ALMOptions(max_iter=2000, dual_refine_k=4, max_ls=8, factor_reuse=1),
        group_size=1, drain_size=1,
        dive_opts=ALMOptions(max_iter=2000, dual_refine_k=0, max_ls=4,
                             factor_reuse=1),
        dive_kkt=make_condensed_kkt(can, refine=0, chain="crp"))
    end = dict(tol=5e-3, feas_tol=1e-4, mu_init=6e-5, kappa_inner=2.0,
               prox=2.5e-3)
    inst = can.nlp.inst0
    insts = jax.tree_util.tree_map(lambda x: jnp.stack([x]), inst)
    t0 = time.time()
    res = gsolve([inst], insts, can.initial_point(inst)[None],
                 _params(tol=1e-12, feas_tol=1e-12, prox=0.0, gamma_eager=0.0,
                         max_iter=BUDGET),
                 _params(max_iter=CAP, **end), _params(max_iter=BUDGET, **end),
                 N1, -1.0)
    v = np.asarray(res.v[0])
    phys = np.asarray(can.to_physical(jnp.asarray(v)))
    np.save(os.path.join(HERE, f"golden_wind{model}_ts100.npy"), phys)
    return dict(converged=bool(res.converged[0]),
                constr_viol=float(res.constr_viol[0]),
                kkt_err=float(res.kkt_err[0]), f=float(res.f[0]),
                iterations=int(res.iterations[0]),
                seconds=round(time.time() - t0, 1))


def main():
    out = {"problem": "S10 / tempest, ts=100, WindConfig(model=k) defaults",
           "path": ("tol_tpu.solver.batch.make_grouped_solver, bench.py "
                    "config 1 constants, one lane from the initial point"),
           "dtype": "float64", "platform": "cpu",
           "jax_version": jax.__version__, "models": {}}
    for model in MODELS:
        out["models"][str(model)] = solve(model)
        print(model, out["models"][str(model)], flush=True)
    with open(os.path.join(HERE, "golden_wind_ts100.json"), "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
