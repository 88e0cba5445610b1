"""The port's root entry points against the JAX package's:
``graft_entry_torch`` (the flagship KKT step, the multi-rank dry run) and
``bench_scaling_torch`` (the CPU scaling mode's JSON line)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as jge
import bench_scaling_torch
import graft_entry_torch as tge

TS = 12
LANES = 8


def _jax_step(can, kkt):
    """The step body of ``__graft_entry__.entry`` for one lane."""
    inst = can.nlp.inst0
    dtype = jnp.float64
    _, _, fixed = can.bounds(inst)

    def step(v):
        f = can.f(v, inst)
        c = can.c(v, inst)
        y = jnp.zeros(can.m, dtype)
        sigma = jnp.ones(can.n, dtype)
        rhs_v = jnp.where(fixed, 0.0, -jax.grad(lambda vv: can.f(vv, inst)
                                                + can.c(vv, inst) @ y)(v))
        gamma = jnp.full((can.m,), 0.1, dtype)
        dv, dy = kkt(v, y, sigma, jnp.asarray(0.0, dtype), gamma,
                     rhs_v, jnp.zeros(can.m, dtype), inst)
        return f, jnp.max(jnp.abs(c)), v + 0.1 * dv

    return step


def _lanes(can, n, seed=0):
    """n lanes at 1e-5 N(0, 1) around the initial point (numpy noise),
    clipped into the bounds, fixed variables at their bound.  The entry
    steps from the initial point, where y = 0 and unit barrier weights
    give SPD pivots; at 1e-4 some lanes meet a non-SPD pivot and come out
    NaN (the solver's inertia signal) in both packages."""
    lb, ub, fixed = [np.asarray(x) for x in can.bounds(can.nlp.inst0)]
    v0 = np.asarray(can.initial_point())
    dv = 1e-5 * np.random.default_rng(seed).standard_normal((n, can.n))
    return np.where(fixed, lb, np.clip(v0 + dv, lb, ub))


def test_kkt_step_matches_jax():
    """The entry's batched step at ts=12 on 8 lanes (chain cr, float64):
    f, max|c| and v + 0.1 dv agree with the JAX step to the chains'
    tolerance of tests/test_torch_kkt.py."""
    _, jc, jkkt = jge._flagship(TS, jnp.float64)
    V = _lanes(jc, LANES)
    fj, cj, vj = [np.asarray(x) for x in
                  jax.jit(jax.vmap(_jax_step(jc, jkkt)))(jnp.asarray(V))]
    _, tc, tkkt = tge._flagship(TS, torch.float64, torch.device("cpu"))
    assert (tc.n, tc.m) == (jc.n, jc.m)
    ft, ct, vt = [x.numpy() for x in tge.make_step(tc, tkkt)(
        torch.as_tensor(V))]
    for got, want in [(ft, fj), (ct, cj), (vt, vj)]:
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())
    dv = (vj - V) / 0.1
    assert np.abs(dv).max() > 0          # the step really moved the lanes


def test_entry_and_dryrun_on_the_cpu(monkeypatch):
    """dryrun_multichip over a 2-rank gloo mesh (ranks spawned here) at
    ts=8: three solver iterations, the gathered lanes of the right shape
    and finite; entry() builds the ts=100 step over 8 lanes."""
    monkeypatch.setenv("GRAFT_DRYRUN_TS", "8")
    tge.dryrun_multichip(2, device="cpu", timeout=120)
    fn, (v0s,) = tge.entry(device="cpu")
    assert v0s.shape == (8, 1112) and v0s.dtype == torch.float64


def test_bench_scaling_cpu_mode_prints_the_jax_keys(monkeypatch, capsys):
    """The CPU mode at ts=8, 2 lanes a rank, 3 fixed iterations, over 1 and
    2 gloo ranks: one JSON line with bench_scaling.py's keys."""
    for k, v in [("SCALING_TS", "8"), ("SCALING_BATCH_PER_DEV", "2"),
                 ("SCALING_MAX_ITER", "3"), ("SCALING_PLATFORM", "cpu")]:
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench_scaling_torch, "main_cpu",
                        lambda f=bench_scaling_torch.main_cpu: f(
                            counts=(1, 2), timeout=120))
    bench_scaling_torch.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert out["metric"] == "dp_scaling_efficiency_2dev"
    assert set(out["detail"]) == {"platform", "virtual_devices", "ts",
                                  "batch_per_device", "solves_per_s"}
    assert out["detail"]["ts"] == 8
    assert set(out["detail"]["solves_per_s"]) == {"1", "2"}
    assert all(r > 0 for r in out["detail"]["solves_per_s"].values())
