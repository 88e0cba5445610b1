"""Scaling benchmarks of the PyTorch/CUDA port (port of
``bench_scaling.py``).  Prints one JSON line with that script's keys.

Two modes, chosen by the same variables as the JAX script
(``SCALING_PLATFORM``, ``SCALING_TS``, ``SCALING_BATCH_PER_DEV``,
``SCALING_MAX_ITER``, ``SCALING_BATCHES``, ``SCALING_CHAIN``):

* default (CPU): scenario-DP scaling of solves/s at 1, 2 and 4 ranks
  through the real ``make_mesh`` / ``sharded_batch_solve`` path.  Each
  rank is a process of a local gloo world (``parallel.multihost``), where
  the JAX script runs 8 virtual devices in one process; each rank gets an
  equal share of the host's cores and a fixed batch.  The ranks share one
  host, so on a host of a few cores the efficiency is that of the
  mechanism at best and means nothing about real devices.

* ``SCALING_PLATFORM=gpu``: the single-card batch curve: instance-
  iterations per second at a fixed iteration count (tol 0) over
  ``SCALING_BATCHES`` lanes, S10 / tempest / ts=100 / chain crp in
  float32.  Each lane runs its own independent solve, so this is the
  per-card curve that multi-card scenario DP multiplies.  Raises without a
  CUDA device.

    python bench_scaling_torch.py
    SCALING_PLATFORM=gpu python bench_scaling_torch.py
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch


def _build(ts, dtype, device):
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.solver.canonical import canonicalize
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

    nlp = make_problem("S10", aircraft="tempest", ts=ts, wind_model=1,
                       dtype=dtype, device=device)
    can = canonicalize(nlp, scaling="auto")
    chain = os.environ.get("SCALING_CHAIN",
                           "crp" if device.type == "cuda" else "cr")
    kkt = make_condensed_kkt(can, refine=1, chain=chain)
    return can, kkt


def _seeds(can, batch, dtype):
    """0.01 N(0, 1) around the initial point from a seeded generator (the
    JAX script draws from PRNGKey(0): the same distribution, other draws),
    clipped into the bounds, fixed variables at their bound."""
    v0 = can.initial_point()
    lb, ub, fixed = can.bounds(can.nlp.inst0)
    gen = torch.Generator().manual_seed(0)
    dv = 0.01 * torch.randn(batch, can.n, generator=gen, dtype=dtype)
    v0s = torch.minimum(torch.maximum(v0[None] + dv.to(v0.device), lb[None]),
                        ub[None])
    return torch.where(fixed[None], lb[None], v0s)


def _fixed_iteration_options(max_iter, **kw):
    """The JAX script's fixed-iteration numerics: tol 0, so every lane runs
    exactly ``max_iter`` iterations."""
    from tol_tpu_torch.solver.alm import ALMOptions

    return ALMOptions(tol=0.0, feas_tol=1e-12, max_iter=max_iter,
                      gamma_init=0.01, mu_init=1e-5, mu_shrink=0.1,
                      prox=3e-3, **kw)


def _cpu_rank(rank, n, port, ts, per_dev, max_iter, out_path):
    """One rank of the CPU mode: solve this rank's slice twice (warm, then
    timed between two barriers); rank 0 writes the global solves/s."""
    import torch.distributed as dist

    from tol_tpu_torch.parallel import (init_multihost, make_mesh,
                                        sharded_batch_solve)
    from tol_tpu_torch.solver.alm import solve as alm_solve

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    init_multihost(f"127.0.0.1:{port}", n, rank, cpu_collectives="gloo")
    try:
        dtype, device = torch.float32, torch.device("cpu")
        can, kkt = _build(ts, dtype, device)
        opts = _fixed_iteration_options(max_iter, trace=True)
        mesh = make_mesh(n_dp=n, n_sp=1)
        batch = per_dev * n
        v0s = _seeds(can, batch, dtype)

        def run():
            return sharded_batch_solve(
                mesh, lambda _, v: alm_solve(can, kkt, opts, v0=v), None,
                v0s)

        run()
        dist.barrier()
        t0 = time.perf_counter()
        out = run()
        dist.barrier()
        wall = time.perf_counter() - t0
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(dict(rate=batch / wall,
                               finite=bool(torch.isfinite(out.v).all())), f)
    finally:
        dist.destroy_process_group()


def main_cpu(counts=(1, 2, 4), timeout: float = 600.0) -> dict:
    """Solves/s at each rank count of ``counts`` (a world of that many gloo
    ranks each), and the efficiency of the largest against linear."""
    from tol_tpu_torch.parallel.multihost import free_port, spawn_ranks

    ts = int(os.environ.get("SCALING_TS", "24"))
    per_dev = int(os.environ.get("SCALING_BATCH_PER_DEV", "16"))
    max_iter = int(os.environ.get("SCALING_MAX_ITER", "12"))
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        for n in counts:
            path = os.path.join(tmp, f"rate_{n}.json")
            spawn_ranks(_cpu_rank, n, (n, free_port(), ts, per_dev, max_iter,
                                       path), timeout)
            with open(path) as f:
                res = json.load(f)
            if not res["finite"]:
                raise RuntimeError(f"{n} ranks: non-finite lanes")
            rates[n] = res["rate"]

    n_max = counts[-1]
    eff = rates[n_max] / (rates[1] * n_max) if 1 in rates else 0.0
    return {
        "metric": f"dp_scaling_efficiency_{n_max}dev",
        "value": round(100.0 * eff, 1),
        "unit": "% linear",
        "vs_baseline": round(eff / 0.8, 3),   # target >= 80% linear
        "detail": {
            "platform": "cpu",
            # the ranks are processes sharing one host's cores
            "virtual_devices": True,
            "ts": ts, "batch_per_device": per_dev,
            "solves_per_s": {str(k): v for k, v in rates.items()},
        },
    }


def main_gpu_batch_curve(batches=None, max_iter=None) -> dict:
    """Instance-iterations per second on one card at each of ``batches``
    (default ``SCALING_BATCHES``) for ``max_iter`` fixed iterations
    (default ``SCALING_MAX_ITER``), after a one-iteration warm-up at that
    batch."""
    from tol_tpu_torch.problems.base import resolve_device
    from tol_tpu_torch.solver.alm import ALMOptions, ALMParams
    from tol_tpu_torch.solver.alm import solve as alm_solve
    from tol_tpu_torch.utils.cache import enable_compile_cache

    device = resolve_device(None)
    enable_compile_cache()
    ts = int(os.environ.get("SCALING_TS", "100"))
    if max_iter is None:
        max_iter = int(os.environ.get("SCALING_MAX_ITER", "40"))
    if batches is None:
        batches = [int(b) for b in os.environ.get(
            "SCALING_BATCHES", "256,512,1024").split(",")]

    dtype = torch.float32
    can, kkt = _build(ts, dtype, device)
    opts = ALMOptions(max_iter=max_iter, dual_refine_k=4)
    p = ALMParams.from_options(_fixed_iteration_options(max_iter), dtype,
                               device)
    warm = p._replace(max_iter=torch.tensor(1, dtype=torch.int32,
                                            device=device))

    rates, iterations = {}, {}
    for b in batches:
        v0s = _seeds(can, b, dtype)
        alm_solve(can, kkt, opts, v0=v0s, params=warm)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = alm_solve(can, kkt, opts, v0=v0s, params=p)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        rates[b] = b * max_iter / wall      # instance-iterations per second
        iterations[b] = int(out.iterations.max())
        if not bool(torch.isfinite(out.f).all()):
            raise RuntimeError(f"batch {b}: non-finite costs")

    b0, b1 = batches[0], batches[-1]
    eff = rates[b1] / (rates[b0] * (b1 / b0))
    return {
        "metric": f"gpu_batch_scaling_{b0}_to_{b1}",
        "value": round(rates[b1] / rates[b0], 2),
        "unit": f"x throughput at {b1 // b0}x batch",
        "vs_baseline": round(eff / 0.8, 3),
        "detail": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "ts": ts, "fixed_iterations": max_iter,
            "iterations_run": {str(k): v for k, v in iterations.items()},
            "instance_iters_per_s": {str(k): v for k, v in rates.items()},
        },
    }


def main() -> dict:
    if os.environ.get("SCALING_PLATFORM", "cpu") == "cpu":
        out = main_cpu()
    else:
        out = main_gpu_batch_curve()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
