"""Entry points of the PyTorch/CUDA port (port of ``__graft_entry__.py``).

``entry()``             -> (fn, example_args): the batched forward step of
                           the flagship pipeline (S10 / tempest residuals
                           and one condensed KKT Newton step) over 8 lanes
                           at ts=100.
``dryrun_multichip(n)`` -> three iterations of the batched solve over an
                           n-rank ("dp", "sp") mesh, each rank solving its
                           slice of the lanes; checks the output's shape
                           and finiteness.

Both run on the CUDA device unless the caller passes ``device="cpu"``
(float64 on the CPU, float32 on the card).
"""

from __future__ import annotations

import os


def _dtype(device):
    import torch

    return torch.float64 if device.type == "cpu" else torch.float32


def _flagship(ts: int, dtype, device):
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.solver.canonical import canonicalize
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

    nlp = make_problem("S10", aircraft="tempest", ts=ts, wind_model=1,
                       dtype=dtype, device=device)
    can = canonicalize(nlp, scaling="auto")
    kkt = make_condensed_kkt(can, refine=1, chain="cr")
    return nlp, can, kkt


def make_step(can, kkt):
    """The step of ``entry``: for lanes v (B, n), the cost f (B,), the
    largest constraint residual max|c| (B,) and v + 0.1·dv, dv from one
    condensed KKT solve at y = 0, unit barrier weights, no primal shift and
    Gamma = 0.1 on every row."""
    import torch
    from torch.func import grad

    inst = can.nlp.inst0
    _, _, fixed = can.bounds(inst)

    def step(v):
        B, dtype, dev = v.shape[0], v.dtype, v.device
        f = can.f(v, inst)
        c = can.c(v, inst)
        y = torch.zeros(B, can.m, dtype=dtype, device=dev)
        sigma = torch.ones(B, can.n, dtype=dtype, device=dev)
        # lanes are independent: the gradient of the lane sum is per lane
        g = grad(lambda vv: (can.f(vv, inst)
                             + (can.c(vv, inst) * y).sum(-1)).sum())(v)
        rhs_v = torch.where(fixed, 0.0, -g)
        gamma = torch.full((B, can.m), 0.1, dtype=dtype, device=dev)
        dv, _ = kkt(v, y, sigma, torch.zeros(B, dtype=dtype, device=dev),
                    gamma, rhs_v, torch.zeros(B, can.m, dtype=dtype,
                                              device=dev), inst)
        return f, c.abs().amax(-1), v + 0.1 * dv

    return step


def entry(device=None):
    """Single-card check: one batched Newton/KKT step of the flagship S10 /
    tempest NLP (ts=100) over 8 copies of its initial point."""
    from tol_tpu_torch.problems.base import resolve_device
    from tol_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()
    device = resolve_device(device)
    _, can, kkt = _flagship(ts=100, dtype=_dtype(device), device=device)
    v0 = can.initial_point()
    return make_step(can, kkt), (v0[None, :].repeat(8, 1),)


def _dryrun_rank(rank: int, n_devices: int, port: int, device: str) -> None:
    from tol_tpu_torch.parallel.multihost import init_multihost

    init_multihost(f"127.0.0.1:{port}", n_devices, rank,
                   cpu_collectives="gloo" if device == "cpu" else None)
    try:
        _dryrun(n_devices, device)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _dryrun(n_devices: int, device) -> None:
    import torch

    from tol_tpu_torch.parallel import (global_stats_to_host, make_mesh,
                                        sharded_batch_solve)
    from tol_tpu_torch.problems.base import resolve_device
    from tol_tpu_torch.solver.alm import ALMOptions, solve as alm_solve

    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    dtype = _dtype(device)
    # Flagship-scale horizon (ts=100); GRAFT_DRYRUN_TS overrides it for
    # quick local runs, as in the JAX package.
    _, can, kkt = _flagship(ts=int(os.environ.get("GRAFT_DRYRUN_TS", "100")),
                            dtype=dtype, device=device)
    mesh = make_mesh(n_dp=n_devices, n_sp=1, devices=device.type)
    opts = ALMOptions(tol=1e-6, max_iter=3)

    batch = 2 * n_devices
    v0 = can.initial_point()
    lb, ub, fixed = can.bounds(can.nlp.inst0)
    gen = torch.Generator().manual_seed(0)
    noise = 1e-3 * torch.randn(batch, can.n, generator=gen, dtype=dtype)
    v0s = torch.clamp(v0[None] + noise.to(device), lb[None], ub[None])
    v0s = torch.where(fixed[None], lb[None], v0s)

    out = sharded_batch_solve(
        mesh, lambda _, v: alm_solve(can, kkt, opts, v0=v), None, v0s)
    vs, viol = global_stats_to_host((out.v, out.constr_viol))
    assert vs.shape == (batch, can.n), vs.shape
    assert bool(torch.isfinite(torch.as_tensor(viol.mean())))


def dryrun_multichip(n_devices: int, device=None, timeout: float = 1800.0
                     ) -> None:
    """Execute three iterations of the batched solve over an
    ``n_devices``-rank mesh with scenario-DP sharding (and the reserved
    "sp" axis).

    In a world already joined (``init_multihost``) this rank runs its part;
    otherwise one rank runs here, or ``n_devices`` ranks are spawned on
    this host (gloo with ``device="cpu"``, NCCL otherwise, one card each),
    all killed if one fails or ``timeout`` seconds pass."""
    import torch.distributed as dist

    from tol_tpu_torch.problems.base import resolve_device
    from tol_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()
    device = str(resolve_device(device))
    if dist.is_initialized() or n_devices == 1:
        _dryrun(n_devices, device)
        return
    from tol_tpu_torch.parallel.multihost import free_port, spawn_ranks

    spawn_ranks(_dryrun_rank, n_devices, (n_devices, free_port(), device),
                timeout)
