#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tol_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
``ok`` line):

1. build   — compile the cyclic-reduction kernels K1-K4 from
             ``tol_tpu_torch/csrc`` with nvcc (timed as set-up).
2. kernels — hold each kernel against its plain PyTorch twin on the card at
             the flagship solve's shapes (11x11 blocks, B=128 lanes, CR
             levels h = 64..1, rhs widths m = 12 and 1), including a lane
             with an indefinite pivot that must come out NaN in that lane
             only; time kernel, twin and a library yardstick with CUDA
             events and reckon each kernel's bound.
3. solve   — the flagship S10 / tempest / wind model 1 / ts=100 solve in
             float32 through ``make_grouped_solver`` (two-body dive +
             endgame in 128-lane groups, then 128-lane drain chunks) with
             bench.py's constants, gated as bench.py gates it against
             ``tests/golden_s10_ts100.npy``; at least 90% of the lanes
             must pass, and every kernel's launch count must be > 0.
4. profile — one dive and one endgame iteration of 128 lanes under
             torch.profiler: host wall, device busy time and idle share,
             the crp kernels' share, kernel launches.

The last lines are the ``solve`` and ``profile`` JSON, the card's name and
power limit, the ``kernels`` JSON and finally
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and fp32 (non-tensor) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

NB = 11                 # node block size
B_LANES = 128           # lanes per group / drain chunk on the main path
LANES = 256             # lanes of the flagship solve: two groups
LEVELS = [64, 32, 16, 8, 4, 2, 1]   # CR level widths h for T=100 -> 128
TOL_REL = 1e-4          # kernel vs twin, relative max-norm, float32

SOURCE = "tol_tpu_torch/csrc/crkern.cu"
REPLACES = {
    "crp_factor_fwd_level": "tol_tpu/ops/crkern.py:168 _factor_fwd_kernel",
    "crp_fwd_level": "tol_tpu/ops/crkern.py:193 _fwd_kernel",
    "crp_bwd_level": "tol_tpu/ops/crkern.py:204 _bwd_kernel",
    "crp_root": ("tol_tpu/ops/crkern.py:213 _root_kernel + "
                 "tol_tpu/ops/crkern.py:217 _root_solve_kernel"),
}


class SmokeFailure(Exception):
    pass


def _require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    _require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their twins
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, reps):
    """Mean ms of ``fn()`` over ``reps`` runs, by CUDA events after warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _spd_slab(torch, gen, L, dev):
    """(11, 11, L) slab of diagonally dominant SPD blocks."""
    A = torch.randn(L, NB, NB, generator=gen, device=dev) * 0.3
    M = A @ A.transpose(1, 2) + 4.0 * torch.eye(NB, device=dev)
    return M.permute(1, 2, 0).contiguous()


def _rand_slab(torch, gen, w, L, dev, scale=0.3):
    return (torch.randn(NB, w, L, generator=gen, device=dev) * scale).contiguous()


def _compare(torch, got, ref):
    """(max abs err, relative max-norm err) over output tensors."""
    abs_err, rel_err = 0.0, 0.0
    for g, r in zip(got, ref):
        e = (g - r).abs().max().item()
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(r.abs().max().item(), 1e-30))
    return abs_err, rel_err


def _nan_lane_ok(torch, outs, col):
    """Column ``col`` is NaN in every output and no other column is."""
    for o in outs:
        bad = torch.isnan(o).any(dim=0).any(dim=0)      # (L,)
        if not bool(bad[col]) or int(bad.sum()) != 1:
            return False
    return True


def _kernel_cases(torch, ck, gen, dev):
    """Per kernel: the inputs of one CR pass over the 7 levels (timed), the
    inputs of the kernel's other main-path shapes (``extra``, checked only),
    the kernel call, the twin call, and bytes / FLOPs that the timed pass
    must move / do."""
    fl = 4  # bytes per float32
    n3, n2 = NB ** 3, NB ** 2
    tri = NB * (NB + 1) // 2    # the pivot inverse reads only the lower triangle
    cases = {}

    def per_level(make):
        return [make(h * B_LANES) for h in LEVELS]

    # K1: factor one level + eliminate the 12 border columns (m = 12).
    m = 12
    k1 = per_level(lambda L: [_spd_slab(torch, gen, L, dev),
                              _spd_slab(torch, gen, L, dev),
                              _rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, m, L, dev, 1.0),
                              _rand_slab(torch, gen, m, L, dev, 1.0)])
    cols = sum(h * B_LANES for h in LEVELS)
    cases["crp_factor_fwd_level"] = dict(
        inputs=k1, kernel=ck.crp_factor_fwd_level,
        plain=ck.factor_fwd_level_plain,
        bytes=cols * fl * ((tri + 3 * n2 + 2 * NB * m)
                           + (4 * n2 + 2 * NB * m)),
        flops=cols * (2 * n3 // 6 + 2 * n3 + 10 * n3 + 6 * n2 * m))
    # K2: forward elimination of one new rhs column (m = 1).
    m = 1
    k2 = per_level(lambda L: [_rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, m, L, dev, 1.0),
                              _rand_slab(torch, gen, m, L, dev, 1.0)])
    cases["crp_fwd_level"] = dict(
        inputs=k2, kernel=ck.crp_fwd_level, plain=ck.fwd_level_plain,
        bytes=cols * fl * (3 * n2 + 2 * NB * m + 2 * NB * m),
        flops=cols * 6 * n2 * m)
    # K3: back-substitution of one rhs column (m = 1).
    k3 = per_level(lambda L: [_rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, m, L, dev, 1.0),
                              _rand_slab(torch, gen, m, L, dev, 1.0),
                              _rand_slab(torch, gen, m, L, dev, 1.0)])
    # ... and of the 12 border columns in the factor pass (m = 12).
    k3_border = per_level(lambda L: [_rand_slab(torch, gen, NB, L, dev),
                                     _rand_slab(torch, gen, NB, L, dev),
                                     _rand_slab(torch, gen, NB, L, dev)]
                          + [_rand_slab(torch, gen, 12, L, dev, 1.0)
                             for _ in range(3)])
    cases["crp_bwd_level"] = dict(
        inputs=k3, extra=k3_border, kernel=ck.crp_bwd_level,
        plain=ck.bwd_level_plain,
        bytes=cols * fl * (3 * n2 + 3 * NB * m + NB * m),
        flops=cols * 6 * n2 * m)
    # K4: invert the root block and apply it to the 12 border columns; in
    # the solve pass, apply the stored inverse to one rhs column.
    m = 12
    k4 = [[_spd_slab(torch, gen, B_LANES, dev),
           _rand_slab(torch, gen, m, B_LANES, dev, 1.0), True]]
    k4_apply = [[_rand_slab(torch, gen, NB, B_LANES, dev),
                 _rand_slab(torch, gen, 1, B_LANES, dev, 1.0), False]]
    cases["crp_root"] = dict(
        inputs=k4, extra=k4_apply, kernel=ck.crp_root, plain=ck.root_plain,
        bytes=B_LANES * fl * ((tri + NB * m) + (n2 + NB * m)),
        flops=B_LANES * (2 * n3 // 6 + 2 * n3 + 2 * n2 * m))
    return cases


def check_kernels(torch, ck, dev):
    """Phase 2.  Returns the per-kernel records of the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(1)
    records = {}
    for name, case in _kernel_cases(torch, ck, gen, dev).items():
        abs_err = rel_err = 0.0
        for args in case["inputs"] + case.get("extra", []):
            got = case["kernel"](*args)
            got = got if isinstance(got, tuple) else (got,)
            ref = case["plain"](*args)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            a, r = _compare(torch, got, ref)
            abs_err, rel_err = max(abs_err, a), max(rel_err, r)
        _require(rel_err <= TOL_REL,
                 f"{name}: kernel vs twin relative error {rel_err:.3e} > {TOL_REL}")
        # NaN lane: an indefinite pivot (or a NaN input) poisons one column.
        # K1/K4 invert their first operand: an indefinite block (-I) there;
        # K2/K3 apply a stored inverse: a NaN one (what K1 hands on).
        args = [a.clone() if hasattr(a, "clone") else a
                for a in case["inputs"][0]]
        col = 1
        if name in ("crp_fwd_level", "crp_bwd_level"):
            args[0][:, :, col] = float("nan")
        else:
            args[0][:, :, col] = -torch.eye(NB, device=dev)
        got = case["kernel"](*args)
        got = got if isinstance(got, tuple) else (got,)
        ref = case["plain"](*args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        _require(_nan_lane_ok(torch, got, col),
                 f"{name}: the NaN lane leaked or vanished")
        _require(_nan_lane_ok(torch, ref, col),
                 f"{name}: twin NaN lane leaked or vanished")

        def run_kernel(case=case):
            for a in case["inputs"]:
                case["kernel"](*a)

        def run_plain(case=case):
            for a in case["inputs"]:
                case["plain"](*a)

        ms = _time_ms(torch, run_kernel, 50)
        plain_ms = _time_ms(torch, run_plain, 3)
        t_bytes = case["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = case["flops"] / FP32_FLOP_PER_S * 1e3
        records[name] = dict(
            name=name, route="cuda", source=SOURCE,
            replaces=REPLACES[name], tpu_kernel=REPLACES[name],
            launches=0, max_abs_err=abs_err, max_rel_err=rel_err,
            ms=ms, kernel_ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, launches_per_pass=len(case["inputs"]),
            bytes=case["bytes"], flops=case["flops"])

    # Library yardsticks, never called by the port: K4's inverse against
    # torch.linalg.inv, and the whole crp_factor_solve against a dense
    # Cholesky factor + solve of the same chains.
    A = torch.randn(B_LANES, NB, NB, generator=gen, device=dev) * 0.3
    Mr = A @ A.transpose(1, 2) + 4.0 * torch.eye(NB, device=dev)
    records["crp_root"]["library_ms"] = _time_ms(
        torch, lambda: torch.linalg.inv(Mr), 50)
    return records, _dense_yardstick(torch, ck, gen, dev)


def _dense_yardstick(torch, ck, gen, dev, T=100, m=12):
    """crp_factor_solve vs torch.linalg.cholesky + cholesky_solve on the same
    B=128 chains (T=100 blocks, 12 rhs columns) assembled dense."""
    A = torch.randn(B_LANES, T, NB, NB, generator=gen, device=dev) * 0.3
    M = A @ A.transpose(2, 3) + 4.0 * torch.eye(NB, device=dev)
    O = torch.randn(B_LANES, T, NB, NB, generator=gen, device=dev) * 0.1
    O[:, -1] = 0.0
    F = torch.randn(B_LANES, T, NB, m, generator=gen, device=dev)
    K = torch.zeros(B_LANES, T * NB, T * NB, device=dev)
    for i in range(T):
        s = slice(i * NB, (i + 1) * NB)
        K[:, s, s] = M[:, i]
        if i + 1 < T:
            t = slice((i + 1) * NB, (i + 2) * NB)
            K[:, s, t] = O[:, i]
            K[:, t, s] = O[:, i].transpose(1, 2)
    Fd = F.reshape(B_LANES, T * NB, m)

    def dense():
        return torch.cholesky_solve(Fd, torch.linalg.cholesky(K))

    def crp():
        return ck.crp_factor_solve(M, O, F)[2]

    X = crp()[:, :T].reshape(B_LANES, T * NB, m)
    Xd = dense()
    torch.cuda.synchronize()
    err = ((X - Xd).abs().max() / Xd.abs().max()).item()
    _require(err < 1e-3, f"crp_factor_solve vs dense Cholesky: {err:.3e}")
    return dict(crp_factor_solve_ms=_time_ms(torch, crp, 20),
                dense_cholesky_solve_ms=_time_ms(torch, dense, 5),
                crp_vs_dense_rel_err=err, shape=[B_LANES, T * NB, T * NB],
                rhs=m)


# ---------------------------------------------------------------------------
# phase 3: the flagship solve
# ---------------------------------------------------------------------------

def _bench_params(torch, ALMParams, dev, **kw):
    """bench.py:_params on the device (float32)."""
    base = dict(tol=5e-3, feas_tol=1e-4, mu_init=1e-5, mu_min=1e-5,
                mu_shrink=0.1, theta_mu=1.2, gamma_init=0.01, gamma_min=1e-6,
                gamma_shrink=0.2, prox=3e-3, eta=1e-4, tau_min=0.99,
                kappa_inner=1.0, delta_decay=0.2, gamma_eager=1.0,
                max_iter=400)
    base.update(kw)
    mi = base.pop("max_iter")
    return ALMParams(**{k: torch.tensor(v, dtype=torch.float32, device=dev)
                        for k, v in base.items()},
                     max_iter=torch.tensor(mi, dtype=torch.int32, device=dev))


def run_solve(torch, ck, lanes, dev):
    """Phase 3.  Returns the solve record; raises SmokeFailure on a miss."""
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.solver.alm import ALMOptions, ALMParams
    from tol_tpu_torch.solver.batch import make_grouped_solver
    from tol_tpu_torch.solver.canonical import canonicalize
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

    ts, n1, cap1, max_iter = 100, 90, 145, 250
    nlp = make_problem("S10", aircraft="tempest", ts=ts, wind_model=1,
                       dtype=torch.float32, device=dev)
    can = canonicalize(nlp, scaling="auto")
    opts = ALMOptions(max_iter=2000, dual_refine_k=4, max_ls=8, factor_reuse=1)
    dive_opts = ALMOptions(max_iter=2000, dual_refine_k=0, max_ls=4,
                           factor_reuse=1)
    gsolve = make_grouped_solver(
        can, make_condensed_kkt(can, refine=1, chain="crp"), opts,
        group_size=B_LANES, drain_size=B_LANES, dive_opts=dive_opts,
        dive_kkt=make_condensed_kkt(can, refine=0, chain="crp"))
    endgame = dict(tol=5e-3, feas_tol=1e-4, mu_init=6e-5, kappa_inner=2.0,
                   prox=2.5e-3)
    p2 = _bench_params(torch, ALMParams, dev, max_iter=cap1, **endgame)
    p2d = _bench_params(torch, ALMParams, dev, max_iter=max_iter, **endgame)
    p1 = _bench_params(torch, ALMParams, dev, tol=1e-12, feas_tol=1e-12,
                       prox=0.0, gamma_eager=0.0, max_iter=max_iter)

    inst0 = can.nlp.inst0
    v0 = can.initial_point()
    lb, ub, fixed = can.bounds(inst0)
    gen = torch.Generator(device="cpu").manual_seed(0)
    dv = 0.01 * torch.randn(lanes, can.n, generator=gen).to(dev)
    v0s = torch.where(fixed, lb, torch.minimum(torch.maximum(v0 + dv, lb), ub))

    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = gsolve([inst0] * (lanes // B_LANES), None, v0s, p1, p2, p2d, n1, -1.0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k.__name__: k.launches for k in ck.KERNELS}

    _require(np.isfinite(res.v).all(), "non-finite final v")
    _require(res.v.shape == (lanes, can.n), f"bad result shape {res.v.shape}")
    golden = np.load(os.path.join(HERE, "tests", "golden_s10_ts100.npy"))
    g = torch.tensor(golden, dtype=torch.float32, device=dev)
    f_star = float(can.f(can.from_physical(g), inst0))
    gap = (res.f - f_star) / max(abs(f_star), 1e-9)
    ok = res.converged & (res.constr_viol < 1e-4) & (gap < 1e-2)
    rec = dict(
        phase="solve", mission="S10", aircraft="tempest", wind_model=1, ts=ts,
        dtype="float32", n=can.n, m=can.m, lanes=lanes, group=B_LANES,
        drain=B_LANES, n1=n1, cap1=cap1, max_iter=max_iter,
        gated_pass=int(ok.sum()), converged=int(res.converged.sum()),
        feasible=int((res.constr_viol < 1e-4).sum()),
        median_cost_gap=float(np.median(gap)),
        median_iters=int(np.median(res.iterations)),
        p90_iters=int(np.percentile(res.iterations, 90)),
        group_iters=res.group_iters, drain_iters=res.drain_iters,
        wall_s=wall, launches=launches)
    rec["ms_per_iteration"] = 1e3 * wall / (res.group_iters + res.drain_iters)
    _require(all(v > 0 for v in launches.values()),
             f"a kernel was never launched on the main path: {launches}")
    _require(rec["gated_pass"] >= 0.9 * lanes,
             f"gate: {rec['gated_pass']}/{lanes} lanes pass (< 90%)")
    bodies = [("dive", dive_opts, 0, p1), ("endgame", opts, 1, p2)]
    return rec, (can, v0s[:B_LANES], bodies)


# ---------------------------------------------------------------------------
# phase 4: where a solver iteration's time goes
# ---------------------------------------------------------------------------

def profile_iterations(torch, ck, can, v0s, bodies):
    """One dive and one endgame iteration of 128 lanes (after 6 warm-up
    iterations from the seeds): host wall with and without torch.profiler,
    the device's busy time (sum of kernel durations on the one stream), the
    crp kernels' share of it, the number of kernel launches, and each crp
    kernel's launches in the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tol_tpu_torch.solver.alm import make_kernel
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

    out = {}
    for name, opts, refine, p in bodies:
        kern = make_kernel(can, make_condensed_kkt(can, refine=refine,
                                                   chain="crp"),
                           opts, can.nlp.inst0, v0s)
        st = kern.init_state(p, p, False)
        for _ in range(6):
            st, _ = kern.substep(st, None, p, p, None)
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.time()
        st, _ = kern.substep(st, None, p, p, None)
        torch.cuda.synchronize()
        wall = time.time() - t0
        per_step = {k.__name__: k.launches for k in ck.KERNELS}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st, _ = kern.substep(st, None, p, p, None)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        crp_ms = sum(e.self_device_time_total for e in kernels
                     if "level_kernel" in e.key or "root_kernel" in e.key) / 1e3
        measured = busy_ms > 0
        out[name] = dict(
            wall_ms=1e3 * wall, crp_launches_per_step=per_step,
            device_busy_ms=busy_ms if measured else None,
            device_idle_share=(1.0 - busy_ms / (1e3 * wall)) if measured
            else None,
            crp_kernels_ms=crp_ms if measured else None,
            kernel_launches=sum(e.count for e in kernels) if measured else None)
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tol_tpu_torch")):
        print("chip_smoke: tol_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tol_tpu_torch.ops import _build
    from tol_tpu_torch.ops import crkern as ck

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.time()
        lib_path, ptxas = _build.build()
        _build.load_library()
        build = dict(phase="build", seconds=time.time() - t0, library=lib_path,
                     ptxas=[ln for ln in ptxas.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "entry function" in ln])
        print(json.dumps(build), flush=True)

        t0 = time.time()
        records, dense = check_kernels(torch, ck, dev)
        print(json.dumps(dict(phase="kernels", seconds=time.time() - t0,
                              tolerance_rel=TOL_REL, dense_yardstick=dense)),
              flush=True)

        solve, ctx = run_solve(torch, ck, LANES, dev)
        for name, n in solve["launches"].items():
            records[name]["launches"] = n
        print(json.dumps(solve), flush=True)
        print(json.dumps(dict(phase="profile", lanes=B_LANES,
                              **profile_iterations(torch, ck, *ctx))),
              flush=True)
        card = _card_line()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
