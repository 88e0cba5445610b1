#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tol_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
``ok`` line):

1. build   — compile every kernel source under ``tol_tpu_torch/csrc`` with
             nvcc, one compiler per source, all at once (timed as set-up).
2. kernels — hold each of the eight kernels against its plain PyTorch twin
             on the card at the solves' shapes: the cyclic-reduction level
             kernels K1-K5 at 11x11 blocks, B=128 lanes, CR levels
             h = 64..1, rhs widths m = 12, 14 and 1; the sequential-chain
             kernels K6-K8 at T=100 blocks, B=128 lanes, border widths 12
             and 14.  Each case includes a lane with an indefinite pivot
             that must come out NaN in that lane only.  Kernel, twin and a
             library yardstick are timed with CUDA events and each
             kernel's bound is reckoned; for K6-K8 also the floor that the
             T dependent steps set.
3. chains  — the same 128 chains of T=100 blocks solved by
             ``crp_factor`` + ``crp_solve``, by ``crp_factor_solve``, by
             ``chain_eliminate`` + ``chain_rhs_forward`` +
             ``chain_back_sub`` and by a dense Cholesky yardstick (which
             the port never calls); all must agree.  This is the path that
             launches K5.
4. solves  — three float32 ts=100 solves through ``make_grouped_solver``
             (two-body dive + endgame in 128-lane groups, then 128-lane
             drain chunks) with bench.py's constants:
             ``s10``          S10 / tempest / wind model 1, chain crp in
                              both bodies, gated as bench.py gates it
                              against ``tests/golden_s10_ts100.npy``
                              (>= 90% of the lanes must pass);
             ``g7``           G7 / skywalker / wind model 1, chain crp,
                              gated on convergence and feasibility
                              (>= 90%);
             ``s10_seqdive``  the S10 solve with the fused sequential
                              chain ("pallas") in the dive; >= 90% of the
                              lanes must converge feasibly, and its cost
                              gap is reported beside the crp dive's, not
                              gated.
             Every kernel that belongs to a path must be launched on it.
5. profile — one dive (crp and sequential) and one endgame iteration of 128
             lanes under torch.profiler: host wall, device busy time and
             idle share, the hand-written kernels' share, kernel launches.

The last lines are the card's name and power limit, the ``kernels`` JSON
and finally
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
# Latency from one dependent fp32 operation to the next on a Hopper SM,
# taken as 4 cycles for every operation (divisions and square roots take
# longer, so the chain floor below is a floor).
DEP_OP_CYCLES = 4

NB = 11                 # node block size
TS = 100                # collocation intervals of every solve = chain blocks
B_LANES = 128           # lanes per group / drain chunk
S10_LANES = 256         # lanes of the S10 crp solve: two groups
LEVELS = [64, 32, 16, 8, 4, 2, 1]   # CR level widths h for T=100 -> 128
TOL_REL = 1e-4          # kernel vs twin, relative max-norm, float32
TOL_CHAINS = 1e-3       # chain solves vs the dense yardstick, relative

CR_SOURCE = "tol_tpu_torch/csrc/crkern.cu"
CHAIN_SOURCE = "tol_tpu_torch/csrc/chainkern.cu"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "crp_factor_fwd_level": (
        CR_SOURCE, "tol_tpu/ops/crkern.py:168 _factor_fwd_kernel"),
    "crp_fwd_level": (CR_SOURCE, "tol_tpu/ops/crkern.py:193 _fwd_kernel"),
    "crp_bwd_level": (CR_SOURCE, "tol_tpu/ops/crkern.py:204 _bwd_kernel"),
    "crp_root": (CR_SOURCE, "tol_tpu/ops/crkern.py:213 _root_kernel + "
                 "tol_tpu/ops/crkern.py:217 _root_solve_kernel"),
    "crp_factor_level": (CR_SOURCE, "tol_tpu/ops/crkern.py:144 _factor_kernel"),
    "chain_factor": (CHAIN_SOURCE, "tol_tpu/ops/chainkern.py:133 _factor_kernel"),
    "chain_rhs_forward": (
        CHAIN_SOURCE, "tol_tpu/ops/chainkern.py:170 _rhs_forward_kernel"),
    "chain_back_sub": (CHAIN_SOURCE, "tol_tpu/ops/chainkern.py:201 _bwd_kernel"),
}
CR_LEVEL_KERNELS = ("crp_factor_fwd_level", "crp_fwd_level", "crp_bwd_level",
                    "crp_root")
CHAIN_KERNELS = ("chain_factor", "chain_rhs_forward", "chain_back_sub")
# Dependent fp32 operations on the critical path of one chain block:
# K6: Cholesky column j waits for j products, a square root and a
# division (sum over 11 columns: 77); one column of the inverse is a
# forward and a backward substitution of 11 rows, row i waiting for i
# products, a subtraction and a division (77 each); then an 11-term product
# with the inverse and an 11-term product with O^T for the next carry.
# K7: r - rcorr, Dinv r~, O^T tr.  K8: t2 x_{i+1}, one subtraction.
CHAIN_DEPTH = {"chain_factor": 77 + 77 + 77 + 11 + 11,
               "chain_rhs_forward": 1 + 11 + 11,
               "chain_back_sub": 11 + 1}


class SmokeFailure(Exception):
    pass


def _require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    _require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _kernel_name(wrapper) -> str:
    return getattr(wrapper, "kernel", wrapper.__name__)


def _launch_counts(ck, ch) -> dict:
    return {_kernel_name(k): k.launches for k in ck.KERNELS + ch.KERNELS}


def _reset_launch_counts(ck, ch) -> None:
    ck.reset_launch_counts()
    ch.reset_launch_counts()


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


def _chains(torch, gen, T, m, dev):
    """B_LANES diagonally dominant SPD block-tridiagonal chains, batch-first:
    M, O (B, T, 11, 11) with the last coupling cut, F (B, T, 11, m)."""
    A = torch.randn(B_LANES, T, NB, NB, generator=gen, device=dev) * 0.3
    M = A @ A.transpose(2, 3) + 4.0 * torch.eye(NB, device=dev)
    O = torch.randn(B_LANES, T, NB, NB, generator=gen, device=dev) * 0.1
    O[:, -1] = 0.0
    F = torch.randn(B_LANES, T, NB, m, generator=gen, device=dev)
    return M, O, F


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _compare(torch, got, ref):
    """(max abs err, relative max-norm err) over output tensors."""
    abs_err, rel_err = 0.0, 0.0
    for g, r in zip(got, ref):
        e = (g - r).abs().max().item()
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(r.abs().max().item(), 1e-30))
    return abs_err, rel_err


def _nan_lane_ok(torch, outs, col):
    """Column ``col`` of the trailing (lane) axis is NaN in every output and
    no other column is."""
    for o in outs:
        bad = torch.isnan(o).reshape(-1, o.shape[-1]).any(dim=0)
        if not bool(bad[col]) or int(bad.sum()) != 1:
            return False
    return True


def _poison_pivot(torch, args, col):
    """K1, K4, K5 invert their first operand: an indefinite block there."""
    args[0][:, :, col] = -torch.eye(NB, device=args[0].device)


def _poison_nan(torch, args, col):
    """K2, K3 apply a stored inverse: a NaN one (what K1 hands on)."""
    args[0][:, :, col] = float("nan")


def _poison_chain_pivot(torch, args, col):
    """K6: block 2 of lane ``col`` is indefinite."""
    args[0][2, :, :, col] = -torch.eye(NB, device=args[0].device)


def _poison_chain_nan(torch, args, col):
    """K7, K8 read K6's factors: NaN from block 2 on (what K6 hands on)."""
    args[0][2:, :, :, col] = float("nan")


def _cr_cases(torch, ck, gen, dev):
    """K1-K5.  Per kernel: the inputs of one CR pass over the 7 levels
    (timed), the inputs of the kernel's other solve shapes (``extra``,
    checked only), the kernel call, the twin call, and the bytes / FLOPs the
    timed pass must move / do."""
    fl = 4  # bytes per float32
    n3, n2 = NB ** 3, NB ** 2
    tri = NB * (NB + 1) // 2    # the pivot inverse reads only the lower triangle
    cols = sum(h * B_LANES for h in LEVELS)
    cases = {}

    def per_level(make):
        return [make(h * B_LANES) for h in LEVELS]

    def factor_fwd_inputs(m):
        return per_level(lambda L: [_spd_slab(torch, gen, L, dev),
                                    _spd_slab(torch, gen, L, dev),
                                    _rand_slab(torch, gen, NB, L, dev),
                                    _rand_slab(torch, gen, NB, L, dev),
                                    _rand_slab(torch, gen, m, L, dev, 1.0),
                                    _rand_slab(torch, gen, m, L, dev, 1.0)])

    def bwd_inputs(m):
        return per_level(lambda L: [_rand_slab(torch, gen, NB, L, dev),
                                    _rand_slab(torch, gen, NB, L, dev),
                                    _rand_slab(torch, gen, NB, L, dev)]
                         + [_rand_slab(torch, gen, m, L, dev, 1.0)
                            for _ in range(3)])

    # K1: factor one level + eliminate the border columns: 12 of them on
    # S10 (timed), 14 on G7.
    m = 12
    factor_flops = 2 * n3 // 6 + 2 * n3 + 10 * n3
    cases["crp_factor_fwd_level"] = dict(
        inputs=factor_fwd_inputs(m), extra=factor_fwd_inputs(14),
        kernel=ck.crp_factor_fwd_level, plain=ck.factor_fwd_level_plain,
        poison=_poison_pivot,
        bytes=cols * fl * ((tri + 3 * n2 + 2 * NB * m)
                           + (4 * n2 + 2 * NB * m)),
        flops=cols * (factor_flops + 6 * n2 * m))
    # K2: forward elimination of one new rhs column (m = 1).
    m = 1
    k2 = per_level(lambda L: [_rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, m, L, dev, 1.0),
                              _rand_slab(torch, gen, m, L, dev, 1.0)])
    cases["crp_fwd_level"] = dict(
        inputs=k2, kernel=ck.crp_fwd_level, plain=ck.fwd_level_plain,
        poison=_poison_nan,
        bytes=cols * fl * (3 * n2 + 2 * NB * m + 2 * NB * m),
        flops=cols * 6 * n2 * m)
    # K3: back-substitution of one rhs column (m = 1, timed), and of the 12
    # or 14 border columns in the factor pass.
    cases["crp_bwd_level"] = dict(
        inputs=bwd_inputs(m), extra=bwd_inputs(12) + bwd_inputs(14),
        kernel=ck.crp_bwd_level, plain=ck.bwd_level_plain,
        poison=_poison_nan,
        bytes=cols * fl * (3 * n2 + 3 * NB * m + NB * m),
        flops=cols * 6 * n2 * m)
    # K4: invert the root block and apply it to the 12 (timed) or 14 border
    # columns; in the solve pass, apply the stored inverse to one rhs column.
    m = 12
    k4 = [[_spd_slab(torch, gen, B_LANES, dev),
           _rand_slab(torch, gen, m, B_LANES, dev, 1.0), True]]
    k4_extra = [[_spd_slab(torch, gen, B_LANES, dev),
                 _rand_slab(torch, gen, 14, B_LANES, dev, 1.0), True],
                [_rand_slab(torch, gen, NB, B_LANES, dev),
                 _rand_slab(torch, gen, 1, B_LANES, dev, 1.0), False]]
    cases["crp_root"] = dict(
        inputs=k4, extra=k4_extra, kernel=ck.crp_root, plain=ck.root_plain,
        poison=_poison_pivot,
        bytes=B_LANES * fl * ((tri + NB * m) + (n2 + NB * m)),
        flops=B_LANES * (2 * n3 // 6 + 2 * n3 + 2 * n2 * m))
    # K5: factor one level, no rhs.
    k5 = per_level(lambda L: [_spd_slab(torch, gen, L, dev),
                              _spd_slab(torch, gen, L, dev),
                              _rand_slab(torch, gen, NB, L, dev),
                              _rand_slab(torch, gen, NB, L, dev)])
    cases["crp_factor_level"] = dict(
        inputs=k5, kernel=ck.crp_factor_level, plain=ck.factor_level_plain,
        poison=_poison_pivot,
        bytes=cols * fl * ((tri + 3 * n2) + 4 * n2),
        flops=cols * factor_flops)
    return cases


def _chain_cases(torch, ch, gen, dev):
    """K6-K8 at T = TS blocks and B_LANES lanes, batch-last as the kernels
    take them: border width 12 (S10; timed) and 14 (G7; ``extra``).  K7 and
    K8 get the factors K6's twin made of the same chains."""
    fl = 4
    n3, n2 = NB ** 3, NB ** 2
    tri = NB * (NB + 1) // 2
    T = TS

    def operands(nB):
        M, O, W = _chains(torch, gen, T, nB, dev)
        M, O, W = (ch._lanes_last(x) for x in (M, O, W))
        Dinv, t2, tRw, _ = ch.factor_eliminate_plain(M, O, W)
        r = torch.randn(T, NB, 1, B_LANES, generator=gen, device=dev)
        tr, _ = ch.rhs_forward_plain(Dinv, O, tRw, r)
        coef = torch.randn(nB + 1, 1, B_LANES, generator=gen, device=dev)
        return dict(factor=[M, O, W], rhs=[Dinv, O, tRw, r],
                    back=[torch.cat([tRw, tr], dim=2).contiguous(), t2, coef])

    a, b = operands(12), operands(14)
    nB = 12
    nC = nB + 1     # K8 takes [tRw | tr]
    cases = {}
    cases["chain_factor"] = dict(
        inputs=[a["factor"]], extra=[b["factor"]],
        kernel=ch._factor_eliminate_batched, plain=ch.factor_eliminate_plain,
        poison=_poison_chain_pivot,
        bytes=B_LANES * fl * (T * ((tri + n2 + NB * nB)
                                   + (2 * n2 + NB * nB)) + nB * nB),
        flops=B_LANES * T * (2 * n3 // 6 + 2 * n3 + 4 * n2 * (NB + nB)
                             + 2 * NB * nB * nB + n2 + NB * nB + nB * nB))
    cases["chain_rhs_forward"] = dict(
        inputs=[a["rhs"]], extra=[b["rhs"]],
        kernel=ch._rhs_forward_batched, plain=ch.rhs_forward_plain,
        poison=_poison_chain_nan,
        bytes=B_LANES * fl * (T * (2 * n2 + NB * nB + NB + NB) + nB),
        flops=B_LANES * T * (4 * n2 + 2 * NB * nB + NB + nB))
    cases["chain_back_sub"] = dict(
        inputs=[a["back"]], extra=[b["back"]],
        kernel=ch._back_substitute_batched, plain=ch.back_substitute_plain,
        poison=_poison_chain_nan,
        bytes=B_LANES * fl * (T * (NB * nC + n2 + NB) + nC),
        flops=B_LANES * T * (2 * NB * nC + 2 * n2 + NB))
    return cases


def check_kernels(torch, ck, ch, dev):
    """Phase 2.  Returns the per-kernel records of the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(1)
    sm_hz = float(_nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    cases = _cr_cases(torch, ck, gen, dev)
    cases.update(_chain_cases(torch, ch, gen, dev))
    records = {}
    for name, case in cases.items():
        abs_err = rel_err = 0.0
        for args in case["inputs"] + case.get("extra", []):
            got = _tuple(case["kernel"](*args))
            ref = _tuple(case["plain"](*args))
            torch.cuda.synchronize()
            a, r = _compare(torch, got, ref)
            abs_err, rel_err = max(abs_err, a), max(rel_err, r)
        _require(rel_err <= TOL_REL,
                 f"{name}: kernel vs twin relative error {rel_err:.3e} > {TOL_REL}")
        # NaN lane: an indefinite pivot (or a NaN factor) poisons one lane.
        args = [a.clone() if hasattr(a, "clone") else a
                for a in case["inputs"][0]]
        col = 1
        case["poison"](torch, args, col)
        got = _tuple(case["kernel"](*args))
        ref = _tuple(case["plain"](*args))
        torch.cuda.synchronize()
        _require(_nan_lane_ok(torch, got, col),
                 f"{name}: the NaN lane leaked or vanished")
        _require(_nan_lane_ok(torch, ref, col),
                 f"{name}: twin NaN lane leaked or vanished")
        if name == "chain_factor":
            _require(not bool(torch.isnan(got[0][:2]).any()),
                     "chain_factor: NaN before the indefinite block")

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
        source, replaces = KERNELS[name]
        records[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=abs_err, max_rel_err=rel_err,
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, launches_per_pass=len(case["inputs"]),
            bytes=case["bytes"], flops=case["flops"])
        if name in CHAIN_DEPTH:
            # what the T dependent steps alone cost at the card's highest
            # SM clock, whatever the bytes
            records[name]["chain_floor_ms"] = (
                TS * CHAIN_DEPTH[name] * DEP_OP_CYCLES / sm_hz * 1e3)
            extra = case["extra"]
            records[name]["ms_border_14"] = _time_ms(
                torch, lambda: [case["kernel"](*a) for a in extra], 50)

    # Library yardstick, never called by the port: K4's inverse against
    # torch.linalg.inv.  No single PyTorch call computes what the other
    # kernels compute.
    A = torch.randn(B_LANES, NB, NB, generator=gen, device=dev) * 0.3
    Mr = A @ A.transpose(1, 2) + 4.0 * torch.eye(NB, device=dev)
    records["crp_root"]["library_ms"] = _time_ms(
        torch, lambda: torch.linalg.inv(Mr), 50)
    return records


# ---------------------------------------------------------------------------
# phase 3: whole chains through every chain backend
# ---------------------------------------------------------------------------

def check_chains(torch, ck, ch, dev, m=12):
    """B_LANES chains of T = TS blocks with m + 1 rhs columns ([F | r]),
    solved four ways; every one must agree with the dense Cholesky solve.
    Returns (record, launch counts of one solve by each backend)."""
    T = TS
    gen = torch.Generator(device=dev).manual_seed(2)
    M, O, F = _chains(torch, gen, T, m, dev)
    r = torch.randn(B_LANES, T, NB, generator=gen, device=dev)
    K = torch.zeros(B_LANES, T * NB, T * NB, device=dev)
    for i in range(T):
        s = slice(i * NB, (i + 1) * NB)
        K[:, s, s] = M[:, i]
        if i + 1 < T:
            t = slice((i + 1) * NB, (i + 2) * NB)
            K[:, s, t] = O[:, i]
            K[:, t, s] = O[:, i].transpose(1, 2)
    Fr = torch.cat([F, r[..., None]], dim=3)            # (B, T, 11, m + 1)
    n_pad = 1 << (T - 1).bit_length()

    def dense():
        return torch.cholesky_solve(Fr.reshape(B_LANES, T * NB, m + 1),
                                    torch.linalg.cholesky(K))

    def crp_fused():
        levels, root, X = ck.crp_factor_solve(M, O, F)
        x = ck.crp_solve(levels, root, ck.crp_pad_rhs(r[..., None], n_pad))
        return torch.cat([X, x], dim=3)[:, :T]

    def crp_split():
        levels, root = ck.crp_factor(M, O)
        return ck.crp_solve(levels, root, ck.crp_pad_rhs(Fr, n_pad))[:, :T]

    def sequential():
        Dinv, t2, tF, _ = ch.chain_eliminate(M, O, F)
        tr, _ = ch.chain_rhs_forward(Dinv, O, tF, r)
        tFr = torch.cat([tF, tr[..., None]], dim=3)
        eye = torch.eye(m + 1, device=dev)
        return torch.stack(
            [ch.chain_back_sub(tFr, t2, eye[j].expand(B_LANES, m + 1))
             for j in range(m + 1)], dim=3)

    _reset_launch_counts(ck, ch)
    Xd = dense().reshape(B_LANES, T, NB, m + 1)
    rec = dict(shape=[B_LANES, T * NB, T * NB], rhs=m + 1)
    ways = dict(crp_factor_solve=crp_fused, crp_factor_then_solve=crp_split,
                chain_sequential=sequential)
    for name, fn in ways.items():
        X = fn()
        torch.cuda.synchronize()
        err = ((X - Xd).abs().max() / Xd.abs().max()).item()
        _require(err < TOL_CHAINS, f"{name} vs dense Cholesky: {err:.3e}")
        rec[f"{name}_rel_err"] = err
    launches = _launch_counts(ck, ch)
    _require(all(v > 0 for v in launches.values()),
             f"a kernel was never launched by the chain solves: {launches}")
    for name, fn in ways.items():
        rec[f"{name}_ms"] = _time_ms(torch, fn, 20)
    rec["dense_cholesky_solve_ms"] = _time_ms(torch, dense, 5)
    return rec, launches


# ---------------------------------------------------------------------------
# phase 4: the solves
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


# bench.py's constants per mission: dive length n1, group cap, budget, the
# endgame numerics on top of _bench_params, the seed of the lane noise.
MISSIONS = {
    "S10": dict(aircraft="tempest", n1=90, cap=145, budget=250, noise_seed=0,
                endgame=dict(mu_init=6e-5, kappa_inner=2.0, prox=2.5e-3),
                reference="golden_s10_ts100.npy"),
    "G7": dict(aircraft="skywalker", n1=40, cap=360, budget=600, noise_seed=1,
               endgame=dict(gamma_min=5e-6, prox=2.5e-3, mu_init=6e-5,
                            kappa_inner=2.0, gamma_shrink=0.12),
               reference="g7_bestknown_ts100.npy"),
}


def make_mission(torch, mission, lanes, dev):
    """The canonical problem of one mission at ts = TS in float32, bench.py's
    parameter sets and ``lanes`` perturbed seeds."""
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.solver.alm import ALMOptions, ALMParams
    from tol_tpu_torch.solver.canonical import canonicalize

    spec = MISSIONS[mission]
    nlp = make_problem(mission, aircraft=spec["aircraft"], ts=TS, wind_model=1,
                       dtype=torch.float32, device=dev)
    can = canonicalize(nlp, scaling="auto")
    end = dict(tol=5e-3, feas_tol=1e-4, **spec["endgame"])
    inst0 = can.nlp.inst0
    v0 = can.initial_point()
    lb, ub, fixed = can.bounds(inst0)
    gen = torch.Generator(device="cpu").manual_seed(spec["noise_seed"])
    dv = 0.01 * torch.randn(lanes, can.n, generator=gen).to(dev)
    ref = torch.tensor(np.load(os.path.join(HERE, "tests", spec["reference"])),
                       dtype=torch.float32, device=dev)
    return dict(
        mission=mission, spec=spec, can=can,
        opts=ALMOptions(max_iter=2000, dual_refine_k=4, max_ls=8,
                        factor_reuse=1),
        dive_opts=ALMOptions(max_iter=2000, dual_refine_k=0, max_ls=4,
                             factor_reuse=1),
        p2=_bench_params(torch, ALMParams, dev, max_iter=spec["cap"], **end),
        p2d=_bench_params(torch, ALMParams, dev, max_iter=spec["budget"], **end),
        p1=_bench_params(torch, ALMParams, dev, tol=1e-12, feas_tol=1e-12,
                         prox=0.0, gamma_eager=0.0, max_iter=spec["budget"]),
        v0s=torch.where(fixed, lb,
                        torch.minimum(torch.maximum(v0 + dv, lb), ub)),
        f_ref=float(can.f(can.from_physical(ref), inst0)))


def run_solve(torch, ck, ch, path, ctx, lanes, dive_chain, expect):
    """Drive one path through the grouped solver with the launch counts at 0
    just before and read just after.  Returns (record, launches, gap); every
    kernel named in ``expect`` must have been launched."""
    from tol_tpu_torch.solver.batch import make_grouped_solver
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

    can, spec = ctx["can"], ctx["spec"]
    gsolve = make_grouped_solver(
        can, make_condensed_kkt(can, refine=1, chain="crp"), ctx["opts"],
        group_size=B_LANES, drain_size=B_LANES, dive_opts=ctx["dive_opts"],
        dive_kkt=make_condensed_kkt(can, refine=0, chain=dive_chain))
    _reset_launch_counts(ck, ch)
    torch.cuda.synchronize()
    t0 = time.time()
    res = gsolve([can.nlp.inst0] * (lanes // B_LANES), None,
                 ctx["v0s"][:lanes], ctx["p1"], ctx["p2"], ctx["p2d"],
                 spec["n1"], -1.0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launch_counts(ck, ch)

    _require(np.isfinite(res.v).all(), f"{path}: non-finite final v")
    _require(res.v.shape == (lanes, can.n),
             f"{path}: bad result shape {res.v.shape}")
    gap = (res.f - ctx["f_ref"]) / max(abs(ctx["f_ref"]), 1e-9)
    feasible = res.constr_viol < 1e-4
    rec = dict(
        phase="solve", path=path, mission=ctx["mission"],
        aircraft=spec["aircraft"], wind_model=1, ts=TS, dtype="float32",
        n=can.n, m=can.m, slacks=can.n_slack, lanes=lanes, group=B_LANES,
        drain=B_LANES, dive_chain=dive_chain, endgame_chain="crp",
        n1=spec["n1"], cap=spec["cap"], max_iter=spec["budget"],
        converged=int(res.converged.sum()), feasible=int(feasible.sum()),
        converged_and_feasible=int((res.converged & feasible).sum()),
        gated_pass_with_cost_gap=int(
            (res.converged & feasible & (gap < 1e-2)).sum()),
        median_cost_gap=float(np.median(gap)),
        median_iters=int(np.median(res.iterations)),
        p90_iters=int(np.percentile(res.iterations, 90)),
        group_iters=res.group_iters, drain_iters=res.drain_iters,
        wall_s=wall, launches=launches)
    rec["ms_per_iteration"] = 1e3 * wall / (res.group_iters + res.drain_iters)
    print(json.dumps(rec), flush=True)
    _require(all(launches[k] > 0 for k in expect),
             f"{path}: a kernel of the path was never launched: {launches}")
    return rec, launches, gap


def run_solves(torch, ck, ch, dev):
    """Phase 4.  Returns (launches per path, profile context)."""
    by_path = {}
    s10 = make_mission(torch, "S10", S10_LANES, dev)
    rec, by_path["s10"], gap_crp = run_solve(
        torch, ck, ch, "s10", s10, S10_LANES, "crp", CR_LEVEL_KERNELS)
    # bench.py's gate: KKT certificate, feasibility and the cost gap.
    _require(rec["gated_pass_with_cost_gap"] >= 0.9 * S10_LANES,
             f"s10 gate: {rec['gated_pass_with_cost_gap']}/{S10_LANES} lanes "
             "pass (< 90%)")

    g7 = make_mission(torch, "G7", B_LANES, dev)
    rec, by_path["g7"], _ = run_solve(
        torch, ck, ch, "g7", g7, B_LANES, "crp", CR_LEVEL_KERNELS)
    # bench.py's G7 gate has no cost term (its cost has no unique optimal
    # value at working tolerance); the gap against the best-known point is
    # informational.
    _require(rec["converged_and_feasible"] >= 0.9 * B_LANES,
             f"g7 gate: {rec['converged_and_feasible']}/{B_LANES} lanes "
             "converged and feasible (< 90%)")

    # The same first 128 S10 seeds with the sequential chain in the dive.
    rec, by_path["s10_seqdive"], gap_seq = run_solve(
        torch, ck, ch, "s10_seqdive", s10, B_LANES, "pallas",
        CR_LEVEL_KERNELS + CHAIN_KERNELS)
    _require(rec["converged_and_feasible"] >= 0.9 * B_LANES,
             f"s10_seqdive: {rec['converged_and_feasible']}/{B_LANES} lanes "
             "converged and feasible (< 90%)")
    print(json.dumps(dict(
        phase="dive_chain_comparison", lanes=B_LANES,
        note="same seeds; cost gap not gated",
        crp=dict(median_cost_gap=float(np.median(gap_crp[:B_LANES])),
                 gap_under_gate=int((gap_crp[:B_LANES] < 1e-2).sum())),
        pallas=dict(median_cost_gap=float(np.median(gap_seq)),
                    gap_under_gate=int((gap_seq < 1e-2).sum())))), flush=True)
    bodies = [("dive", s10["dive_opts"], 0, "crp", s10["p1"]),
              ("dive_pallas", s10["dive_opts"], 0, "pallas", s10["p1"]),
              ("endgame", s10["opts"], 1, "crp", s10["p2"])]
    return by_path, (s10["can"], s10["v0s"][:B_LANES], bodies)


# ---------------------------------------------------------------------------
# phase 5: where a solver iteration's time goes
# ---------------------------------------------------------------------------

def profile_iterations(torch, ck, ch, can, v0s, bodies):
    """One iteration of each body at 128 lanes (after 6 warm-up iterations
    from the seeds): host wall, the device's busy time under torch.profiler
    (sum of kernel durations on the one stream), the hand-written kernels'
    share of it, the number of kernel launches, and each hand-written
    kernel's launches in the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tol_tpu_torch.solver.alm import make_kernel
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

    ours = ("level_kernel", "root_kernel", "chain_factor_kernel",
            "chain_rhs_forward_kernel", "chain_back_sub_kernel")
    out = {}
    for name, opts, refine, chain, p in bodies:
        kern = make_kernel(can, make_condensed_kkt(can, refine=refine,
                                                   chain=chain),
                           opts, can.nlp.inst0, v0s)
        st = kern.init_state(p, p, False)
        for _ in range(6):
            st, _ = kern.substep(st, None, p, p, None)
        torch.cuda.synchronize()
        _reset_launch_counts(ck, ch)
        t0 = time.time()
        st, _ = kern.substep(st, None, p, p, None)
        torch.cuda.synchronize()
        wall = time.time() - t0
        per_step = {k: v for k, v in _launch_counts(ck, ch).items() if v}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st, _ = kern.substep(st, None, p, p, None)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        ours_ms = sum(e.self_device_time_total for e in kernels
                      if any(s in e.key for s in ours)) / 1e3
        measured = busy_ms > 0
        out[name] = dict(
            wall_ms=1e3 * wall, chain=chain, launches_per_step=per_step,
            device_busy_ms=busy_ms if measured else None,
            device_idle_share=(1.0 - busy_ms / (1e3 * wall)) if measured
            else None,
            hand_kernels_ms=ours_ms if measured else None,
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
    from tol_tpu_torch.ops import chainkern as ch
    from tol_tpu_torch.ops import crkern as ck

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    try:
        t0 = time.time()
        built = _build.build()
        for name in built:
            _build.load_library(name)
        print(json.dumps(dict(
            phase="build", seconds=time.time() - t0,
            libraries={name: path for name, (path, _) in built.items()},
            ptxas=[ln for _, report in built.values()
                   for ln in report.splitlines()
                   if "registers" in ln or "spill" in ln
                   or "entry function" in ln])), flush=True)

        t0 = time.time()
        records = check_kernels(torch, ck, ch, dev)
        print(json.dumps(dict(phase="kernels", seconds=time.time() - t0,
                              tolerance_rel=TOL_REL)), flush=True)

        t0 = time.time()
        chains, by_path = check_chains(torch, ck, ch, dev)
        by_path = {"chains": by_path}
        print(json.dumps(dict(phase="chains", seconds=time.time() - t0,
                              tolerance_rel=TOL_CHAINS, launches=by_path["chains"],
                              **chains)), flush=True)

        t0 = time.time()
        solve_paths, ctx = run_solves(torch, ck, ch, dev)
        by_path.update(solve_paths)
        print(json.dumps(dict(phase="solves", seconds=time.time() - t0)),
              flush=True)
        # A kernel's launches: those of the solves; K5, which no solve
        # reaches, has those of the chains phase.
        for name, rec in records.items():
            rec["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
            rec["launches"] = (sum(c[name] for c in solve_paths.values())
                               or by_path["chains"][name])
            _require(rec["launches"] > 0, f"{name} was never launched")

        t0 = time.time()
        prof = profile_iterations(torch, ck, ch, *ctx)
        print(json.dumps(dict(phase="profile", seconds=time.time() - t0,
                              lanes=B_LANES, **prof)), flush=True)
        card = _nvidia_smi("name,power.limit")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(dict(phase="total", seconds=time.time() - t_start)))
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
