#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tol_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
``ok`` line):

1. build   — compile every kernel source under ``tol_tpu_torch/csrc`` with
             nvcc, one compiler per source, all at once, beside
             ``tol_tpu_torch/tools/chain_clock.cu`` (timed as set-up).
   clock   — ``chain_clock``: clock64 traces of a chain step of K6-K8
             (the second slice's kernels and the shipped ones), the latency
             of a square root, quotient and FMA, and K6's fast-path square
             root and quotient against the library's on 2^26 operands each
             (any differing bits fail the phase).
2. kernels — hold each of the seven kernels against its plain PyTorch twin
             on the card at the solves' shapes: the cyclic-reduction
             kernels K1-K3, K5 at 11x11 blocks, B=128 lanes, T=100 blocks
             padded to 128 (CR levels h = 64..1), rhs widths m = 12, 14
             and 1 (each takes the level-0 operands and runs the 7 levels
             and the root step in one launch; K5 is K1 with no rhs);
             the sequential-chain kernels K6-K8 at T=100 blocks, B=128
             lanes, border widths 12 and 14.  Each case includes a lane
             with an indefinite pivot that must come out NaN in that lane
             only.  Kernel, twin and a library yardstick are timed with
             CUDA events, each kernel also by its own device time under
             torch.profiler, both warm (the operands in the 50 MB L2 from
             the run before) and cold (a 128 MiB write between runs), and
             each kernel's bound is reckoned; for K6-K8 also the floor that
             the T dependent steps set.  Beside K7, the device time of the
             batch-last copies of O and r that its public wrapper makes.
   sweep   — K6-K8 at every lane group size and thread count of SWEEP:
             device time; every shape must give the shipped shape's bits.
3. chains  — the same 128 chains of T=100 blocks solved by
             ``crp_factor`` + ``crp_solve``, by ``crp_factor_solve``, by
             ``chain_eliminate`` + ``chain_rhs_forward`` +
             ``chain_back_sub`` and by a dense Cholesky yardstick (which
             the port never calls); all must agree.  This is the path that
             launches K5, once for ``crp_factor``.
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
             Every kernel that belongs to a path must be launched on it,
             and K5 (crp_factor) on none of them.
   storm   — bench.py config 5 through the same grouped solver: S10 /
             tempest / wind model 3 on the demo storm grid (order 2,
             interp "auto": separable), a 4-trial endgame, group cap 175,
             128 lanes, gated against ``tests/golden_storm_ts100.npy``
             (>= 90% of the lanes must pass).
   replan  — bench.py config 4 through the mission layer: a cold G7 /
             skywalker leg of 128 seed lanes in 48-iteration slices, then
             ``REPLANS`` goals drawn as bench.py draws them, each
             warm-started and stitched; every leg must converge.
   cli     — ``python -m tol_tpu_torch 0 0 0 0 -100 0 100 tempest S10 --ts
             24`` in a subprocess with no ``--device``: must exit 0 and
             write a converged document.
5. profile — one dive (crp and sequential) and one endgame iteration of 128
             lanes under torch.profiler, and one storm endgame iteration:
             host wall, device busy time and idle share, the hand-written
             kernels' share, kernel launches.

The last lines are the card's name and power limit, the ``kernels`` JSON
and finally
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import re
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
STORM_LANES = 128       # lanes of the storm solve: one group plus drain
REPLANS = 3             # warm replans after the cold leg (bench.py: 9)
LEVELS = [64, 32, 16, 8, 4, 2, 1]   # CR level widths h for T=100 -> 128
TOL_REL = 1e-4          # kernel vs twin, relative max-norm, float32
TOL_CHAINS = 1e-3       # chain solves vs the dense yardstick, relative

CR_SOURCE = "tol_tpu_torch/csrc/crkern.cu"
CHAIN_SOURCE = "tol_tpu_torch/csrc/chainkern.cu"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "crp_factor_fwd_pass": (
        CR_SOURCE, "tol_tpu/ops/crkern.py:168 _factor_fwd_kernel + "
        "tol_tpu/ops/crkern.py:213 _root_kernel"),
    "crp_fwd_pass": (CR_SOURCE, "tol_tpu/ops/crkern.py:193 _fwd_kernel + "
                     "tol_tpu/ops/crkern.py:217 _root_solve_kernel"),
    "crp_bwd_pass": (CR_SOURCE, "tol_tpu/ops/crkern.py:204 _bwd_kernel"),
    "crp_factor_pass": (CR_SOURCE, "tol_tpu/ops/crkern.py:144 _factor_kernel + "
                        "tol_tpu/ops/crkern.py:213 _root_kernel"),
    "chain_factor": (CHAIN_SOURCE, "tol_tpu/ops/chainkern.py:133 _factor_kernel"),
    "chain_rhs_forward": (
        CHAIN_SOURCE, "tol_tpu/ops/chainkern.py:170 _rhs_forward_kernel"),
    "chain_back_sub": (CHAIN_SOURCE, "tol_tpu/ops/chainkern.py:201 _bwd_kernel"),
}
# the crp kernels of a solve path, and those of crp_factor alone
CR_PASS_KERNELS = ("crp_factor_fwd_pass", "crp_fwd_pass", "crp_bwd_pass")
CR_FACTOR_ONLY = ("crp_factor_pass",)
# kernel -> its __global__ function, as ptxas and the profiler name it
SYMBOLS = {"crp_factor_fwd_pass": "factor_fwd_pass_kernel",
           "crp_fwd_pass": "fwd_pass_kernel",
           "crp_bwd_pass": "bwd_pass_kernel",
           "crp_factor_pass": "factor_pass_kernel",
           "chain_factor": "chain_factor_kernel",
           "chain_rhs_forward": "chain_rhs_forward_kernel",
           "chain_back_sub": "chain_back_sub_kernel"}
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
# The same operations by kind (K6: 11 square roots, 33 quotients — 11 in
# the Cholesky, 22 in an inverse column — and 209 products, FMAs or
# subtractions), for the floor restated with the latencies the clock phase
# measures on the card (``chain_floor_ms_measured_latency``).
CHAIN_OPS = {"chain_factor": dict(sqrt=11, quotient=33, ffma=209),
             "chain_rhs_forward": dict(ffma=23),
             "chain_back_sub": dict(ffma=12)}
# Launch shapes of the sweep: (lanes per thread block, threads per block).
SWEEP = {"chain_factor": [(G, th) for G in (1, 2, 4, 8)
                          for th in (64, 128, 256) if th > 16 * G],
         "chain_rhs_forward": [(G, th) for G in (1, 2, 4, 8)
                               for th in (128, 256, 512) if th > 16 * G],
         "chain_back_sub": [(G, th) for G in (1, 2, 4)
                            for th in (64, 128, 256)]}
L2_FLUSH_BYTES = 128 << 20   # written between the cold runs (L2: 50 MB)


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

def _ptxas_by_kernel(reports):
    """{kernel: registers and spill bytes} from nvcc's -Xptxas -v reports;
    a kernel instantiated per lane group size G (K6, K8) as
    ``"<kernel>[G=<G>]"``."""
    out, cur = {}, None
    for ln in (ln for r in reports for ln in r.splitlines()):
        if "Compiling entry function" in ln:
            hits = [k for k, sym in SYMBOLS.items() if sym in ln]
            cur = max(hits, key=lambda k: len(SYMBOLS[k])) if hits else None
            group = re.search(r"ILi(\d+)E", ln)
            if cur and group:
                cur = f"{cur}[G={group.group(1)}]"
            if cur:
                out[cur] = {}
        elif cur and "spill stores" in ln:
            words = ln.split()
            out[cur]["spill_stores"] = int(words[words.index("spill") - 2])
            out[cur]["spill_loads"] = int(words[-4])
        elif cur and "registers" in ln:
            words = ln.split()
            out[cur]["registers"] = int(words[words.index("registers,") - 1])
    return out


def _device_ms(torch, fn, symbol, reps, flush=None):
    """Mean device time of the kernel ``symbol`` (of every kernel, for
    None) per ``fn()`` under torch.profiler (None if the profiler saw none).
    With ``flush`` (a buffer larger than the L2), the buffer is written
    before each run, so that ``fn`` finds its operands in device memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and (symbol is None or symbol in e.key))
    return us / 1e3 / reps if us > 0 else None


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


def _time_ms_cold(torch, fn, reps, flush):
    """Mean ms of ``fn()`` by CUDA events around each run alone, with the
    L2 flushed (``flush`` written) before each."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


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


def _flat_pass(levels, stack, *rest):
    """K1's outputs (per-level slabs, then the root's) as one tuple."""
    return tuple(t for lv in levels for t in lv) + tuple(stack) + rest


def _clone(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(a) for a in x)
    return x.clone() if hasattr(x, "clone") else x


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


def _nan_pass_ok(torch, outs, col, must):
    """The whole passes: no output has a NaN outside lane ``col``, and the
    outputs ``must`` (the root's, the solution) have one in it.  Slabs keep
    the lane in the trailing axis mod B_LANES, batch-first tensors in the
    leading one."""
    for i, o in enumerate(outs):
        nan = torch.isnan(o)
        lanes = (nan.reshape(-1, B_LANES).any(0) if o.shape[0] == NB
                 else nan.flatten(1).any(1))
        if int(lanes.sum()) - int(lanes[col]) or (i in must
                                                  and not bool(lanes[col])):
            return False
    return True


def _poison_fwd_nan(torch, args, col):
    """K2: lane ``col``'s factor is NaN from level 1 on and its root inverse
    NaN (what K1 hands on from an indefinite pivot at level 1)."""
    for Minv, _, _ in args[0][1:]:
        Minv.view(NB, NB, -1, B_LANES)[:, :, :, col] = float("nan")
    args[1][:, :, col] = float("nan")


def _poison_pass_pivot(torch, args, col):
    """K1, K5: lane ``col``'s first level-0 pivot (block 1) is indefinite."""
    args[0][col, 1] = -torch.eye(NB, device=args[0].device)


def _poison_pass_nan(torch, args, col):
    """K3: lane ``col``'s pivot inverse at the root level is NaN."""
    args[0][-1][0][:, :, col] = float("nan")


def _poison_chain_pivot(torch, args, col):
    """K6: block 2 of lane ``col`` is indefinite."""
    args[0][2, :, :, col] = -torch.eye(NB, device=args[0].device)


def _poison_chain_nan(torch, args, col):
    """K7, K8 read K6's factors: NaN from block 2 on (what K6 hands on)."""
    args[0][2:, :, :, col] = float("nan")


def _cr_cases(torch, ck, gen, dev):
    """K1-K3, K5.  Per kernel: the inputs of one CR pass over the 7 levels
    (timed: one launch), the inputs of the kernel's other solve shapes
    (``extra``, checked only), the kernel call, the twin call, and the
    bytes / FLOPs the timed pass must move / do."""
    fl = 4  # bytes per float32
    n3, n2 = NB ** 3, NB ** 2
    tri = NB * (NB + 1) // 2    # the pivot inverse reads only the lower triangle
    cols = sum(h * B_LANES for h in LEVELS)
    cases = {}

    def pass_inputs(m):
        """Level 0 of the K1 pass: B_LANES chains of TS blocks padded to
        n_pad = 128, batch-first."""
        M, O, F = _chains(torch, gen, TS, m, dev)
        M, O, n_pad = ck._pad_chain(M, O)
        return [M.contiguous(), O.contiguous(),
                ck.crp_pad_rhs(F, n_pad).contiguous()]

    def factor_fwd_pass_plain(M, O, F):
        return ck.factor_fwd_pass_plain(ck._to_slab(M), ck._to_slab(O),
                                        ck._to_slab(F), B_LANES)

    def bwd_inputs(m):
        """What the K3 pass takes in a factor + solve at width m: the
        factor's levels, the saved rhs blocks and the root solution."""
        levels, stack, _, x = factor_fwd_pass_plain(*pass_inputs(m))
        return [levels, stack, x]

    def fwd_inputs(m):
        """What the K2 pass takes in a solve at width m: a factor (levels,
        root inverse) and the batch-first level-0 rhs."""
        levels, _, root_inv, _ = factor_fwd_pass_plain(*pass_inputs(12))
        f = torch.randn(B_LANES, n_pad, NB, m, generator=gen, device=dev)
        return [levels, root_inv, f]

    n_pad = 2 * LEVELS[0]
    # K1: the 7-level factor pass with the border columns: 12 of them on
    # S10 (timed), 14 on G7, then the root's inverse and solution.  Least
    # bytes: level 0 read once (each odd pivot's lower triangle, even
    # blocks whole, O, F), every level's Minv, OL, OR, Fo and the root's
    # inverse and solution written once.
    m = 12
    factor_flops = 2 * n3 // 6 + 2 * n3 + 10 * n3
    root_flops = 2 * n3 // 6 + 2 * n3
    blocks = sum(LEVELS)
    cases["crp_factor_fwd_pass"] = dict(
        inputs=[pass_inputs(m)], extra=[pass_inputs(14)],
        kernel=ck.crp_factor_fwd_pass, plain=factor_fwd_pass_plain,
        flat=lambda out: _flat_pass(*out), poison=_poison_pass_pivot,
        nan_must=(-2, -1),
        bytes=B_LANES * fl * (n_pad // 2 * (tri + n2) + n_pad * (n2 + NB * m)
                              + blocks * (3 * n2 + NB * m) + n2 + NB * m),
        flops=cols * (factor_flops + 6 * n2 * m)
        + B_LANES * (root_flops + 2 * n2 * m),
        bytes_per_level_sum=cols * fl * ((tri + 3 * n2 + 2 * NB * m)
                                         + (4 * n2 + 2 * NB * m)))
    # K2: the 7-level forward elimination of one new rhs column (m = 1,
    # timed) or of 12 (checked only), then the root solution.  Least bytes:
    # the factor (every level's Minv, OL, OR and the root inverse) and
    # level 0 of f read once, every level's fo and the root solution
    # written once.  Per level, as the per-level kernel it replaces moved
    # them: Minv, OL, OR, fo, fe read, fe2, br written.
    m = 1
    cases["crp_fwd_pass"] = dict(
        inputs=[fwd_inputs(m)], extra=[fwd_inputs(12)],
        kernel=ck.crp_fwd_pass,
        plain=lambda lv, ri, f: ck.fwd_pass_plain(lv, ri, ck._to_slab(f),
                                                  B_LANES),
        flat=lambda out: _flat_pass([], *out), poison=_poison_fwd_nan,
        nan_must=(-1,),
        bytes=B_LANES * fl * (blocks * 3 * n2 + n2 + n_pad * NB * m
                              + blocks * NB * m + NB * m),
        flops=cols * 6 * n2 * m + B_LANES * 2 * n2 * m,
        bytes_per_level_sum=cols * fl * (3 * n2 + 2 * NB * m + 2 * NB * m))
    # K3: the 7-level back-substitution of one rhs column (m = 1, timed),
    # and of the 12 or 14 border columns in the factor + solve.  Least
    # bytes: the factor, the saved rhs and the root solution read once, the
    # solution written once.
    cases["crp_bwd_pass"] = dict(
        inputs=[bwd_inputs(m)], extra=[bwd_inputs(12), bwd_inputs(14)],
        kernel=ck.crp_bwd_pass,
        plain=lambda lv, st, x: ck._from_slab(
            ck.bwd_pass_plain(lv, st, x, B_LANES), B_LANES),
        poison=_poison_pass_nan, nan_must=(0,),
        bytes=B_LANES * fl * (blocks * (3 * n2 + NB * m) + NB * m
                              + n_pad * NB * m),
        flops=cols * 6 * n2 * m,
        bytes_per_level_sum=cols * fl * (3 * n2 + 3 * NB * m + NB * m))
    # K5: crp_factor's pass, K1 with no rhs: the 7 levels' factor, then
    # the root's inverse.  Least bytes: level 0 read once (each odd pivot's
    # lower triangle, even blocks whole, O), every level's Minv, OL, OR and
    # the root's inverse written once.
    def factor_inputs():
        return pass_inputs(1)[:2]

    cases["crp_factor_pass"] = dict(
        inputs=[factor_inputs()], kernel=ck.crp_factor_pass,
        plain=lambda M, O: ck.factor_pass_plain(ck._to_slab(M), ck._to_slab(O),
                                                B_LANES),
        flat=lambda out: _flat_pass(out[0], [], out[1]),
        poison=_poison_pass_pivot, nan_must=(-1,),
        bytes=B_LANES * fl * (n_pad // 2 * (tri + n2) + n_pad * n2
                              + blocks * 3 * n2 + n2),
        flops=cols * factor_flops + B_LANES * root_flops)
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


def check_kernels(torch, ck, ch, dev, latency):
    """Phase 2.  Returns the per-kernel records of the kernels line;
    ``latency`` holds the clock phase's cycles per sqrt, quotient and FMA."""
    gen = torch.Generator(device=dev).manual_seed(1)
    sm_hz = float(_nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    cases = _cr_cases(torch, ck, gen, dev)
    cases.update(_chain_cases(torch, ch, gen, dev))
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    records = {}
    for name, case in cases.items():
        abs_err = rel_err = 0.0
        flat = case.get("flat", _tuple)
        for args in case["inputs"] + case.get("extra", []):
            got = flat(case["kernel"](*args))
            ref = flat(case["plain"](*args))
            torch.cuda.synchronize()
            a, r = _compare(torch, got, ref)
            abs_err, rel_err = max(abs_err, a), max(rel_err, r)
        _require(rel_err <= TOL_REL,
                 f"{name}: kernel vs twin relative error {rel_err:.3e} > {TOL_REL}")
        # NaN lane: an indefinite pivot (or a NaN factor) poisons one lane.
        args = _clone(case["inputs"][0])
        col = 1
        case["poison"](torch, args, col)
        got = flat(case["kernel"](*args))
        ref = flat(case["plain"](*args))
        torch.cuda.synchronize()
        if "nan_must" in case:
            nan_ok = lambda outs: _nan_pass_ok(torch, outs, col,
                                               {i % len(outs)
                                                for i in case["nan_must"]})
        else:
            nan_ok = lambda outs: _nan_lane_ok(torch, outs, col)
        _require(nan_ok(got), f"{name}: the NaN lane leaked or vanished")
        _require(nan_ok(ref), f"{name}: twin NaN lane leaked or vanished")
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
        device_ms = _device_ms(torch, run_kernel, SYMBOLS[name], 20)
        ms_cold = _time_ms_cold(torch, run_kernel, 20, flush)
        device_ms_cold = _device_ms(torch, run_kernel, SYMBOLS[name], 20,
                                    flush=flush)
        plain_ms = _time_ms(torch, run_plain, 3)
        t_bytes = case["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = case["flops"] / FP32_FLOP_PER_S * 1e3
        source, replaces = KERNELS[name]
        records[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=abs_err, max_rel_err=rel_err,
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, device_ms=device_ms, ms_cold_l2=ms_cold,
            device_ms_cold_l2=device_ms_cold,
            launches_per_pass=len(case["inputs"]),
            bytes=case["bytes"], flops=case["flops"])
        if "bytes_per_level_sum" in case:
            records[name]["bound_ms_per_level_sum"] = max(
                case["bytes_per_level_sum"] / HBM_BYTES_PER_S,
                case["flops"] / FP32_FLOP_PER_S) * 1e3
        if name in CHAIN_DEPTH:
            # what the T dependent steps alone cost at the card's highest
            # SM clock, whatever the bytes
            records[name]["chain_floor_ms"] = (
                TS * CHAIN_DEPTH[name] * DEP_OP_CYCLES / sm_hz * 1e3)
            records[name]["chain_floor_ms_measured_latency"] = TS * sum(
                n * latency[op] for op, n in CHAIN_OPS[name].items()
            ) / sm_hz * 1e3
            extra = case["extra"]
            records[name]["ms_border_14"] = _time_ms(
                torch, lambda: [case["kernel"](*a) for a in extra], 50)

    # No single PyTorch call computes what a kernel computes (a whole CR
    # pass, a sequential chain with its carries), so library_ms stays None.
    _, O, _, r = cases["chain_rhs_forward"]["inputs"][0]
    records["chain_rhs_forward"]["lanes_last_copies_device_ms"] = (
        k7_copies_device_ms(torch, ch, O, r))
    return records


def k7_copies_device_ms(torch, ch, O, r):
    """Device ms of the batch-last copies of O (T, 11, 11, B) and r
    (T, 11, 1, B) that chain_rhs_forward makes of the solver's batch-first
    operands on every call (Dinv and tRw come batch-last from K6: no
    copy)."""
    O_first = ch._lanes_first(O).contiguous()
    r_first = r[:, :, 0].permute(2, 0, 1).contiguous()
    return dict(
        O=_device_ms(torch, lambda: ch._lanes_last(O_first), None, 20),
        r=_device_ms(torch, lambda: ch._lanes_last(r_first[..., None]), None,
                     20))


def sweep_chain_kernels(torch, ch, dev):
    """K6-K8 at every launch shape of SWEEP on the kernels phase's shapes
    (T = TS, B_LANES lanes, border width 12, 13 for K8) and K7 also at
    border width 14: device ms under torch.profiler (20 runs), ms by CUDA
    events, and whether the outputs have the bits of the shipped shape's."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = _chain_cases(torch, ch, gen, dev)
    out = {}
    for name, grid in SWEEP.items():
        kernel, args = cases[name]["kernel"], cases[name]["inputs"][0]
        ref = _tuple(kernel(*args))
        others = cases[name]["extra"] if name == "chain_rhs_forward" else []
        refs = [_tuple(kernel(*a)) for a in others]
        rows = []
        for G, th in grid:
            run = lambda: kernel(*args, group=G, threads=th)
            got = _tuple(run())
            same = all(bool(torch.equal(g, r)) for g, r in zip(got, ref))
            for a, want in zip(others, refs):
                same &= all(bool(torch.equal(g, r)) for g, r in zip(
                    _tuple(kernel(*a, group=G, threads=th)), want))
            rows.append(dict(
                group=G, threads=th,
                device_ms=_device_ms(torch, run, SYMBOLS[name], 20),
                ms=_time_ms(torch, run, 20), same_bits=same))
        _require(all(r["same_bits"] for r in rows),
                 f"{name}: the bits depend on the launch shape")
        out[name] = rows
    return out


# ---------------------------------------------------------------------------
# phase 3: whole chains through every chain backend
# ---------------------------------------------------------------------------

def check_chains(torch, ck, ch, dev, m=12):
    """B_LANES chains of T = TS blocks with m + 1 rhs columns ([F | r]),
    solved four ways; every one must agree with the dense Cholesky solve,
    and crp_factor + crp_solve must launch K5, K2 and K3 once each.
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

    Xd = dense().reshape(B_LANES, T, NB, m + 1)
    rec = dict(shape=[B_LANES, T * NB, T * NB], rhs=m + 1, launches_by_way={})
    ways = dict(crp_factor_solve=crp_fused, crp_factor_then_solve=crp_split,
                chain_sequential=sequential)
    launches = {}
    for name, fn in ways.items():
        _reset_launch_counts(ck, ch)
        X = fn()
        torch.cuda.synchronize()
        err = ((X - Xd).abs().max() / Xd.abs().max()).item()
        _require(err < TOL_CHAINS, f"{name} vs dense Cholesky: {err:.3e}")
        rec[f"{name}_rel_err"] = err
        way = _launch_counts(ck, ch)
        rec["launches_by_way"][name] = {k: v for k, v in way.items() if v}
        launches = {k: launches.get(k, 0) + v for k, v in way.items()}
    split = rec["launches_by_way"]["crp_factor_then_solve"]
    _require(split == dict(crp_factor_pass=1, crp_fwd_pass=1, crp_bwd_pass=1),
             f"crp_factor + crp_solve: launches {split}, want K5, K2, K3 once")
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


# bench.py's constants per configuration: the mission, dive length n1,
# group cap, budget, the endgame numerics on top of _bench_params, the seed
# of the lane noise, the lanes of bench.py's run; "storm" is config 5
# (wind model 3 on the demo storm grid, order 2, an endgame of 4 Armijo
# trials, bench.py:486-580).
MISSIONS = {
    "S10": dict(mission="S10", aircraft="tempest", n1=90, cap=145,
                budget=250, noise_seed=0,
                endgame=dict(mu_init=6e-5, kappa_inner=2.0, prox=2.5e-3),
                reference="golden_s10_ts100.npy", bench_lanes=1024),
    "G7": dict(mission="G7", aircraft="skywalker", n1=40, cap=360,
               budget=600, noise_seed=1,
               endgame=dict(gamma_min=5e-6, prox=2.5e-3, mu_init=6e-5,
                            kappa_inner=2.0, gamma_shrink=0.12),
               reference="g7_bestknown_ts100.npy", bench_lanes=256),
    "storm": dict(mission="S10", aircraft="tempest", n1=90, cap=175,
                  budget=250, noise_seed=3,
                  endgame=dict(mu_init=6e-5, kappa_inner=2.0, prox=2.5e-3),
                  reference="golden_storm_ts100.npy", bench_lanes=256,
                  wind=3, endgame_ls=4),
}
STORM_DATUM = dict(east0=17400.0, north0=25800.0, up0=200.0)


def make_mission(torch, key, lanes, dev):
    """The canonical problem of one configuration at ts = TS in float32,
    bench.py's parameter sets and ``lanes`` perturbed seeds."""
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.io.storm import make_demo_storm_grid
    from tol_tpu_torch.models.wind import WindConfig
    from tol_tpu_torch.solver.alm import ALMOptions, ALMParams
    from tol_tpu_torch.solver.canonical import canonicalize

    spec = MISSIONS[key]
    wind_model = spec.get("wind", 1)
    wind = None
    if wind_model == 3:
        # the grid's origin and spacing in float32, as bench.py has them
        # with x64 off
        wind = WindConfig(model=3, order=2, interp="auto", **STORM_DATUM,
                          grid=make_demo_storm_grid(dtype=torch.float32,
                                                    device=dev))
    nlp = make_problem(spec["mission"], aircraft=spec["aircraft"], ts=TS,
                       wind_model=wind_model, wind=wind,
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
        mission=spec["mission"], spec=spec, can=can, wind_model=wind_model,
        opts=ALMOptions(max_iter=2000, dual_refine_k=4,
                        max_ls=spec.get("endgame_ls", 8), factor_reuse=1),
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
        aircraft=spec["aircraft"], wind_model=ctx["wind_model"], ts=TS,
        dtype="float32",
        n=can.n, m=can.m, slacks=can.n_slack, lanes=lanes, group=B_LANES,
        drain=B_LANES, dive_chain=dive_chain, endgame_chain="crp",
        endgame_trials=ctx["opts"].max_ls,
        reduced=([f"lanes {spec['bench_lanes']} -> {lanes}"]
                 if lanes < spec["bench_lanes"] else []),
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
    _require(not any(launches[k] for k in CR_FACTOR_ONLY),
             f"{path}: a kernel of crp_factor alone was launched: {launches}")
    return rec, launches, gap


def run_solves(torch, ck, ch, dev):
    """Phase 4.  Returns (launches per path, profile context)."""
    by_path = {}
    s10 = make_mission(torch, "S10", S10_LANES, dev)
    rec, by_path["s10"], gap_crp = run_solve(
        torch, ck, ch, "s10", s10, S10_LANES, "crp", CR_PASS_KERNELS)
    # bench.py's gate: KKT certificate, feasibility and the cost gap.
    _require(rec["gated_pass_with_cost_gap"] >= 0.9 * S10_LANES,
             f"s10 gate: {rec['gated_pass_with_cost_gap']}/{S10_LANES} lanes "
             "pass (< 90%)")

    g7 = make_mission(torch, "G7", B_LANES, dev)
    rec, by_path["g7"], _ = run_solve(
        torch, ck, ch, "g7", g7, B_LANES, "crp", CR_PASS_KERNELS)
    # bench.py's G7 gate has no cost term (its cost has no unique optimal
    # value at working tolerance); the gap against the best-known point is
    # informational.
    _require(rec["converged_and_feasible"] >= 0.9 * B_LANES,
             f"g7 gate: {rec['converged_and_feasible']}/{B_LANES} lanes "
             "converged and feasible (< 90%)")

    # The same first 128 S10 seeds with the sequential chain in the dive.
    rec, by_path["s10_seqdive"], gap_seq = run_solve(
        torch, ck, ch, "s10_seqdive", s10, B_LANES, "pallas",
        CR_PASS_KERNELS + CHAIN_KERNELS)
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


def run_storm(torch, ck, ch, dev):
    """The storm solve, bench.py config 5: S10 / tempest / wind model 3 on
    the demo storm grid (order 2, interp "auto": separable at 384 cells),
    gated as bench.py gates it against ``tests/golden_storm_ts100.npy``.
    Returns (launches, profile context)."""
    storm = make_mission(torch, "storm", STORM_LANES, dev)
    rec, launches, _ = run_solve(torch, ck, ch, "storm", storm, STORM_LANES,
                                 "crp", CR_PASS_KERNELS)
    _require(rec["gated_pass_with_cost_gap"] >= 0.9 * STORM_LANES,
             f"storm gate: {rec['gated_pass_with_cost_gap']}/{STORM_LANES} "
             "lanes pass (< 90%)")
    bodies = [("storm_endgame", storm["opts"], 1, "crp", storm["p2"])]
    return launches, (storm["can"], storm["v0s"][:B_LANES], bodies)


def run_replan(torch, ck, ch, dev):
    """Warm replanning through the mission layer, bench.py config 4: a cold
    G7 / skywalker leg of 128 seed lanes in 48-iteration slices, then
    REPLANS goals drawn as bench.py draws them (``default_rng(7)``), each
    warm-started and stitched to the previous leg's end.  Every leg must
    converge.  Returns the launches of the whole phase."""
    import math

    from tol_tpu_torch.config import Goal, StitchState
    from tol_tpu_torch.mission.mission import MissionConfig, default_leg_solver

    mcfg = MissionConfig(aircraft="skywalker", ts=TS, wind_model=1,
                         leg_max_iter=600, leg_ensemble=B_LANES,
                         leg_chain="crp", leg_chunk=48, device=str(dev),
                         dtype=torch.float32)
    solve_leg = default_leg_solver(mcfg)
    legs = []

    def leg(goal, stitch=None):
        torch.cuda.synchronize()
        t0 = time.time()
        doc = solve_leg("G7", goal, stitch=stitch)
        torch.cuda.synchronize()
        legs.append(dict(ms=1e3 * (time.time() - t0),
                         iterations=doc["iterations"],
                         converged=doc["converged"],
                         used_warm=doc["used_warm"],
                         winner_lane=doc["winner_lane"]))
        tr = doc["trajectory"]
        _require(all(np.isfinite(tr[k]).all() for k in tr),
                 "replan: non-finite trajectory")
        return doc

    _reset_launch_counts(ck, ch)
    doc = leg(Goal(xg=0.0, yg=400.0, zg=0.0, rg=0.0))
    rng = np.random.default_rng(7)
    for _ in range(REPLANS):
        ang = math.pi / 2 + math.radians(rng.uniform(-10, 10))
        rng_d = 400.0 * (1.0 + rng.uniform(-0.1, 0.1))
        tr = doc["trajectory"]
        st = StitchState(*[tr[k][-1] for k in ("Va", "gam", "chi", "phi",
                                               "CL", "dphi", "dCL", "T")])
        doc = leg(Goal(xg=rng_d * math.cos(ang), yg=rng_d * math.sin(ang),
                       zg=0.0, rg=0.0), st)
    launches = _launch_counts(ck, ch)
    warm_ms = [x["ms"] for x in legs[1:]]
    rec = dict(
        phase="replan", mission="G7", aircraft="skywalker", wind_model=1,
        ts=TS, dtype="float32", ensemble=B_LANES, chunk=48, max_iter=600,
        chain="crp", legs=legs, cold_leg_s=legs[0]["ms"] / 1e3,
        replans=REPLANS,
        p50_ms=float(np.percentile(warm_ms, 50)) if warm_ms else None,
        p90_ms=float(np.percentile(warm_ms, 90)) if warm_ms else None,
        converged=sum(x["converged"] for x in legs), legs_run=len(legs),
        reduced=([f"replans 9 -> {REPLANS}"] if REPLANS < 9 else []),
        launches=launches)
    print(json.dumps(rec), flush=True)
    _require(all(x["converged"] for x in legs),
             f"replan: {rec['converged']}/{len(legs)} legs converged")
    _require(all(launches[k] > 0 for k in CR_PASS_KERNELS),
             f"replan: a kernel of the path was never launched: {launches}")
    return launches


def run_cli():
    """The flagship loiter through the CLI in a subprocess, with no
    --device: a 100 m ring centred 100 m south, ts=24.  It must exit 0 and
    write a converged document."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "snopt_results.json")
        cmd = [sys.executable, "-m", "tol_tpu_torch", "0", "0", "0", "0",
               "-100", "0", "100", "tempest", "S10", "--ts", "24",
               "--out", out]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                              timeout=600,
                              env={**os.environ, "PYTHONPATH": HERE})
        wall = time.time() - t0
        _require(proc.returncode == 0,
                 f"cli: exit {proc.returncode}: {proc.stderr[-2000:]}")
        with open(out) as f:
            doc = json.load(f)
    tr = doc["trajectory"]
    radius = np.hypot(np.asarray(tr["x"]) + 100.0, np.asarray(tr["y"]))
    rec = dict(phase="cli", command=" ".join(cmd[1:-2]), seconds=wall,
               converged=doc["converged"], iterations=doc["iterations"],
               kkt_err=doc["kkt_err"], final_cost=doc["FinalCost"],
               dt=doc["dt"], nodes=len(tr["x"]),
               loiter_radius_min=float(radius[1:].min()),
               loiter_radius_max=float(radius[1:].max()),
               status=proc.stdout.strip().splitlines()[-1])
    print(json.dumps(rec), flush=True)
    _require(doc["converged"] and len(tr["x"]) == 25
             and all(np.isfinite(tr[k]).all() for k in tr),
             "cli: the document is not a converged 24-step trajectory")


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

    ours = tuple(SYMBOLS.values())
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
        by_kernel = {k: sum(e.self_device_time_total for e in kernels
                            if SYMBOLS[k] in e.key) / 1e3 for k in per_step}
        measured = busy_ms > 0
        out[name] = dict(
            wall_ms=1e3 * wall, chain=chain, launches_per_step=per_step,
            device_busy_ms=busy_ms if measured else None,
            device_idle_share=(1.0 - busy_ms / (1e3 * wall)) if measured
            else None,
            hand_kernels_ms=ours_ms if measured else None,
            hand_kernels_ms_by_kernel=by_kernel if measured else None,
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
    from tol_tpu_torch.tools import chain_clock

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    try:
        t0 = time.time()
        clock_build = chain_clock.start_build()
        built = _build.build()
        for name in built:
            _build.load_library(name)
        clock_so, _ = chain_clock.load(clock_build)
        ptxas = _ptxas_by_kernel([report for _, report in built.values()])
        print(json.dumps(dict(
            phase="build", seconds=time.time() - t0,
            libraries={name: path for name, (path, _) in built.items()},
            ptxas_by_kernel=ptxas)), flush=True)

        t0 = time.time()
        clock = chain_clock.run(torch, clock_so, ch.K6_GROUP, ch.K6_THREADS,
                                ch.K7_GROUP, ch.K7_THREADS, ch.K8_GROUP,
                                ch.K8_THREADS)
        print(json.dumps(dict(phase="clock", seconds=time.time() - t0,
                              **clock)), flush=True)
        fast = clock["fast_ops_vs_ieee"]
        _require(fast["sqrt_bits_differ"] == 0
                 and fast["quotient_bits_differ"] == 0,
                 f"K6's fast square root or quotient differs from IEEE: {fast}")

        t0 = time.time()
        records = check_kernels(torch, ck, ch, dev, clock["latency_cycles"])
        shipped = {"chain_factor": [ch.K6_GROUP, ch.K6_THREADS],
                   "chain_rhs_forward": [ch.K7_GROUP, ch.K7_THREADS],
                   "chain_back_sub": [ch.K8_GROUP, ch.K8_THREADS]}
        for name, rec in records.items():
            rec["ptxas"] = ptxas.get(f"{name}[G={shipped.get(name, [0])[0]}]",
                                     ptxas.get(name))
        print(json.dumps(dict(phase="kernels", seconds=time.time() - t0,
                              tolerance_rel=TOL_REL)), flush=True)

        t0 = time.time()
        sweep = sweep_chain_kernels(torch, ch, dev)
        print(json.dumps(dict(phase="sweep", seconds=time.time() - t0,
                              shipped=shipped, **sweep)), flush=True)

        t0 = time.time()
        chains, by_path = check_chains(torch, ck, ch, dev)
        by_path = {"chains": by_path}
        print(json.dumps(dict(phase="chains", seconds=time.time() - t0,
                              tolerance_rel=TOL_CHAINS, launches=by_path["chains"],
                              **chains)), flush=True)

        t0 = time.time()
        solve_paths, ctx = run_solves(torch, ck, ch, dev)
        print(json.dumps(dict(phase="solves", seconds=time.time() - t0)),
              flush=True)

        t0 = time.time()
        solve_paths["storm"], storm_ctx = run_storm(torch, ck, ch, dev)
        print(json.dumps(dict(phase="storm_total",
                              seconds=time.time() - t0)), flush=True)

        t0 = time.time()
        solve_paths["replan"] = run_replan(torch, ck, ch, dev)
        print(json.dumps(dict(phase="replan_total",
                              seconds=time.time() - t0)), flush=True)

        run_cli()
        by_path.update(solve_paths)
        # A kernel's launches: those of the solves; K5, which no solve
        # reaches, has those of the chains phase.
        for name, rec in records.items():
            rec["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
            rec["launches"] = (sum(c[name] for c in solve_paths.values())
                               or by_path["chains"][name])
            _require(rec["launches"] > 0, f"{name} was never launched")

        t0 = time.time()
        prof = profile_iterations(torch, ck, ch, *ctx)
        prof.update(profile_iterations(torch, ck, ch, *storm_ctx))
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
