#!/usr/bin/env python3
"""Pass/fail correctness run of the PyTorch/CUDA port (``tol_tpu_torch``)
on one NVIDIA GPU.

    python3 chip_smoke.py

It takes one kind of time only: the device time of each kernel whose
roofline no benchmark metric reads (K5-K9), beside the least bytes and
operations it must move and do.  The port's speed is the benchmark's
(``python3 benchmark/run.py``, ``BENCHMARK.json``; K1-K3's roofline is its
``kernels.crp_roofline``), a cell's step by region and the host's gaps are
``python3 -m tol_tpu_torch.tools.trace_cell``'s, and each change's device
time by kernel is the ``breakdown`` of its lines in ``PERF_LEDGER.jsonl``.

Phases, each of which must pass (any failure exits non-zero and prints no
``ok`` line):

1. build   — compile every kernel source under ``tol_tpu_torch/csrc`` with
             nvcc, one compiler per source, all at once; each kernel's
             ptxas registers and spills.
2. kernels — K6's fast-path square root and quotient (``crk::FastOps``)
             against the IEEE routines on 2^26 operands each: no bit may
             differ.  Then each kernel against its plain PyTorch twin on
             the card at the solves' shapes: the cyclic-reduction
             kernels K1-K3, K5 at 11x11 blocks, B=128 lanes, T=100 blocks
             padded to 128 (CR levels h = 64..1), rhs widths m = 12, 14
             and 1 (each takes the level-0 operands and runs the 7 levels
             and the root step in one launch; K5 is K1 with no rhs);
             the sequential-chain kernels K6-K8 at T=100 blocks, B=128
             lanes, border widths 12 and 14; K9's ``node_blocks`` and
             ``defect_blocks`` at 128 lanes of S10 / tempest / wind model 1
             at ts=100, float32, against the float64 torch.func transforms
             (``TOL_NODE``), and the same under the storm's grid (wind
             model 3 at order 2: K9's grid specialisation, ``[grid]``).  Each case includes a lane with an indefinite
             pivot (for K9, a NaN node) that must come out NaN in that lane
             only.  K5-K9 (``ROOFLINE_KERNELS``) are then timed: one
             launch at the first shape, 20 warm runs under torch.profiler,
             the kernel's own device time against its bound (the least
             bytes at the HBM3 bandwidth or its operations at the fp32
             peak, whichever is longer).
   sweep   — K6-K8 at every lane group size and thread count of SWEEP:
             every shape must give the shipped shape's bits.
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
             (>= 90% of the lanes must pass); K9's grid specialisation
             must take the node blocks and the refinement's.
   replan  — bench.py config 4 through the mission layer: a cold G7 /
             skywalker leg of 128 seed lanes in 48-iteration slices, then
             ``REPLANS`` goals drawn as bench.py draws them, each
             warm-started and stitched; every leg must converge.
   cli     — ``python -m tol_tpu_torch 0 0 0 0 -100 0 100 tempest S10 --ts
             24`` in a subprocess with no ``--device``: must exit 0 and
             write a converged document.
   bench   — ``bench_torch.py`` in a subprocess, configs 1 and 3 at 128
             lanes in 32-lane groups and drain chunks, dive 20, group cap
             30, budget 40 (``BENCH_CUTS``): must exit 0 and print bench.py's
             JSON last with bench.py's keys, finite results, all four
             airframes of the sweep and launches of K1-K3.
   parallel — ``parallel.make_mesh()`` makes a world of one over NCCL;
             ``sharded_batch_solve`` solves S10 / tempest at ts=24, 32
             lanes, chain crp (K1-K3 through the mesh path), and must equal
             the plain ``alm.solve`` of the same lanes bit for bit;
             ``global_psum`` and ``global_stats_to_host`` over NCCL must
             equal the local sum and the local tensor.
   scaling — ``bench_scaling_torch``'s GPU batch curve at 128, 256 and 512
             lanes, 8 fixed iterations each: every rate finite and
             positive, every batch run its 8 iterations, K1-K3 launched.
   entry   — ``graft_entry_torch.entry()`` on the card (the ts=100 S10 KKT
             step over 8 lanes, chain cr) must give finite f, max|c| and v;
             ``dryrun_multichip(1)``: three solver iterations over the mesh.
   utils   — the s10 phase's final v and the parallel phase's v and y
             round-trip ``save_solution`` / ``load_solution`` bit for bit;
             one crp dive step of 128 lanes under ``utils.profiling.trace``,
             whose Chrome trace must name the K1-K3 kernels; that step's
             ``program_flops`` and the card's ``peak_flops()`` must be
             positive.
   graph   — the solver loop as captured programs (``solver/alm.py``'s
             ``_StepProgram``: one masked step, captured once as a CUDA
             graph and replayed).  s10's and the storm's first 128-lane
             group through the grouped solver's dive, phase switch,
             endgame and drain (of the whole group), and the s10_seqdive
             dive, at the depth ``GRAPH_DEPTH`` (dive 8, group cap 16,
             budget 24), each eagerly (``_loop="eager"``) and captured: per
             ALMState field after each stage, equal bits or the largest
             difference; the launches of both runs; per program the hand
             kernels its capture recorded (``_StepProgram.launches``: K1-K3,
             K6-K8 in the sequential dive, K9: each must appear), and
             peak memory.  Then bench config 1 at full size captured
             (``bench_torch``'s solver, draws and gate in this process:
             1024 lanes, groups and drain chunks of 128), gated at
             1008/1024.  Every solve phase above runs captured as well: on
             the card ``alm.solve`` replays its step programs unless told
             otherwise.
   paths   — the JAX package's other solve paths, as captured programs.
             Ten programs (the structured and the dense KKT, the condensed
             KKT's plain chains scan, cr and spike, wind models 2, 4 and 5,
             the storm's onehot and gather lowerings), each through its
             first group's dive, switch, endgame and drain at the depth
             ``PATHS_DEPTH`` eagerly and captured: every ALMState field
             bit-equal, equal launches, and exactly the hand kernels of
             the path launched (K1-K3 for the crp paths, and K9 for those
             under wind model 1 or the storm's grid at order 2); the dense KKT at ts=24 and 8 lanes, the rest at
             ts=100 and 128.  Then full-width solves (128 lanes, ts=100,
             bench.py's constants): cr, onehot and gather gated as s10
             and storm are (>= 90%), scan, spike and the structured KKT
             on converged and feasible lanes (>= 90%; the cost gap
             reported), wind models 2, 4 and 5 with lane 0 at the initial
             point converged within 1e-2 of the JAX package's cost
             (``tests/golden_wind*_ts100.npy``).  A traced crp dive
             (``ALMOptions.trace``, 64 steps) eagerly and captured: the
             six records bit-equal.  ``Mission(MissionConfig()).run`` on
             ``MISSION_GOAL``: the legs' types and converged flags of the
             JAX package's own float32 run (``tests/golden_mission_
             ts100.json``), one capture per mission type.

Every hand kernel must have been launched by some phase.  The last lines
are the card's name and power limit, the ``kernels`` JSON (each kernel's
errors against its twin, tolerance and launches by path; for K5-K9 also
``device_ms``, ``bound_ms``, ``bound_by`` and ``bound_share``) and finally
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

NB = 11                 # node block size
NS_DEFECT = 8           # defect rows of a node (the dynamic states)
TS = 100                # collocation intervals of every solve = chain blocks
B_LANES = 128           # lanes per group / drain chunk
S10_LANES = 256         # lanes of the S10 crp solve: two groups
STORM_LANES = 128       # lanes of the storm solve: one group plus drain
REPLANS = 3             # warm replans after the cold leg (bench.py: 9)
PAR_TS = 24             # the parallel phase's sharded solve: ts, lanes and
PAR_LANES = 32          # iteration budget (dive structure, endgame numerics)
PAR_ITERS = 60
SCALING_BATCHES = (128, 256, 512)   # the scaling phase's batch curve
SCALING_ITERS = 8
UTILS_WARM_STEPS = 2    # dive substeps from the seeds before the traced one
# The bench phase: bench_torch.py's configs 1 and 3 cut to check the path,
# not the gate: variable -> (bench.py's default, the cut)
BENCH_CUTS = dict(BENCH_BATCH=("1024", "128"), BENCH_GROUP=("128", "32"),
                  BENCH_DRAIN=("128", "32"), BENCH_N1=("90", "20"),
                  BENCH_CAP1=("145", "30"), BENCH_MAX_ITER=("250", "40"),
                  BENCH_G7=("1", "0"), BENCH_REPLAN=("1", "0"),
                  BENCH_STORM=("1", "0"))
LEVELS = [64, 32, 16, 8, 4, 2, 1]   # CR level widths h for T=100 -> 128
TOL_REL = 1e-4          # kernel vs twin, relative max-norm, float32
TOL_CHAINS = 1e-3       # chain solves vs the dense yardstick, relative
# Operands of each kind on which K6's fast-path square root and quotient
# must give the IEEE routines' bits
FAST_OPS_OPERANDS = 1 << 26
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and fp32 (non-tensor) peak,
# the bounds of the kernels whose roofline no benchmark metric reads
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
ROOFLINE_REPS = 20      # profiled runs of each such kernel, after one warm-up

CR_SOURCE = "tol_tpu_torch/csrc/crkern.cu"
CHAIN_SOURCE = "tol_tpu_torch/csrc/chainkern.cu"
NODE_SOURCE = "tol_tpu_torch/csrc/nodekern.cu"
NODE_REPLACES = ("none: tol_tpu/solver/kkt_condensed.py:80 and :88 take the "
                 "node blocks by jax.hessian and jax.jacfwd")
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
    "node_blocks": (NODE_SOURCE, NODE_REPLACES),
    "defect_blocks": (NODE_SOURCE, NODE_REPLACES),
}
# the crp kernels of a solve path, and those of crp_factor alone
CR_PASS_KERNELS = ("crp_factor_fwd_pass", "crp_fwd_pass", "crp_bwd_pass")
CR_FACTOR_ONLY = ("crp_factor_pass",)
# kernel -> its __global__ function, as ptxas names it
SYMBOLS = {"crp_factor_fwd_pass": "factor_fwd_pass_kernel",
           "crp_fwd_pass": "fwd_pass_kernel",
           "crp_bwd_pass": "bwd_pass_kernel",
           "crp_factor_pass": "factor_pass_kernel",
           "chain_factor": "chain_factor_kernel",
           "chain_rhs_forward": "chain_rhs_forward_kernel",
           "chain_back_sub": "chain_back_sub_kernel",
           "node_blocks": "node_blocks_kernel",
           "defect_blocks": "defect_blocks_kernel"}
CHAIN_KERNELS = ("chain_factor", "chain_rhs_forward", "chain_back_sub")
# K9: a Newton step's node blocks under wind models 0 and 1 and the
# storm's grid at order 2, and the dual refinement's Jacobian blocks
# (endgame and drain: dual_refine_k > 0)
NODE_KERNELS = ("node_blocks", "defect_blocks")
# the kernels phase's cases of K9's grid specialisation
NODE_GRID_CASES = ("node_blocks[grid]", "defect_blocks[grid]")
# K9 against the float64 transforms at the same float32 points: float32's
# rounding of a few thousand operations a node (about 4e-7 measured)
TOL_NODE = 1e-5
# K9's floating-point operations a node (nk::node_blocks over a counting
# number type on the host; constants included, so an upper count): with the
# Hessian, and A and d alone; under the grid, the stencil sums included
NODE_FLOPS = {"node_blocks": 6398, "defect_blocks": 1621,
              "node_blocks[grid]": 9554, "defect_blocks[grid]": 2611}
# The kernels timed against their bounds: K5, K6-K8 and K9, which run on
# no benchmarked path (K5-K8) or whose bound no benchmark metric reads (K9).
# K1-K3's roofline is the benchmark's kernels.crp_roofline.
ROOFLINE_KERNELS = (("crp_factor_pass",) + CHAIN_KERNELS + NODE_KERNELS
                    + NODE_GRID_CASES)
# Launch shapes of the sweep: (lanes per thread block, threads per block).
SWEEP = {"chain_factor": [(G, th) for G in (1, 2, 4, 8)
                          for th in (64, 128, 256) if th > 16 * G],
         "chain_rhs_forward": [(G, th) for G in (1, 2, 4, 8)
                               for th in (128, 256, 512) if th > 16 * G],
         "chain_back_sub": [(G, th) for G in (1, 2, 4)
                            for th in (64, 128, 256)]}


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
    from tol_tpu_torch.ops import nodekern as nk
    return {_kernel_name(k): k.launches
            for k in ck.KERNELS + ch.KERNELS + nk.KERNELS}


def _reset_launch_counts(ck, ch) -> None:
    from tol_tpu_torch.ops import nodekern as nk
    ck.reset_launch_counts()
    ch.reset_launch_counts()
    nk.reset_launch_counts()


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
            if cur and "4GridI" in ln:    # K9's grid specialisation
                cur = f"{cur}[grid]"
            if cur and not group and "IdE" in ln:   # K9 in double
                cur = f"{cur}[f64]"
            if cur:
                out[cur] = {}
        elif cur and "spill stores" in ln and "spill_stores" not in out[cur]:
            # the entry's own properties come first; a helper's (the
            # double trig reduction's) follow
            words = ln.split()
            out[cur]["spill_stores"] = int(words[words.index("spill") - 2])
            out[cur]["spill_loads"] = int(words[-4])
        elif cur and "registers" in ln:
            words = ln.split()
            out[cur]["registers"] = int(words[words.index("registers,") - 1])
    return out


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
    """K1-K3, K5.  Per kernel: the inputs of one CR pass over the 7 levels,
    the inputs of the kernel's other solve shapes (``extra``), the kernel
    call and the twin call."""
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
    # K1: the 7-level factor pass with the border columns, 12 of them on
    # S10 and 14 on G7, then the root's inverse and solution.
    cases["crp_factor_fwd_pass"] = dict(
        inputs=[pass_inputs(12)], extra=[pass_inputs(14)],
        kernel=ck.crp_factor_fwd_pass, plain=factor_fwd_pass_plain,
        flat=lambda out: _flat_pass(*out), poison=_poison_pass_pivot,
        nan_must=(-2, -1))
    # K2: the 7-level forward elimination of one new rhs column (m = 1) or
    # of 12, then the root solution.
    cases["crp_fwd_pass"] = dict(
        inputs=[fwd_inputs(1)], extra=[fwd_inputs(12)],
        kernel=ck.crp_fwd_pass,
        plain=lambda lv, ri, f: ck.fwd_pass_plain(lv, ri, ck._to_slab(f),
                                                  B_LANES),
        flat=lambda out: _flat_pass([], *out), poison=_poison_fwd_nan,
        nan_must=(-1,))
    # K3: the 7-level back-substitution of one rhs column (m = 1), and of
    # the 12 or 14 border columns in the factor + solve.
    cases["crp_bwd_pass"] = dict(
        inputs=[bwd_inputs(1)], extra=[bwd_inputs(12), bwd_inputs(14)],
        kernel=ck.crp_bwd_pass,
        plain=lambda lv, st, x: ck._from_slab(
            ck.bwd_pass_plain(lv, st, x, B_LANES), B_LANES),
        poison=_poison_pass_nan, nan_must=(0,))
    # K5: crp_factor's pass, K1 with no rhs: the 7 levels' factor, then
    # the root's inverse.
    cases["crp_factor_pass"] = dict(
        inputs=[pass_inputs(1)[:2]], kernel=ck.crp_factor_pass,
        plain=lambda M, O: ck.factor_pass_plain(ck._to_slab(M), ck._to_slab(O),
                                                B_LANES),
        flat=lambda out: _flat_pass(out[0], [], out[1]),
        poison=_poison_pass_pivot, nan_must=(-1,))
    return cases


def _chain_cases(torch, ch, gen, dev):
    """K6-K8 at T = TS blocks and B_LANES lanes, batch-last as the kernels
    take them: border width 12 (S10) and 14 (G7; ``extra``).  K7 and K8 get
    the factors K6's twin made of the same chains."""
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
    return {
        "chain_factor": dict(
            inputs=[a["factor"]], extra=[b["factor"]],
            kernel=ch._factor_eliminate_batched,
            plain=ch.factor_eliminate_plain, poison=_poison_chain_pivot),
        "chain_rhs_forward": dict(
            inputs=[a["rhs"]], extra=[b["rhs"]],
            kernel=ch._rhs_forward_batched, plain=ch.rhs_forward_plain,
            poison=_poison_chain_nan),
        "chain_back_sub": dict(
            inputs=[a["back"]], extra=[b["back"]],
            kernel=ch._back_substitute_batched,
            plain=ch.back_substitute_plain, poison=_poison_chain_nan),
    }


def _node_cases(torch, gen, dev):
    """K9's two entry points at the solves' shape: S10 / tempest, wind model
    1, scaled, B=128 lanes of T=100 (12928 nodes; A and d of the 12800 with
    a defect), float32, at points moved off the seed trajectory, against
    the torch.func transforms in float64 at the same points; ``[grid]`` the
    same under the storm's wind (model 3 on the demo storm grid at order 2:
    K9's grid specialisation).  The solver adds the node cost's Hessian
    beside the launch, so ``plain`` takes it out of the transforms' Hn.
    The NaN lane: one node of lane ``col`` is NaN."""
    cases = _node_wind_cases(torch, gen, dev, 1)
    cases.update({f"{k}[grid]": c for k, c in _node_wind_cases(
        torch, gen, dev, 3).items()})
    return cases


def _node_wind_cases(torch, gen, dev, model):
    """_node_cases' two cases under wind model 1 or 3."""
    import dataclasses

    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.io.storm import make_demo_storm_grid
    from tol_tpu_torch.models.wind import WindConfig
    from tol_tpu_torch.ops import nodekern
    from tol_tpu_torch.solver.canonical import (Scaling, canonicalize,
                                                kernel_args)
    from tol_tpu_torch.solver.kkt_condensed import derivative_blocks

    def mk(dtype):
        wind = None if model == 1 else WindConfig(
            model=3, order=2, interp="separable", east0=17400.0,
            north0=25800.0, up0=200.0,
            grid=make_demo_storm_grid(dtype=dtype, device=dev))
        return make_problem("S10", aircraft="tempest", ts=TS,
                            wind_model=model, wind=wind, dtype=dtype,
                            device=dev)
    c32 = canonicalize(mk(torch.float32), scaling="auto")
    c64 = canonicalize(mk(torch.float64),
                       Scaling(*[t.double() for t in c32.scaling]))
    # the float64 problem by the transforms
    c64 = dataclasses.replace(c64, nlp=dataclasses.replace(
        c64.nlp, affine_wind_model=None, grid_wind=False))
    nlp64, inst64 = c64.nlp, c64.nlp.inst0
    blocks64, _, jac64, _ = derivative_blocks(c64)
    par, fld = kernel_args(c32)(c32.nlp.inst0)
    lb, ub, fixed = c32.bounds(c32.nlp.inst0)
    v = c32.initial_point()[None] + 0.1 * torch.randn(
        B_LANES, c32.n, generator=gen, device=dev)
    v = torch.where(fixed, lb, torch.minimum(torch.maximum(v, lb), ub))
    Z, dt, _ = c32.split(v)
    Z, dt = Z.contiguous(), dt.contiguous()
    y = torch.randn(B_LANES, TS, NS_DEFECT, generator=gen, device=dev)
    # the wind's index tables made outside the transforms
    nlp64.all_defects(Z.double(), dt.double())

    def node(Z, dt, y):
        Hn, A, d = nodekern.node_blocks(Z, dt, y, par, fld)
        return Hn, A[:, :TS], d[:, :TS]

    def node_plain(Z, dt, y):
        Zw, dtw = Z.double(), dt.double()
        Hn, A, d = blocks64(Zw, dtw, y.double(), inst64)
        Hn[..., :NB, :NB] -= nlp64.node_cost_hess(Zw, dtw[:, None], inst64)
        return Hn, A, d

    def poison(torch, args, col):
        args[0][col, 1] = float("nan")

    return {
        "node_blocks": dict(
            kernel=node, plain=node_plain, inputs=[(Z, dt, y)],
            poison=poison, nan_must=(0, 1, 2), tol=TOL_NODE),
        "defect_blocks": dict(
            kernel=lambda Z, dt: nodekern.defect_blocks(Z, dt, par, fld),
            plain=lambda Z, dt: jac64(Z.double(), dt.double(), inst64),
            inputs=[(Z, dt)], poison=poison, nan_must=(0, 1), tol=TOL_NODE),
    }


def _bounds() -> dict:
    """{kernel: (bytes, flops)} of one launch of each ROOFLINE_KERNELS
    kernel at its case's first shape, float32: the least bytes it must move
    (every operand read once, every output written once) and its
    operations."""
    from tol_tpu_torch.ops import nodekern

    fl = 4
    n3, n2 = NB ** 3, NB ** 2
    tri = NB * (NB + 1) // 2    # the pivot inverse reads only the lower triangle
    n_pad, blocks = 2 * LEVELS[0], sum(LEVELS)
    T, nB = TS, 12
    nC = nB + 1                 # K8 takes [tRw | tr]
    nodes = B_LANES * (TS + 1)
    out_h = (NB + 1) ** 2 + NS_DEFECT * NB + NS_DEFECT
    out_j = NS_DEFECT * NB + NS_DEFECT
    node_bytes = fl * (nodes * (NB + out_h) + B_LANES
                       + B_LANES * TS * NS_DEFECT + nodekern.PAR_FLOATS)
    defect_bytes = fl * (B_LANES * TS * (NB + out_j) + B_LANES
                         + nodekern.PAR_FLOATS)
    # the grid: the demo storm grid's three components (8 x 8 x 6), origin,
    # spacing and live mask, each read once
    grid_bytes = fl * (3 * 8 * 8 * 6 + 9)
    return {
        # K5: level 0 read once (each odd pivot's lower triangle, even
        # blocks whole, O), every level's Minv, OL, OR and the root's
        # inverse written once
        "crp_factor_pass": (
            B_LANES * fl * (n_pad // 2 * (tri + n2) + n_pad * n2
                            + blocks * 3 * n2 + n2),
            blocks * B_LANES * (2 * n3 // 6 + 12 * n3)
            + B_LANES * (2 * n3 // 6 + 2 * n3)),
        # K6-K8 at border width 12
        "chain_factor": (
            B_LANES * fl * (T * ((tri + n2 + NB * nB) + (2 * n2 + NB * nB))
                            + nB * nB),
            B_LANES * T * (2 * n3 // 6 + 2 * n3 + 4 * n2 * (NB + nB)
                           + 2 * NB * nB * nB + n2 + NB * nB + nB * nB)),
        "chain_rhs_forward": (
            B_LANES * fl * (T * (2 * n2 + NB * nB + NB + NB) + nB),
            B_LANES * T * (4 * n2 + 2 * NB * nB + NB + nB)),
        "chain_back_sub": (
            B_LANES * fl * (T * (NB * nC + n2 + NB) + nC),
            B_LANES * T * (2 * NB * nC + 2 * n2 + NB)),
        # K9: z and the outputs of every node, the lanes' dt, the
        # multipliers of the T defects, the 17 airframe and scale numbers
        "node_blocks": (node_bytes, nodes * NODE_FLOPS["node_blocks"]),
        "defect_blocks": (defect_bytes,
                          B_LANES * TS * NODE_FLOPS["defect_blocks"]),
        "node_blocks[grid]": (node_bytes + grid_bytes,
                              nodes * NODE_FLOPS["node_blocks[grid]"]),
        "defect_blocks[grid]": (
            defect_bytes + grid_bytes,
            B_LANES * TS * NODE_FLOPS["defect_blocks[grid]"]),
    }


def _device_ms(torch, fn, symbol, tries=3):
    """Mean device time of the kernel ``symbol`` per ``fn()`` over
    ROOFLINE_REPS warm runs under torch.profiler (None if the profiler saw
    none in ``tries`` profiles: now and then a profile misses a kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ROOFLINE_REPS):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and symbol in e.key)
        if us > 0:
            return us / 1e3 / ROOFLINE_REPS
    return None


def _roofline(torch, case, name, counts) -> dict:
    """One kernel's device time against its bound."""
    n_bytes, flops = counts
    device_ms = _device_ms(torch, lambda: case["kernel"](*case["inputs"][0]),
                           SYMBOLS[name.split("[")[0]])
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    return dict(device_ms=device_ms, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_share=bound_ms / device_ms if device_ms else None,
                bytes=n_bytes, flops=flops)


def check_fast_ops(torch, dev) -> dict:
    """K6's fast-path square root and quotient (``crk::FastOps``) against
    the IEEE routines on FAST_OPS_OPERANDS operands each
    (``fast_ops_check`` in ``csrc/chainkern.cu``): no bit may differ."""
    from tol_tpu_torch.ops import _build

    lib = _build.load_library("chainkern")
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    code = lib.fast_ops_check(FAST_OPS_OPERANDS, counts.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "fast_ops_check")
    c = counts.tolist()
    fast = dict(sqrt_tested=c[1], sqrt_bits_differ=c[0],
                quotient_tested=c[3], quotient_bits_differ=c[2])
    _require(fast["sqrt_bits_differ"] == 0
             and fast["quotient_bits_differ"] == 0,
             f"K6's fast square root or quotient differs from IEEE: {fast}")
    return fast


def check_kernels(torch, ck, ch, dev):
    """Phase 2.  Returns the per-kernel records of the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = _cr_cases(torch, ck, gen, dev)
    cases.update(_chain_cases(torch, ch, gen, dev))
    cases.update(_node_cases(torch, gen, dev))
    bounds = _bounds()
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
        tol = case.get("tol", TOL_REL)
        _require(rel_err <= tol,
                 f"{name}: kernel vs twin relative error {rel_err:.3e} > {tol}")
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
        source, replaces = KERNELS[name.split("[")[0]]
        records[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=abs_err, max_rel_err=rel_err,
            tolerance_rel=tol)
        if name in ROOFLINE_KERNELS:
            records[name].update(_roofline(torch, case, name, bounds[name]))
    return records


def sweep_chain_kernels(torch, ch, dev):
    """K6-K8 at every launch shape of SWEEP on the kernels phase's shapes
    (T = TS, B_LANES lanes, border width 12, 13 for K8) and K7 also at
    border width 14: whether the outputs have the bits of the shipped
    shape's."""
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
            got = _tuple(kernel(*args, group=G, threads=th))
            same = all(bool(torch.equal(g, r)) for g, r in zip(got, ref))
            for a, want in zip(others, refs):
                same &= all(bool(torch.equal(g, r)) for g, r in zip(
                    _tuple(kernel(*a, group=G, threads=th)), want))
            rows.append(dict(group=G, threads=th, same_bits=same))
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
    # every kernel of a chain solve (K9 takes no part in one)
    _require(all(v > 0 for k, v in launches.items() if k not in NODE_KERNELS),
             f"a kernel was never launched by the chain solves: {launches}")
    return rec, launches


# ---------------------------------------------------------------------------
# phase 4: the solves
# ---------------------------------------------------------------------------

# bench.py's constants per configuration: the mission, dive length n1,
# group cap, budget, the endgame numerics on top of bench.py's _params, the
# seed of the lane noise, the lanes of bench.py's run; "storm" is config 5
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
# the paths phase's problems: S10 under wind models 2, 4 and 5 (each
# against the JAX package's lane from the initial point,
# tests/make_wind_goldens.py; lane 0 starts there), the storm on its
# onehot and gather lowerings, and S10 at ts=24 for the dense KKT
for _k in (2, 4, 5):
    MISSIONS[f"wind{_k}"] = dict(MISSIONS["S10"], wind=_k, clean_lane0=True,
                                 reference=f"golden_wind{_k}_ts100.npy")
for _interp in ("onehot", "gather"):
    MISSIONS[f"storm_{_interp}"] = dict(MISSIONS["storm"], interp=_interp)
MISSIONS["S10_ts24"] = dict(MISSIONS["S10"], ts=24, reference=None)
STORM_DATUM = dict(east0=17400.0, north0=25800.0, up0=200.0)


def make_mission(torch, key, lanes, dev):
    """The canonical problem of one configuration at ts = TS in float32,
    bench.py's parameter sets and ``lanes`` perturbed seeds."""
    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.io.storm import make_demo_storm_grid
    from tol_tpu_torch.models.wind import WindConfig
    from bench_torch import _params
    from tol_tpu_torch.solver.alm import ALMOptions
    from tol_tpu_torch.solver.canonical import canonicalize

    spec = MISSIONS[key]
    wind_model = spec.get("wind", 1)
    wind = None
    if wind_model == 3:
        # the grid's origin and spacing in float32, as bench.py has them
        # with x64 off
        wind = WindConfig(model=3, order=2, interp=spec.get("interp", "auto"),
                          **STORM_DATUM,
                          grid=make_demo_storm_grid(dtype=torch.float32,
                                                    device=dev))
    nlp = make_problem(spec["mission"], aircraft=spec["aircraft"],
                       ts=spec.get("ts", TS), wind_model=wind_model, wind=wind,
                       dtype=torch.float32, device=dev)
    can = canonicalize(nlp, scaling="auto")
    end = dict(tol=5e-3, feas_tol=1e-4, **spec["endgame"])
    inst0 = can.nlp.inst0
    v0 = can.initial_point()
    lb, ub, fixed = can.bounds(inst0)
    gen = torch.Generator(device="cpu").manual_seed(spec["noise_seed"])
    dv = 0.01 * torch.randn(lanes, can.n, generator=gen).to(dev)
    if spec.get("clean_lane0"):
        dv[0] = 0.0
    f_ref = None
    if spec["reference"] is not None:
        ref = torch.tensor(np.load(os.path.join(HERE, "tests",
                                                spec["reference"])),
                           dtype=torch.float32, device=dev)
        f_ref = float(can.f(can.from_physical(ref), inst0))
    return dict(
        mission=spec["mission"], spec=spec, can=can, wind_model=wind_model,
        opts=ALMOptions(max_iter=2000, dual_refine_k=4,
                        max_ls=spec.get("endgame_ls", 8), factor_reuse=1),
        dive_opts=ALMOptions(max_iter=2000, dual_refine_k=0, max_ls=4,
                             factor_reuse=1),
        p2=_params(torch.float32, dev, max_iter=spec["cap"], **end),
        p2d=_params(torch.float32, dev, max_iter=spec["budget"], **end),
        p1=_params(torch.float32, dev, tol=1e-12, feas_tol=1e-12,
                   prox=0.0, gamma_eager=0.0, max_iter=spec["budget"]),
        v0s=torch.where(fixed, lb,
                        torch.minimum(torch.maximum(v0 + dv, lb), ub)),
        f_ref=f_ref)


def make_kkts(can, dive_chain, end_chain="crp"):
    """(endgame KKT, dive KKT): the condensed KKT on a chain (refine=1 in
    the endgame, 0 in the dive, as bench.py has them), or the
    "structured" or "dense" KKT."""
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt
    from tol_tpu_torch.solver.kkt_dense import make_dense_kkt
    from tol_tpu_torch.solver.kkt_structured import make_structured_kkt

    def kkt(chain, refine):
        if chain == "structured":
            return make_structured_kkt(can)
        if chain == "dense":
            return make_dense_kkt(can)
        return make_condensed_kkt(can, refine=refine, chain=chain)
    return kkt(end_chain, 1), kkt(dive_chain, 0)


def run_solve(torch, ck, ch, path, ctx, lanes, dive_chain, expect,
              end_chain="crp", phase="solve", extra=None):
    """Drive one path through the grouped solver with the launch counts at 0
    just before and read just after.  Returns (record, launches, gap); every
    kernel named in ``expect`` must have been launched."""
    from tol_tpu_torch.solver.batch import make_grouped_solver

    can, spec = ctx["can"], ctx["spec"]
    kkt_end, kkt_dive = make_kkts(can, dive_chain, end_chain)
    gsolve = make_grouped_solver(
        can, kkt_end, ctx["opts"],
        group_size=B_LANES, drain_size=B_LANES, dive_opts=ctx["dive_opts"],
        dive_kkt=kkt_dive)
    _reset_launch_counts(ck, ch)
    torch.cuda.reset_peak_memory_stats()
    res = gsolve([can.nlp.inst0] * (lanes // B_LANES), None,
                 ctx["v0s"][:lanes], ctx["p1"], ctx["p2"], ctx["p2d"],
                 spec["n1"], -1.0)
    torch.cuda.synchronize()
    launches = _launch_counts(ck, ch)
    ctx.setdefault("results", {})[path] = res

    _require(np.isfinite(res.v).all(), f"{path}: non-finite final v")
    _require(res.v.shape == (lanes, can.n),
             f"{path}: bad result shape {res.v.shape}")
    gap = (res.f - ctx["f_ref"]) / max(abs(ctx["f_ref"]), 1e-9)
    feasible = res.constr_viol < 1e-4
    rec = dict(
        phase=phase, path=path, mission=ctx["mission"],
        aircraft=spec["aircraft"], wind_model=ctx["wind_model"], ts=TS,
        dtype="float32",
        n=can.n, m=can.m, slacks=can.n_slack, lanes=lanes, group=B_LANES,
        drain=B_LANES, dive_chain=dive_chain, endgame_chain=end_chain,
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
        launches=launches, captures=gsolve.programs.captures,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        **(extra or {}))
    print(json.dumps(rec), flush=True)
    _require(all(launches[k] > 0 for k in expect),
             f"{path}: a kernel of the path was never launched: {launches}")
    _require(not any(launches[k] for k in CR_FACTOR_ONLY),
             f"{path}: a kernel of crp_factor alone was launched: {launches}")
    return rec, launches, gap


def run_solves(torch, ck, ch, dev):
    """Phase 4.  Returns (launches per path, the utils phase's dive: the s10
    problem, its first group's seeds and the dive's body, the s10 solve's
    final v)."""
    by_path = {}
    s10 = make_mission(torch, "S10", S10_LANES, dev)
    rec, by_path["s10"], gap_crp = run_solve(
        torch, ck, ch, "s10", s10, S10_LANES, "crp",
        CR_PASS_KERNELS + NODE_KERNELS)
    # bench.py's gate: KKT certificate, feasibility and the cost gap.
    _require(rec["gated_pass_with_cost_gap"] >= 0.9 * S10_LANES,
             f"s10 gate: {rec['gated_pass_with_cost_gap']}/{S10_LANES} lanes "
             "pass (< 90%)")

    g7 = make_mission(torch, "G7", B_LANES, dev)
    rec, by_path["g7"], _ = run_solve(
        torch, ck, ch, "g7", g7, B_LANES, "crp",
        CR_PASS_KERNELS + NODE_KERNELS)
    # bench.py's G7 gate has no cost term (its cost has no unique optimal
    # value at working tolerance); the gap against the best-known point is
    # informational.
    _require(rec["converged_and_feasible"] >= 0.9 * B_LANES,
             f"g7 gate: {rec['converged_and_feasible']}/{B_LANES} lanes "
             "converged and feasible (< 90%)")

    # The same first 128 S10 seeds with the sequential chain in the dive.
    rec, by_path["s10_seqdive"], gap_seq = run_solve(
        torch, ck, ch, "s10_seqdive", s10, B_LANES, "pallas",
        CR_PASS_KERNELS + CHAIN_KERNELS + NODE_KERNELS)
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
    dive = ("dive", s10["dive_opts"], 0, "crp", s10["p1"])
    return (by_path, (s10["can"], s10["v0s"][:B_LANES], dive),
            s10["results"]["s10"].v)


def run_storm(torch, ck, ch, dev):
    """The storm solve, bench.py config 5: S10 / tempest / wind model 3 on
    the demo storm grid (order 2, interp "auto": separable at 384 cells),
    gated as bench.py gates it against ``tests/golden_storm_ts100.npy``.
    Returns the launches."""
    storm = make_mission(torch, "storm", STORM_LANES, dev)
    rec, launches, _ = run_solve(torch, ck, ch, "storm", storm, STORM_LANES,
                                 "crp", CR_PASS_KERNELS)
    # K9's grid specialisation takes the node blocks and the refinement's
    _require(all(launches[k] for k in NODE_KERNELS),
             f"storm: K9 not launched under the storm grid: {launches}")
    _require(rec["gated_pass_with_cost_gap"] >= 0.9 * STORM_LANES,
             f"storm gate: {rec['gated_pass_with_cost_gap']}/{STORM_LANES} "
             "lanes pass (< 90%)")
    return launches


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
        doc = solve_leg("G7", goal, stitch=stitch)
        legs.append(dict(iterations=doc["iterations"],
                         converged=doc["converged"],
                         used_warm=doc["used_warm"],
                         winner_lane=doc["winner_lane"]))
        tr = doc["trajectory"]
        _require(all(np.isfinite(tr[k]).all() for k in tr),
                 "replan: non-finite trajectory")
        return doc

    _reset_launch_counts(ck, ch)
    torch.cuda.reset_peak_memory_stats()
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
    rec = dict(
        phase="replan", mission="G7", aircraft="skywalker", wind_model=1,
        ts=TS, dtype="float32", ensemble=B_LANES, chunk=48, max_iter=600,
        chain="crp", legs=legs, replans=REPLANS,
        converged=sum(x["converged"] for x in legs), legs_run=len(legs),
        reduced=([f"replans 9 -> {REPLANS}"] if REPLANS < 9 else []),
        launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
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
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                              timeout=600,
                              env={**os.environ, "PYTHONPATH": HERE})
        _require(proc.returncode == 0,
                 f"cli: exit {proc.returncode}: {proc.stderr[-2000:]}")
        with open(out) as f:
            doc = json.load(f)
    tr = doc["trajectory"]
    radius = np.hypot(np.asarray(tr["x"]) + 100.0, np.asarray(tr["y"]))
    rec = dict(phase="cli", command=" ".join(cmd[1:-2]),
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


def _bench_py_keys():
    """The keys of bench.py's result line and of its ``detail``, read from
    bench.py's source (``result = {...}``)."""
    import ast

    with open(os.path.join(HERE, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result"
                        for t in node.targets)):
            top = {k.value: v for k, v in zip(node.value.keys,
                                              node.value.values)}
            return set(top), {k.value for k in top["detail"].keys}
    raise SmokeFailure("bench: no result dict in bench.py")


def run_bench():
    """``bench_torch.py`` in a subprocess at the cuts of BENCH_CUTS: configs 1
    and 3 (the four-airframe sweep).  It must exit 0 and print bench.py's
    JSON last, with bench.py's keys, finite results and all four airframes.
    Returns the hand-written kernels' launches of its run."""
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=HERE,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": HERE,
                               **{k: v for k, (_, v) in BENCH_CUTS.items()}})
    _require(proc.returncode == 0,
             f"bench: exit {proc.returncode}: {proc.stderr[-2000:]}")
    try:
        res = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError) as e:
        raise SmokeFailure(f"bench: the last line is not JSON: {e}")
    top, detail = _bench_py_keys()
    d = res.get("detail", {})
    launches = d.get("launches", {})
    rec = dict(phase="bench",
               reduced=[f"{k} {a} -> {b}" for k, (a, b) in BENCH_CUTS.items()],
               result=res)
    print(json.dumps(rec), flush=True)
    _require(set(res) == top and detail <= set(d),
             f"bench: keys differ from bench.py's: {sorted(set(res) ^ top)}, "
             f"{sorted(detail - set(d))}")
    finite = [d[k] for k in ("wall_s", "median_viol", "median_kkt",
                             "flops_per_iter", "achieved_gflops", "mfu_pct")]
    sweep = d["multi_airframe"] or {}
    _require(all(isinstance(x, (int, float)) and np.isfinite(x)
                 for x in finite + [res["value"]])
             and d["platform"] == "gpu" and d["batch"] == 128,
             f"bench: non-finite or missing results: {finite}")
    _require(sorted(sweep.get("per_airframe_conv", {})) == sorted(
        ["tempest", "tempest_eric", "tempest_wences", "tempest_will"]),
             f"bench: the sweep did not run all four airframes: {sweep}")
    _require(all(launches.get(k, 0) > 0 for k in CR_PASS_KERNELS),
             f"bench: a kernel of the path was never launched: {launches}")
    return {k: launches.get(k, 0) for k in KERNELS}


# ---------------------------------------------------------------------------
# phase 4b: the parallel layer, the scaling curve, the entry points, utils
# ---------------------------------------------------------------------------

def run_parallel(torch, ck, ch, dev):
    """The sharded solve through a NCCL world of one, held bit for bit
    against the plain solve of the same lanes.  Returns (launches of the
    sharded solve, its result)."""
    import torch.distributed as dist

    from tol_tpu_torch.api import make_problem
    from tol_tpu_torch.parallel import (global_psum, global_stats_to_host,
                                        make_mesh, sharded_batch_solve)
    from bench_torch import _params
    from tol_tpu_torch.solver.alm import ALMOptions
    from tol_tpu_torch.solver.alm import solve as alm_solve
    from tol_tpu_torch.solver.canonical import canonicalize
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

    mesh = make_mesh()
    _require(dist.get_backend() == "nccl" and dist.get_world_size() == 1
             and mesh.shape == (1, 1) and mesh.device_type == "cuda",
             f"parallel: not a NCCL world of one: {mesh}")
    can = canonicalize(make_problem("S10", "tempest", ts=PAR_TS,
                                    dtype=torch.float32, device=dev),
                       scaling="auto")
    lb, ub, fixed = can.bounds(can.nlp.inst0)
    gen = torch.Generator(device="cpu").manual_seed(4)
    dv = 0.01 * torch.randn(PAR_LANES, can.n, generator=gen).to(dev)
    v0s = torch.where(fixed, lb, torch.minimum(torch.maximum(
        can.initial_point() + dv, lb), ub))
    kkt = make_condensed_kkt(can, refine=0, chain="crp")
    opts = ALMOptions(max_iter=2000, dual_refine_k=0, max_ls=4)
    p = _params(torch.float32, dev, max_iter=PAR_ITERS, tol=5e-3,
                feas_tol=1e-4, **MISSIONS["S10"]["endgame"])

    def solve_batch(_, v):
        return alm_solve(can, kkt, opts, v0=v, params=p)

    _reset_launch_counts(ck, ch)
    res = sharded_batch_solve(mesh, solve_batch, None, v0s)
    torch.cuda.synchronize()
    launches = _launch_counts(ck, ch)
    plain = alm_solve(can, kkt, opts, v0=v0s, params=p)
    same = {k: bool(torch.equal(getattr(res, k), getattr(plain, k)))
            for k in ("v", "y", "zl", "zu", "f", "iterations", "converged",
                      "kkt_err", "constr_viol")}
    total = global_psum(mesh, res.constr_viol)
    host_v = global_stats_to_host(res.v)
    rec = dict(
        phase="parallel", mission="S10", aircraft="tempest", wind_model=1,
        ts=PAR_TS, dtype="float32", lanes=PAR_LANES, chain="crp",
        backend=dist.get_backend(), world_size=dist.get_world_size(),
        mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
        max_iter=PAR_ITERS, converged=int(res.converged.sum()),
        median_iters=float(res.iterations.float().median()),
        bits_equal_plain_solve=same,
        psum=float(total), local_sum=float(res.constr_viol.sum()),
        stats_to_host_equal=bool(np.array_equal(host_v,
                                                res.v.cpu().numpy())),
        launches=launches,
        note="NCCL over more than one rank is not run: one card")
    print(json.dumps(rec), flush=True)
    _require(all(same.values()),
             f"parallel: the sharded solve differs from the plain one: {same}")
    _require(float(total) == float(res.constr_viol.sum())
             and rec["stats_to_host_equal"],
             "parallel: the NCCL reductions differ from the local ones")
    _require(np.isfinite(host_v).all(), "parallel: non-finite v")
    _require(all(launches[k] > 0 for k in CR_PASS_KERNELS),
             f"parallel: a kernel of the path was never launched: {launches}")
    return launches, res


def run_scaling(torch, ck, ch):
    """bench_scaling_torch's single-card batch curve (GPU mode) in this
    process, so the wrappers' counts see its launches."""
    import bench_scaling_torch

    _reset_launch_counts(ck, ch)
    out = bench_scaling_torch.main_gpu_batch_curve(SCALING_BATCHES,
                                                   SCALING_ITERS)
    launches = _launch_counts(ck, ch)
    rates = out["detail"]["instance_iters_per_s"]
    print(json.dumps(dict(phase="scaling", launches=launches, **out)),
          flush=True)
    _require(all(r > 0 and np.isfinite(r) for r in rates.values())
             and all(n == SCALING_ITERS
                     for n in out["detail"]["iterations_run"].values()),
             f"scaling: bad curve {out}")
    _require(all(launches[k] > 0 for k in CR_PASS_KERNELS),
             f"scaling: a kernel of the path was never launched: {launches}")
    return launches


def run_entry(torch):
    """graft_entry_torch on the card: entry()'s step, then the dry run over
    the mesh of the parallel phase's world."""
    import graft_entry_torch

    fn, args = graft_entry_torch.entry()
    f, max_c, v = fn(*args)
    graft_entry_torch.dryrun_multichip(1)
    finite = {k: bool(torch.isfinite(x).all())
              for k, x in (("f", f), ("max_c", max_c), ("v", v))}
    print(json.dumps(dict(
        phase="entry", lanes=int(v.shape[0]), n=int(v.shape[1]),
        dtype=str(v.dtype), device=str(v.device), f=f.tolist(),
        max_c=max_c.tolist(), finite=finite)), flush=True)
    _require(all(finite.values()) and v.device.type == "cuda"
             and v.shape == (8, 1112),
             f"entry: the step is not finite on the card: {finite}")


def run_utils(torch, s10_v, par, ctx):
    """The utilities on the card: checkpoint round trip, one crp dive step
    traced, whose trace must name K1-K3, and that step's flops and the
    card's peak."""
    import tempfile

    from tol_tpu_torch.solver.alm import make_kernel
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt
    from tol_tpu_torch.utils import load_solution, save_solution, trace
    from tol_tpu_torch.utils.flops import peak_flops, program_flops

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s10.npz")
        save_solution(path, s10_v, par.y, meta={"v_parallel": par.v})
        v, y, meta = load_solution(path)
        bits = dict(
            s10_v=v.dtype == s10_v.dtype and v.tobytes() == s10_v.tobytes(),
            parallel_y=y.tobytes() == par.y.cpu().numpy().tobytes(),
            parallel_v=meta["v_parallel"].tobytes()
            == par.v.cpu().numpy().tobytes())

        can, v0s, body = ctx
        name, opts, refine, chain, p = body
        _require(name == "dive" and chain == "crp", f"utils: body {name}")
        kern = make_kernel(can, make_condensed_kkt(can, refine=refine,
                                                   chain=chain),
                           opts, can.nlp.inst0, v0s)
        st = kern.init_state(p, p, False)
        for _ in range(UTILS_WARM_STEPS):
            st, _ = kern.substep(st, None, p, p, None)
        with trace(os.path.join(tmp, "trace")) as prof:
            kern.substep(st, None, p, p, None)
            torch.cuda.synchronize()
        with open(prof.trace_path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    named = {k: any(SYMBOLS[k] in n for n in names) for k in CR_PASS_KERNELS}
    flops = program_flops(lambda: kern.substep(st, None, p, p, None))
    peak = peak_flops()
    rec = dict(
        phase="utils", checkpoint_bits_equal=bits,
        step=dict(body="dive", chain="crp", lanes=int(v0s.shape[0]), ts=TS),
        trace_names_kernels=named, flops_per_step=flops, peak_flops=peak,
        note=("aten flops by XLA's cost-analysis convention; the "
              "hand-written kernels and library factorizations count none"))
    print(json.dumps(rec), flush=True)
    _require(all(bits.values()), f"utils: checkpoint bits differ: {bits}")
    _require(all(named.values()),
             f"utils: the trace does not name the kernels: {named}")
    _require(flops > 0 and peak, f"utils: flops {flops}, peak {peak}")


# ---------------------------------------------------------------------------
# phase 4c: the solver loop as captured programs against the eager loop
# ---------------------------------------------------------------------------

GRAPH_DEPTH = (8, 16, 24)    # the eager comparison: dive, group cap, budget
BENCH_GATE = 1008       # config 1: the reference's round-5 count of 1024


def _same_bits(torch, x, y):
    if x.dtype.is_floating_point:
        ints = {4: torch.int32, 8: torch.int64}[x.element_size()]
        x, y = x.view(ints), y.view(ints)
    return torch.equal(x, y)


def _field_diff(torch, a, b) -> dict:
    """Per ALMState field of two runs: "equal" (bit for bit), else the
    largest absolute difference (inf where only one side is NaN)."""
    out = {}
    for k in a._fields:
        x, y = getattr(a, k), getattr(b, k)
        if _same_bits(torch, x, y):
            out[k] = "equal"
        else:
            d = (x.double() - y.double()).abs()
            out[k] = float(torch.nan_to_num(d, nan=float("inf")).max())
    return out


def _stage_runs(torch, g, ctx, lanes, stages):
    """The first group of ``ctx`` through ``g``'s programs: the dive and the
    phase switch, then (with "endgame" in ``stages``) the endgame and a
    drain of the whole group (its converged lanes frozen).  Returns the
    state after each stage and its steps."""
    can, spec = ctx["can"], ctx["spec"]
    inst, dev = can.nlp.inst0, ctx["v0s"].device
    n_max = torch.tensor(spec["n1"], dtype=torch.int32, device=dev)
    xdf = torch.tensor(-1.0, dtype=torch.float32, device=dev)
    states = {"dive": g.run_dive(inst, ctx["v0s"][:lanes], ctx["p1"],
                                 ctx["p2"], n_max)}
    steps = {"dive": spec["n1"]}
    if "endgame" in stages:
        states["endgame"] = g.run_end(inst, states["dive"], ctx["p2"]).state
        states["drain"] = g.run_drain(inst, states["endgame"], ctx["p1"],
                                      ctx["p2d"], n_max, xdf).state
        steps["endgame"] = int((states["endgame"].it
                                - states["dive"].it).max())
        steps["drain"] = int((states["drain"].it
                              - states["endgame"].it).max())
    return states, steps


def compare_programs(torch, ck, ch, path, ctx, dive_chain, stages,
                     end_chain="crp", lanes=B_LANES, phase="graph",
                     reduced=()):
    """One group of ``lanes`` through the grouped solver's dive, switch,
    endgame and drain, eagerly and through the captured programs: the bits
    of every ALMState field after each stage, the launches of both runs,
    and the hand kernels each captured program launches a replay."""
    from tol_tpu_torch.solver.batch import make_grouped_solver

    can = ctx["can"]
    runs = {}
    for loop in ("eager", "program"):
        kkt_end, kkt_dive = make_kkts(can, dive_chain, end_chain)
        g = make_grouped_solver(
            can, kkt_end, ctx["opts"], group_size=lanes, drain_size=lanes,
            dive_opts=ctx["dive_opts"], dive_kkt=kkt_dive, _loop=loop)
        _reset_launch_counts(ck, ch)
        torch.cuda.reset_peak_memory_stats()
        states, steps = _stage_runs(torch, g, ctx, lanes, stages)
        runs[loop] = dict(states=states, steps=steps, g=g,
                          launches=_launch_counts(ck, ch),
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    eager, graph = runs["eager"], runs["program"]
    bits = {st: _field_diff(torch, graph["states"][st], eager["states"][st])
            for st in eager["states"]}
    g = graph["g"]
    replays = {}
    for prog in g.programs.programs.values():
        kind = ("drain" if prog.phase1 is not None
                else "dive" if prog.opts == ctx["dive_opts"] else "endgame")
        # a stage of fewer than two steps captures nothing
        replays[kind] = ("not captured" if prog.graph is None else
                         {_kernel_name(k): n for k, n in prog.launches.items()})
    rec = dict(
        phase=phase, path=path, lanes=lanes, dive_chain=dive_chain,
        endgame_chain=end_chain, ts=can.nlp.T, reduced=list(reduced),
        stages=list(eager["states"]), steps=eager["steps"],
        bits_equal={st: all(v == "equal" for v in d.values())
                    for st, d in bits.items()},
        fields=bits,
        launches=dict(eager=eager["launches"], graph=graph["launches"]),
        launches_equal=eager["launches"] == graph["launches"],
        peak_mem_gib=dict(eager=eager["peak_gib"], graph=graph["peak_gib"]),
        captures=g.programs.captures, launches_per_replay=replays)
    print(json.dumps(rec), flush=True)
    return rec


def run_graph_bench(torch, ck, ch):
    """Bench config 1 at bench.py's full size through the captured programs
    (``bench_torch``'s solver, draws and gate, in this process): 1024
    lanes, groups and drain chunks of 128, gated at the reference's
    round-5 count."""
    import bench_torch as bt

    s = bt.settings()
    _require(s.device.type == "cuda" and s.batch == 1024 and s.group == 128,
             f"graph bench: not bench.py's defaults ({s.batch}, {s.group})")
    ctx = bt.s10_problem(s)
    can = ctx["can"]
    dv, seeds = bt.bench_draw("s10", s.batch, can.n)
    _reset_launch_counts(ck, ch)
    torch.cuda.reset_peak_memory_stats()
    res = bt.run_s10(s, ctx, dv)[0]
    launches = _launch_counts(ck, ch)
    ok, feas_ok, gap = bt.gate_s10(s, can, res)
    rec = dict(
        phase="graph_bench", config="1 S10 / tempest", lanes=s.batch,
        group=s.group, drain=s.drain, n1=s.n1, cap=s.cap1,
        max_iter=s.max_iter, seeds=seeds, reduced=[],
        accurate_and_feasible=int(ok.sum()), gate=BENCH_GATE,
        converged=int(res.converged.sum()), feasible=int(feas_ok.sum()),
        median_cost_gap=float(np.median(gap)),
        median_iters=int(np.median(res.iterations)),
        p90_iters=int(np.percentile(res.iterations, 90)),
        group_iters=res.group_iters, drain_iters=res.drain_iters,
        captures=ctx["gsolve"].programs.captures,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches)
    print(json.dumps(rec), flush=True)
    _require(rec["accurate_and_feasible"] >= BENCH_GATE,
             f"graph bench: {rec['accurate_and_feasible']}/{s.batch} lanes "
             f"pass (< {BENCH_GATE})")
    return launches


def run_graph(torch, ck, ch, dev):
    """The ``graph`` phase: s10's and the storm's first group and the
    s10_seqdive dive, eager against captured, then config 1 at full size
    captured.  Returns the launches of the captured runs."""
    s10 = make_mission(torch, "S10", B_LANES, dev)
    storm = make_mission(torch, "storm", B_LANES, dev)
    cut = lambda ctx: (_cut(torch, ctx, *GRAPH_DEPTH),
                       [_depth_note(ctx["spec"], GRAPH_DEPTH)])
    (s10c, s10_note), (stormc, storm_note) = cut(s10), cut(storm)
    recs = [compare_programs(torch, ck, ch, "s10", s10c, "crp",
                             ("dive", "endgame"), reduced=s10_note),
            compare_programs(torch, ck, ch, "storm", stormc, "crp",
                             ("dive", "endgame"), reduced=storm_note),
            compare_programs(torch, ck, ch, "s10_seqdive", s10c, "pallas",
                             ("dive",), reduced=s10_note)]
    launches = {k: sum(r["launches"]["graph"][k] for r in recs)
                for k in KERNELS}
    for r in recs:
        # the dive's chain, and the endgame's (crp) where it ran
        # and K9 (A, d in the endgame's refinement)
        want = ((CHAIN_KERNELS if r["dive_chain"] == "pallas"
                 else CR_PASS_KERNELS)
                + (CR_PASS_KERNELS if "endgame" in r["stages"] else ())
                + (NODE_KERNELS if "endgame" in r["stages"]
                   else ("node_blocks",)))
        # what the captures recorded: each replay's launches.  These are
        # the wrappers' counts at capture time, so the device-side witness
        # that a replay runs these kernels is compare_programs' bit-equal
        # ALMState against the eager run, not this gate.
        named = {k for p in r["launches_per_replay"].values()
                 if isinstance(p, dict) for k, n in p.items() if n}
        _require(set(want) <= named,
                 f"graph {r['path']}: kernels missing from the replays: "
                 f"{sorted(set(want) - named)}")
    bench = run_graph_bench(torch, ck, ch)
    return {k: launches[k] + bench[k] for k in KERNELS}, recs


# ---------------------------------------------------------------------------
# the paths phase: the JAX package's other solve paths as captured programs
# ---------------------------------------------------------------------------

PATHS_DEPTH = (3, 6, 9)     # the eager comparison: dive, group cap, budget
DENSE_LANES = 8             # the dense KKT's group, at ts=24 (its O((n+m)^3)
                            # oracle is meant for small horizons)
TRACE_ITERS = 64            # steps of the traced dive
# the default mission's goal: east, north, up of the ring's centre and its
# radius; FakeAutopilot starts about (96, 170) m from the datum (as
# tests/make_mission_golden.py)
MISSION_GOAL = (275.0, 170.0, 0.0, 100.0)
# path: (problem, dive chain, endgame chain, the hand kernels it launches);
# S10 is on wind model 1 and the storm's lowerings on the grid at order 2,
# so K9 takes their node blocks (the dense KKT takes its Hessian whole, so
# there only the endgame's refinement launches K9)
PATHS = {
    "structured": ("S10", "structured", "structured", NODE_KERNELS),
    "dense": ("S10_ts24", "dense", "dense", ("defect_blocks",)),
    "scan": ("S10", "scan", "scan", NODE_KERNELS),
    "cr": ("S10", "cr", "cr", NODE_KERNELS),
    "spike": ("S10", "spike", "spike", NODE_KERNELS),
    "wind2": ("wind2", "crp", "crp", CR_PASS_KERNELS),
    "wind4": ("wind4", "crp", "crp", CR_PASS_KERNELS),
    "wind5": ("wind5", "crp", "crp", CR_PASS_KERNELS),
    "storm_onehot": ("storm_onehot", "crp", "crp",
                     CR_PASS_KERNELS + NODE_KERNELS),
    "storm_gather": ("storm_gather", "crp", "crp",
                     CR_PASS_KERNELS + NODE_KERNELS),
}
# the paths solved at full width (the dense KKT is the oracle of small
# horizons: its eager comparison at ts=24 is its whole share)
SOLVE_PATHS = ("cr", "scan", "spike", "structured", "wind2", "wind4",
               "wind5", "storm_onehot", "storm_gather")


def _depth_note(spec, depth) -> str:
    n1, cap, budget = depth
    return (f"dive {spec['n1']} -> {n1}, cap {spec['cap']} -> {cap}, "
            f"budget {spec['budget']} -> {budget}")


def _cut(torch, ctx, n1, cap, budget):
    """``ctx`` with its dive, group cap and budget cut to these."""
    i32 = lambda n: torch.tensor(n, dtype=torch.int32,
                                 device=ctx["v0s"].device)
    return dict(ctx, spec=dict(ctx["spec"], n1=n1, cap=cap, budget=budget),
                p1=ctx["p1"]._replace(max_iter=i32(budget)),
                p2=ctx["p2"]._replace(max_iter=i32(cap)),
                p2d=ctx["p2d"]._replace(max_iter=i32(budget)))


def _launched(launches) -> list:
    return sorted(k for k, n in launches.items() if n)


def _path_kernels_ok(path, launches, want):
    """A path launches every hand kernel of its chain and no other."""
    _require(set(_launched(launches)) == set(want),
             f"{path}: launched {_launched(launches)}, its path has "
             f"{sorted(want)}")


def run_paths_compare(torch, ck, ch, dev) -> dict:
    """Each path's first group through dive, switch, endgame and drain,
    eagerly and captured, at the depth ``PATHS_DEPTH``: every ALMState
    field bit-equal after every stage, the launches equal.  Returns the
    captured runs' launches."""
    n1, cap, budget = PATHS_DEPTH
    total = {k: 0 for k in KERNELS}
    for path, (key, dive_chain, end_chain, want) in PATHS.items():
        lanes = DENSE_LANES if path == "dense" else B_LANES
        spec = MISSIONS[key]
        ctx = _cut(torch, make_mission(torch, key, lanes, dev), n1, cap,
                   budget)
        rec = compare_programs(
            torch, ck, ch, path, ctx, dive_chain, ("dive", "endgame"),
            end_chain=end_chain, lanes=lanes, phase="paths",
            reduced=[_depth_note(spec, PATHS_DEPTH)])
        _require(all(rec["bits_equal"].values()),
                 f"paths {path}: captured bits differ from eager: "
                 f"{rec['fields']}")
        _require(rec["launches_equal"],
                 f"paths {path}: launches differ: {rec['launches']}")
        _path_kernels_ok(path, rec["launches"]["graph"], want)
        for k in KERNELS:
            total[k] += rec["launches"]["graph"][k]
    return total


def _golden_wind() -> dict:
    with open(os.path.join(HERE, "tests", "golden_wind_ts100.json")) as fh:
        return json.load(fh)["models"]


def run_paths_solves(torch, ck, ch, dev) -> dict:
    """The full-width solves of the paths, captured, 128 lanes at ts=100
    with bench.py's constants.  Returns their launches."""
    total = {k: 0 for k in KERNELS}
    goldens = _golden_wind()
    for path in SOLVE_PATHS:
        key, dive_chain, end_chain, want = PATHS[path]
        ctx = make_mission(torch, key, B_LANES, dev)
        extra = dict(kernels_on_path=list(want) or "none: plain torch")
        rec, launches, gap = run_solve(
            torch, ck, ch, path, ctx, B_LANES, dive_chain, want,
            end_chain=end_chain, phase="paths_solve", extra=extra)
        _path_kernels_ok(path, launches, want)
        n = B_LANES
        if path in ("cr", "storm_onehot", "storm_gather"):
            # gated as s10 and storm are, against their goldens
            _require(rec["gated_pass_with_cost_gap"] >= 0.9 * n,
                     f"{path} gate: {rec['gated_pass_with_cost_gap']}/{n} "
                     "lanes pass (< 90%)")
        elif path in ("scan", "spike", "structured"):
            # a sequential order fails the cost gate in float32: not gated
            _require(rec["converged_and_feasible"] >= 0.9 * n,
                     f"{path}: {rec['converged_and_feasible']}/{n} lanes "
                     "converged and feasible (< 90%)")
        else:
            res = ctx["results"][path]
            gold = goldens[path[len("wind"):]]
            lane0 = dict(converged=bool(res.converged[0]),
                         constr_viol=float(res.constr_viol[0]),
                         f=float(res.f[0]), iterations=int(res.iterations[0]),
                         cost_gap=float(gap[0]))
            print(json.dumps(dict(
                phase="paths_wind", path=path, lane0=lane0,
                golden=dict(f=ctx["f_ref"], iterations=gold["iterations"],
                            converged=gold["converged"],
                            source="tests/golden_wind_ts100.json (JAX, "
                                   "float64, CPU)"),
                converged=rec["converged"], median_iters=rec["median_iters"],
                limit="lane 0 converged, cost within 1e-2 of the golden")),
                flush=True)
            _require(lane0["converged"] and abs(lane0["cost_gap"]) < 1e-2,
                     f"{path}: lane 0 {lane0} against the golden")
        for k in KERNELS:
            total[k] += launches[k]
    return total


def run_paths_trace(torch, ck, ch, dev) -> dict:
    """``ALMOptions.trace`` on the card: s10's crp dive of 128 lanes with
    ``TRACE_ITERS`` traced steps, eagerly and captured: the six records,
    every result and state field and the launches equal.  Returns the
    captured run's launches."""
    from tol_tpu_torch.solver.alm import ProgramCache, solve

    ctx = make_mission(torch, "S10", B_LANES, dev)
    can = ctx["can"]
    opts = ctx["dive_opts"]._replace(trace=True, max_iter=TRACE_ITERS)
    runs = {}
    for loop in ("eager", "program"):
        _, kkt = make_kkts(can, "crp")
        cache = ProgramCache()
        _reset_launch_counts(ck, ch)
        res = solve(can, kkt, opts, v0=ctx["v0s"], params=ctx["p1"],
                    keep_state=True, _loop=loop, _programs=cache)
        torch.cuda.synchronize()
        runs[loop] = dict(res=res, launches=_launch_counts(ck, ch),
                          captures=cache.captures)
    e, g = runs["eager"]["res"], runs["program"]["res"]
    names = ("kkt_err", "mu", "gamma", "delta_w", "constr_viol", "f")
    records = {k: _same_bits(torch, a, b)
               for k, a, b in zip(names, g.trace, e.trace)}
    state = _field_diff(torch, g.state, e.state)
    rec = dict(
        phase="paths_trace", path="s10 crp dive, trace=True", lanes=B_LANES,
        steps=TRACE_ITERS, shape=list(g.trace[0].shape),
        records_equal=records, state=state,
        launches=dict(eager=runs["eager"]["launches"],
                      graph=runs["program"]["launches"]),
        captures=runs["program"]["captures"])
    print(json.dumps(rec), flush=True)
    _require(all(records.values())
             and all(v == "equal" for v in state.values()),
             f"paths trace: captured differs from eager: {records} {state}")
    _require(rec["launches"]["eager"] == rec["launches"]["graph"],
             "paths trace: launches differ")
    _require(rec["captures"] == 1, "paths trace: not one captured program")
    # the dive: no dual refinement, so K9's node_blocks alone
    _path_kernels_ok("trace", rec["launches"]["graph"],
                     CR_PASS_KERNELS + ("node_blocks",))
    return rec["launches"]["graph"]


def run_paths_mission(torch, ck, ch) -> dict:
    """``Mission(MissionConfig()).run`` on the card with ``FakeAutopilot``:
    ts=100, one lane per leg on chain "cr", warm starts with a cold retry.
    At least two G7 legs lead to the S10 loiter; the legs' mission types
    and converged flags must be those of the JAX package's own float32 run
    of the same mission (``tests/golden_mission_ts100.json``, written by
    ``tests/make_mission_golden.py``: that run loses some legs at the
    400-iteration budget too); each mission type's program is captured
    once, on its first leg.  Returns the launches."""
    from tol_tpu_torch.mission.autopilot import FakeAutopilot
    from tol_tpu_torch.mission.mission import (Mission, MissionConfig,
                                               default_leg_solver)

    cfg = MissionConfig()
    solve_leg = default_leg_solver(cfg)
    legs = []

    def leg(mission_type, goal, stitch=None, v0=None):
        doc = solve_leg(mission_type, goal, stitch=stitch, v0=v0)
        legs.append(dict(mission=mission_type, converged=doc["converged"],
                         iterations=doc["iterations"],
                         used_warm=doc["used_warm"],
                         cold_retry=doc["cold_retry"],
                         captures_after=solve_leg.programs.captures))
        return doc

    _reset_launch_counts(ck, ch)
    torch.cuda.reset_peak_memory_stats()
    mission = Mission(cfg, FakeAutopilot(), leg_solver=leg)
    traj = mission.run(MISSION_GOAL)
    launches = _launch_counts(ck, ch)
    first = {}
    for i, x in enumerate(legs):
        first.setdefault(x["mission"], i)
    # captures may grow only on a mission type's first leg
    grew = [i for i in range(len(legs))
            if legs[i]["captures_after"]
            > (legs[i - 1]["captures_after"] if i else 0)]
    rec = dict(
        phase="paths_mission", config="MissionConfig() defaults",
        aircraft=cfg.aircraft, ts=cfg.ts, chain=cfg.leg_chain,
        ensemble=cfg.leg_ensemble, leg_max_iter=cfg.leg_max_iter,
        goal=list(MISSION_GOAL), legs=legs, log=mission.log,
        points=len(traj), captures=solve_leg.programs.captures,
        captures_on_legs=grew, launches=launches,
        kernels_on_path=list(NODE_KERNELS),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    with open(os.path.join(HERE, "tests", "golden_mission_ts100.json")) as fh:
        gold = json.load(fh)["legs"]
    rec["golden"] = dict(legs=gold, source="tests/golden_mission_ts100.json "
                                           "(JAX, float32, CPU)")
    rec["converged"] = sum(x["converged"] for x in legs)
    print(json.dumps(rec), flush=True)
    flags = lambda xs: [(x["mission"], x["converged"]) for x in xs]
    _require(flags(legs) == flags(gold),
             f"mission: legs {flags(legs)}, the JAX package's {flags(gold)}")
    _require(sum(x["mission"] == "G7" for x in legs) >= 2
             and legs[-1]["mission"] == "S10",
             f"mission: legs {[x['mission'] for x in legs]}, not two G7 "
             "legs and the loiter")
    _require(grew == sorted(first.values())
             and rec["captures"] == len(first),
             f"mission: captures on legs {grew}, first legs {first}")
    # chain cr is plain torch; wind model 1 puts the node blocks on K9
    _path_kernels_ok("mission", launches, NODE_KERNELS)
    return launches


def run_paths(torch, ck, ch, dev) -> dict:
    """The ``paths`` phase.  Returns the launches of its captured runs."""
    total = {k: 0 for k in KERNELS}
    for part in (lambda: run_paths_compare(torch, ck, ch, dev),
                 lambda: run_paths_solves(torch, ck, ch, dev),
                 lambda: run_paths_trace(torch, ck, ch, dev),
                 lambda: run_paths_mission(torch, ck, ch)):
        for k, n in part().items():
            total[k] += n
    return total


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
    import torch.distributed as dist

    from tol_tpu_torch.ops import _build
    from tol_tpu_torch.ops import chainkern as ch
    from tol_tpu_torch.ops import crkern as ck

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        built = _build.build()
        for name in built:
            _build.load_library(name)
        print(json.dumps(dict(
            phase="build",
            libraries={name: path for name, (path, _) in built.items()},
            ptxas_by_kernel=_ptxas_by_kernel(
                [report for _, report in built.values()]))), flush=True)

        fast = check_fast_ops(torch, dev)
        records = check_kernels(torch, ck, ch, dev)
        print(json.dumps(dict(phase="kernels", tolerance_rel=TOL_REL,
                              fast_ops_vs_ieee=fast,
                              kernels=list(records.values()))), flush=True)

        sweep = sweep_chain_kernels(torch, ch, dev)
        print(json.dumps(dict(phase="sweep", **sweep)), flush=True)

        chains, by_path = check_chains(torch, ck, ch, dev)
        by_path = {"chains": by_path}
        print(json.dumps(dict(phase="chains", tolerance_rel=TOL_CHAINS,
                              launches=by_path["chains"], **chains)),
              flush=True)

        solve_paths, ctx, s10_v = run_solves(torch, ck, ch, dev)
        solve_paths["storm"] = run_storm(torch, ck, ch, dev)
        solve_paths["replan"] = run_replan(torch, ck, ch, dev)
        run_cli()
        solve_paths["bench"] = run_bench()
        solve_paths["parallel"], par = run_parallel(torch, ck, ch, dev)
        solve_paths["scaling"] = run_scaling(torch, ck, ch)
        run_entry(torch)
        run_utils(torch, s10_v, par, ctx)
        solve_paths["graph"], _ = run_graph(torch, ck, ch, dev)
        solve_paths["paths"] = run_paths(torch, ck, ch, dev)
        by_path.update(solve_paths)
        # A kernel's launches: those of the solves; K5, which no solve
        # reaches, has those of the chains phase.
        for name, rec in records.items():
            rec["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
            rec["launches"] = (sum(c[name] for c in solve_paths.values())
                               or by_path["chains"][name])
            _require(rec["launches"] > 0, f"{name} was never launched")
        card = _nvidia_smi("name,power.limit")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
