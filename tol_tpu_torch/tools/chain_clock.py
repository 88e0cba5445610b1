"""Where a chain step of K6-K8 spends its cycles (clock64 traces).

    python3 -m tol_tpu_torch.tools.chain_clock [--group 2 --threads 256 ...]

Builds ``tools/chain_clock.cu`` with the kernels' nvcc flags and runs, on
128 lanes of T = 100 chain blocks at border width 12 (K6, K7) and 13 (K8),
float32, the seeded chains of ``chip_smoke.py``:

- the K6, K7 and K8 of the second slice with clock stamps between their
  phases or steps (K6: Cholesky, inverse columns, [O | R~] columns and the
  three barriers; K7: a whole step, and the same steps with their operands
  in shared memory, so that the difference is the wait on device memory;
  K8: the a-term, the product with t2, the stores);
- the shipped passes with stamps after every barrier (K6: P1 Cholesky and
  inverse, P2 t2, P3 next D~ and tR; K7: per chunk of steps, the chain and
  the other threads' border sums, tr stores and copies; K8: staging and
  a-terms, the chain);
- the latency of one link of a dependent chain of fp32 adds, FMAs,
  correctly rounded square roots and IEEE quotients, and of one 11x11
  ``chol_lower`` and ``chol_lower`` + ``inverse_column`` on one thread.

Prints one JSON line of cycles (per chain step where so named) and the
card's name and power limit.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
NB, B, T = 11, 128, 100


def start_build():
    """Start nvcc on ``chain_clock.cu`` (the kernels' flags) in the
    background; :func:`load` waits for it."""
    sys.path.insert(0, ROOT)
    from tol_tpu_torch.ops import _build
    out_dir = os.path.join(_build.BUILD_ROOT, "chain_clock")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libchain_clock.so")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chain_clock.cu")
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                             _build._CSRC, "-o", lib, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, lib


def load(handle):
    """The built library and its ptxas report."""
    proc, lib = handle
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on chain_clock.cu:\n{err}")
    so = ctypes.CDLL(lib)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    so.old_k6.argtypes = [P] * 7 + [I, I, L, P]
    so.old_k7.argtypes = [P] * 5 + [I, I, L, I, P]
    so.pass_k7.argtypes = [P] * 6 + [I, I, L, I, I, I, P]
    so.old_k8.argtypes = [P] * 4 + [I, I, L, P]
    so.pass_k6.argtypes = [P] * 7 + [I, I, L, I, I, P]
    so.pass_k6_apart.argtypes = [P] * 7 + [I, I, L, I, I, P]
    so.invert_loop.argtypes = [P, I, I, P, P]
    so.pass_k8.argtypes = [P] * 4 + [I, I, L, I, I, P]
    so.latency.argtypes = [P, I, P, P]
    so.fast_ops_check.argtypes = [L, P]
    return so, err


def _check(code, what):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def run(torch, so, G6, th6, G7, th7, G8, th8):
    """The traces and latencies, as one record (cycles)."""
    from tol_tpu_torch.ops import chainkern as ch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    nB = 12
    A = torch.randn(B, T, NB, NB, generator=gen, device=dev) * 0.3
    M = A @ A.transpose(2, 3) + 4.0 * torch.eye(NB, device=dev)
    O = torch.randn(B, T, NB, NB, generator=gen, device=dev) * 0.1
    O[:, -1] = 0.0
    W = torch.randn(B, T, NB, nB, generator=gen, device=dev)
    M, O, W = (ch._lanes_last(t) for t in (M, O, W))
    Dinv, t2, tR, S = ch.factor_eliminate_plain(M, O, W)
    outs6 = [torch.empty_like(Dinv), torch.empty_like(t2),
             torch.empty_like(tR), torch.empty_like(S)]
    tRc = torch.cat([tR, torch.randn(T, NB, 1, B, generator=gen, device=dev)],
                    dim=2).contiguous()
    coef = torch.randn(nB + 1, 1, B, generator=gen, device=dev)
    x = torch.empty(T, NB, B, device=dev)
    ptr = lambda ts: [t.data_ptr() for t in ts]
    rec = dict(B=B, T=T, nC_k6=nB, nB_k7=nB, nC_k8=nB + 1)

    cyc = torch.zeros(64, dtype=torch.int64, device=dev)
    for _ in range(2):      # the second run is recorded
        _check(so.old_k6(*ptr([M, O, W] + outs6), T, nB, B, cyc.data_ptr()),
               "old_k6")
    c = cyc.tolist()
    names = ["phase_A_chol_rt", "barrier_1", "phase_B_inverse", "barrier_2",
             "phase_C_columns", "barrier_3"]
    rec["old_k6_cycles_per_step"] = {
        who: {n: c[w * 7 + k] / T for k, n in enumerate(names)}
        | {"loop": c[w * 7 + 6] / T}
        for w, who in enumerate(["warp_0", "cholesky_warp"])}
    r = torch.randn(T, NB, 1, B, generator=gen, device=dev)
    tr, sb = torch.empty_like(r), torch.empty(nB, 1, B, device=dev)
    k7 = {}
    for shared in (0, 1):
        cyc.zero_()
        for _ in range(2):
            _check(so.old_k7(*ptr([Dinv, O, tR, r, tr]), T, nB, B, shared,
                             cyc.data_ptr()), "old_k7")
        torch.cuda.synchronize()
        k7["operands_in_shared_memory" if shared else "step"] = cyc[0].item() / T
    k7["waiting_on_device_memory"] = (k7["step"]
                                      - k7["operands_in_shared_memory"])
    rec["old_k7_cycles_per_step"] = k7
    # the old K7's time by CUDA events, its operands warm in the L2 from the
    # run before, and cold (a 128 MiB write before each run)
    flush = torch.empty(32 << 20, device=dev)
    ms = {}
    for cold in (False, True):
        total = 0.0
        for _ in range(10):
            if cold:
                flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _check(so.old_k7(*ptr([Dinv, O, tR, r, tr]), T, nB, B, 0,
                             cyc.data_ptr()), "old_k7")
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        ms["cold_l2" if cold else "warm"] = total / 10
    rec["old_k7_ms"] = ms
    cyc.zero_()
    for _ in range(2):
        _check(so.old_k8(*ptr([tRc, t2, coef, x]), T, nB + 1, B,
                         cyc.data_ptr()), "old_k8")
    c = cyc.tolist()
    rec["old_k8_cycles_per_step"] = dict(
        a_term=c[0] / T, t2_product=c[1] / T, stores=c[2] / T, loop=c[3] / T)

    marks = torch.zeros(4 * 1024, dtype=torch.int64, device=dev)
    for _ in range(2):
        _check(so.pass_k6(*ptr([M, O, W] + outs6), T, nB, B, G6, th6,
                          marks.data_ptr()), "pass_k6")
    m = marks.tolist()
    p = [[m[2 + 3 * i + k] - m[1 + 3 * i + k] for i in range(T)]
         for k in range(3)]
    # P1's two parts: the chain (invert, thread 0) and the rest (the first
    # thread past the chain's warps)
    p1 = [[m[j * 1024 + 2 + 3 * i] - m[1 + 3 * i] for i in range(T)]
          for j in (1, 2)]
    rec["k6_pass"] = dict(
        group=G6, threads=th6, prologue=m[1] - m[0],
        last_border_columns=m[2 + 3 * T] - m[1 + 3 * T],
        cycles_per_step=dict(P1_invert_thread_0=sum(p1[0]) / T,
                             P1_rest_first_thread=sum(p1[1]) / T,
                             P1_cholesky_inverse=sum(p[0]) / T,
                             P2_t2=sum(p[1]) / T, P3_next_D_tR=sum(p[2]) / T,
                             step=(m[1 + 3 * T] - m[1]) / T))
    marks.zero_()
    for _ in range(2):
        _check(so.pass_k6_apart(*ptr([M, O, W] + outs6), T, nB, B, G6, th6,
                                marks.data_ptr()), "pass_k6_apart")
    m = marks.tolist()
    rec["k6_pass"]["chain_apart"] = dict(
        P1_invert_thread_0=sum(m[1024 + 2 + 3 * i] - m[1 + 3 * i]
                               for i in range(T)) / T,
        step=(m[1 + 3 * T] - m[1]) / T)

    def k7(G, th, apart):
        """Cycles of the K7 pass: per step on the chain (thread 0) and on the
        first thread past the chain's warps (border sums, tr stores,
        copies), per step in all, and the first chunks one by one."""
        marks.zero_()
        for _ in range(2):
            _check(so.pass_k7(*ptr([Dinv, O, tR, r, tr, sb]), T, nB, B, G, th,
                              apart, marks.data_ptr()), "pass_k7")
        m = marks.tolist()
        nc = next(c for c in range(T + 1) if m[2 + c] == 0)   # chunks
        chain = [m[1024 + 2 + c] - m[1 + c] for c in range(nc)]
        rest = [m[2048 + 2 + c] - m[1 + c] for c in range(nc)]
        return dict(
            group=G, threads=th, chain_apart=bool(apart), chunks=nc,
            prologue=m[1] - m[0], chain_per_step=sum(chain) / T,
            rest_first_thread_per_step=sum(rest) / T,
            step=(m[1 + nc] - m[1]) / T,
            border_tail=m[2048 + 2 + nc] - m[1 + nc],
            first_chunks=[dict(chunk=m[2 + c] - m[1 + c], chain=chain[c],
                               rest_start=m[3072 + 2 + c] - m[1 + c],
                               rest=rest[c]) for c in range(min(nc, 3))])

    rec["k7_pass"] = k7(G7, th7, 0)
    rec["k7_pass_chain_apart"] = k7(G7, th7, 1)
    marks.zero_()
    for _ in range(2):
        _check(so.pass_k8(*ptr([tRc, t2, coef, x]), T, nB + 1, B, G8, th8,
                          marks.data_ptr()), "pass_k8")
    m = marks.tolist()
    rec["k8_pass"] = dict(group=G8, threads=th8,
                          staging_and_a_terms=m[1] - m[0], chain=m[2] - m[1],
                          chain_per_step=(m[2] - m[1]) / T)

    spd = (A[0, 0] @ A[0, 0].T + 4.0 * torch.eye(NB, device=dev)).contiguous()
    n = 4096
    sink = torch.zeros(1, device=dev)
    lat = torch.zeros(7, dtype=torch.int64, device=dev)
    inv = {}
    for G in (1, 2):
        for _ in range(2):
            _check(so.invert_loop(spd.data_ptr(), G, 64, lat.data_ptr(),
                                  sink.data_ptr()), "invert_loop")
        inv[f"invert_one_warp_G{G}"] = lat.tolist()[0] / 64
    for _ in range(2):
        _check(so.latency(spd.data_ptr(), n, lat.data_ptr(), sink.data_ptr()),
               "latency")
    c = [v / n for v in lat.tolist()]
    rec["latency_cycles"] = dict(
        fadd=c[0], ffma=c[1], sqrt_plus_fadd=c[2], quotient_plus_fadd=c[3],
        sqrt=c[2] - c[0], quotient=c[3] - c[0], chol_lower_11=c[4],
        chol_lower_plus_inverse_column=c[5],
        zero_numerator_quotient=c[6] - c[0] - c[1], **inv)
    cnt = torch.zeros(4, dtype=torch.int64, device=dev)
    _check(so.fast_ops_check(1 << 26, cnt.data_ptr()), "fast_ops_check")
    c = cnt.tolist()
    rec["fast_ops_vs_ieee"] = dict(sqrt_tested=c[1], sqrt_bits_differ=c[0],
                                   quotient_tested=c[3],
                                   quotient_bits_differ=c[2])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--group", type=int, default=None,
                    help="K6 lanes per block (default: the shipped one)")
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--k7-group", type=int, default=None)
    ap.add_argument("--k7-threads", type=int, default=None)
    ap.add_argument("--k8-group", type=int, default=None)
    ap.add_argument("--k8-threads", type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chain_clock: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tol_tpu_torch.ops import chainkern as ch
    so, ptxas = load(start_build())
    rec = dict(tool="chain_clock", **run(
        torch, so, args.group or ch.K6_GROUP, args.threads or ch.K6_THREADS,
        args.k7_group or ch.K7_GROUP, args.k7_threads or ch.K7_THREADS,
        args.k8_group or ch.K8_GROUP, args.k8_threads or ch.K8_THREADS))
    rec["ptxas"] = [ln.split("info    :")[-1].strip()
                    for ln in ptxas.splitlines()
                    if "entry function" in ln or "registers" in ln
                    or "spill" in ln]
    print(json.dumps(rec), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
