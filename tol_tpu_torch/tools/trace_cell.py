"""A benchmark cell's window under the program's recorder, and one step by region.

    python3 -m tol_tpu_torch.tools.trace_cell --workload s10_batch \
        --seed 4100000044 --seconds 45 [--windows off,on] [--out DIR]

Sets the cell up as ``benchmark/run.py`` does, then runs its window once
per entry of ``--windows`` on the same seed (so the same work): ``off``
with the recorder off, ``on`` under ``utils.profiling.recording()``.  With
a CUDA device it then takes the benchmark's profiled slice (its busy time a
step, per stage program), runs one eager step of each of the batch cell's
stage programs by region (``profiling.step_regions``), and times the
recorder's pieces on this host.  The last ``on`` window gives:

- ``replay_gap_share``: the window's time with no replay on the card, over
  the window (%);
- ``check_gap_share``: the gap time put down to ``alm.check``, over the
  window (%);
- ``masked_replay_share`` (batch cells): 1 - the window's iterations
  (``group_iters + drain_iters``) over its replays (%);
- ``<region>_ms_per_step`` (batch cells): each region's device ms in one
  eager step of a stage program, weighted by the window's steps per stage
  (the benchmark's ``harness/reduce.batch_steps``); ``wind.grid`` is the
  gridded wind's interpolation (wind model 3), wherever it runs;
- ``wind.grid_queries_per_step`` (batch cells): the positions the gridded
  wind interpolated in those eager steps (the recorder's counter
  ``wind.grid.queries``), weighted the same way;
- ``kkt.node_blocks.kernel_nodes_per_step`` and
  ``kkt.node_blocks.transforms_nodes_per_step`` (batch cells): the nodes
  whose derivative blocks those steps took by the kernel K9 and by the
  ``torch.func`` transforms (the recorder's counters
  ``kkt.node_blocks.kernel`` and ``.transforms``), weighted the same way:
  which path the cell takes.

Prints one JSON line; with ``--out`` also writes it to
``DIR/trace_<workload>_<seed>.json``.  Reads the benchmark's code and
changes none of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BENCH = os.path.join(ROOT, "benchmark")


def run_window(brun, gen, seed, count, on):
    from tol_tpu_torch.utils.profiling import recording

    if not on:
        return brun.window(gen, seed, count) + (None,)
    with recording() as rec:
        reqs, w = brun.window(gen, seed, count)
    sm = rec.summary()
    sm["intervals"] = len(rec.intervals)
    sm["spans_recorded"] = len(rec.spans)
    return reqs, w, sm


def metrics(kind, reqs, sm, regions):
    from harness.reduce import batch_steps

    W = sm["window_s"]
    out = dict(replay_gap_share=100.0 * (W - sm["replay_s"]) / W,
               check_gap_share=100.0 * sm["gaps"].get("alm.check", 0.0) / W)
    mix = batch_steps(dict(kind=kind, requests=reqs))
    if mix is None:
        return out
    iters = sum(r["group_iters"] + r["drain_iters"] for r in reqs)
    reps = sum(sm["replays"].values())
    out["masked_replay_share"] = 100.0 * (1.0 - iters / reps) if reps else None
    out["window_steps"] = mix
    if regions:
        tot = sum(mix.values())
        for r in ("kkt.blocks", "kkt.condense", "step.armijo",
                  "step.dual_refine", "wind.grid"):
            out[r + "_ms_per_step"] = sum(
                n * regions[k][r]["ms"] for k, n in mix.items() if n) / tot
        for key, c in (("wind.grid_queries_per_step", "wind.grid.queries"),
                       ("kkt.node_blocks.kernel_nodes_per_step",
                        "kkt.node_blocks.kernel"),
                       ("kkt.node_blocks.transforms_nodes_per_step",
                        "kkt.node_blocks.transforms")):
            out[key] = sum(n * regions[k].get(c, 0)
                           for k, n in mix.items() if n) / tot
    return out


def stage_steps(gen) -> dict:
    """One eager step of each stage program of a batch cell, by stage:
    each stage runs one step on one group, and the program it used is
    then the cache's most recently used one."""
    system = gen.sys
    if not hasattr(system, "stage_runs"):
        return {}
    out = {}
    for name, run in system.stage_runs(1).items():
        run()
        out[name] = next(reversed(system.solve.programs.programs.values())).step
    return out


def host_costs(device):
    """ns per call of the recorder's pieces on this host."""
    import torch

    from tol_tpu_torch.utils.profiling import recording, replay, span

    n = 20000
    res = {}
    t = time.perf_counter_ns()
    for _ in range(n):
        with span("x"):
            pass
    res["span_off_ns"] = (time.perf_counter_ns() - t) / n
    t = time.perf_counter_ns()
    for _ in range(n):
        with replay(128, True):
            pass
    res["replay_off_ns"] = (time.perf_counter_ns() - t) / n
    with recording():
        t = time.perf_counter_ns()
        for _ in range(n):
            with span("x"):
                pass
        res["span_on_ns"] = (time.perf_counter_ns() - t) / n
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(2000)]
        torch.cuda.synchronize(device)
        t = time.perf_counter_ns()
        for e in evs:
            e.record()
        res["event_record_ns"] = (time.perf_counter_ns() - t) / len(evs)
        torch.cuda.synchronize(device)
        anchor = evs[-1]
        t = time.perf_counter_ns()
        for e in evs:
            e.elapsed_time(anchor)
        res["elapsed_time_ns"] = (time.perf_counter_ns() - t) / len(evs)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45)
    ap.add_argument("--windows", default="on")
    ap.add_argument("--slice", type=int, default=1)
    ap.add_argument("--tiny", action="store_true",
                    help="the benchmark tests' tiny cell, on the CPU")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [BENCH, ROOT]
    import torch

    import run as brun
    from harness import trace as tracing
    from harness.spec import load_cell
    from reference.roofline import SYMBOLS
    from tol_tpu_torch.utils import profiling

    cell, dev = load_cell(args.workload), "cuda"
    if args.tiny:
        sys.path.insert(0, os.path.join(BENCH, "tests"))
        from tiny import tiny
        cell, dev = tiny(cell), "cpu"
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    kind, gen, parts = brun.set_up(cell, dev, T0)
    count = brun.requests_for(cell, args.seconds)
    out = dict(card=brun.card_line() if dev == "cuda" else "cpu",
               torch=torch.__version__, cuda=torch.version.cuda,
               workload=args.workload, seed=args.seed, setup=parts,
               windows=[])
    last = None
    for mode in args.windows.split(","):
        reqs, w, sm = run_window(brun, gen, args.seed, count, mode == "on")
        row = dict(mode=mode, window_s=w,
                   failed=sum(r["failed"] for r in reqs))
        if reqs and "group_iters" in reqs[0]:
            row["steps"] = sum(r["group_iters"] + r["drain_iters"]
                               for r in reqs)
        if sm is not None:
            row["summary"] = sm
            last = (reqs, sm)
        out["windows"].append(row)
    regions = None
    if dev == "cuda":
        if args.slice:
            tr = tracing.profile(gen.slice_stages(brun.TRACE_STEPS), SYMBOLS,
                                 "cuda")
            out["slice"] = {k: dict(busy_ms_per_step=1e3 * v["busy_s"]
                                    / v["steps"], steps=v["steps"])
                            for k, v in tr.items()}
        steps = stage_steps(gen)
        if steps:
            regions = profiling.step_regions(steps)
            out["regions"] = regions
            out["regions_total_ms"] = {
                n: sum(v["ms"] for v in r.values() if isinstance(v, dict))
                for n, r in regions.items()}
        out["host_costs"] = host_costs(dev)
    if last is not None:
        out["metrics"] = metrics(cell.traffic["kind"], *last, regions)
    line = json.dumps(out)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"trace_{args.workload}_"
                               f"{args.seed}.json"), "w") as f:
            f.write(line)
    print(line, flush=True)


if __name__ == "__main__":
    main()
