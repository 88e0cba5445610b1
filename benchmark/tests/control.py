"""The comparison's control, on the card at a cell's own size.

The configurations state float32 with TF32 off.  The control is the
answer carried at the nearest precision below: every value of each answer
the window produced (a lane's scaled decision vector; a leg's trajectory
and dt) rounded to TF32's 10-bit mantissa, judged by the same comparison
as the run's own answers.  It is read twice: with the program's claims
(gate, violation, cost, convergence) as it reported them (``claimed``),
and with the claims a program computing at that precision would make of
its own answers, which the reference works out (``honest``).  Both have to
come out not correct; together they give every compared number its upper
reading.

The certificate's own controls (``kkt_ratio``), with the comparison
still holding the answers to the configuration's ``kkt_tol``: the program
run with its KKT tolerance loosened ``--loose-tol`` times (endgame and
base tolerance of a batch; the leg tolerance of the mission layer); and
answers stopped early with the program's convergence claim kept
(``--half-seeds``: a batch's dive, group cap and budget halved; a leg
stopped after its first slice), every answer claimed converged.

``--tf32 1`` runs the program itself with TF32 products switched on
underneath (the solver's own switch to full float32 is overridden); each
request's answers are printed as a digest, so that a sound process on the
same seed shows whether any product of the timed path runs through TF32
at all.

One process sets the cell up once and runs a window per seed (a sound
reading of every compared number, and the TF32 control's), then a window
per ``--half-seeds`` seed of the early-stopped program and, with
``--loose-tol``, per ``--loose-seeds`` seed of the loosened program:

    python3 benchmark/tests/control.py --workload s10_batch --seeds 11,12,13 \\
        --seconds 0 [--tf32 1] [--half-seeds 31,32,33] \\
        [--loose-tol 10 --loose-seeds 21,22,23]

Prints one JSON line per window.  The benchmark's own runs never run this.
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def tf32(x) -> np.ndarray:
    """float32 values rounded to nearest (ties to even) at TF32's 10
    explicit mantissa bits."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0xFFF) + ((b >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return b.view(np.float32)


def rounded(requests: list) -> list:
    """The window's requests with every answer value rounded to TF32."""
    out = []
    for r in requests:
        a = dict(r["answers"])
        if "v" in a:
            a["v"] = tf32(a["v"])
        else:
            a["Z"] = tf32(a["Z"]).astype(np.float64)
            a["dt"] = float(tf32([a["dt"]])[0])
        out.append({**r, "answers": a})
    return out


def honest(cell, ref, requests: list) -> list:
    """Requests whose claims are those of their (rounded) answers: each
    lane's violation and cost as the reference reads them and the gate
    taken on those; a leg converged only where its violation is within
    the feasibility limit."""
    from harness.spec import kind

    cfg, ts, wind = cell.config, cell.config["ts"], cell.config.get("wind")
    sc = ref.Scaling(ref.Problem(cfg["mission"], cfg["aircraft"], ts=ts, wind=wind))
    out = []
    for r in requests:
        a = dict(r["answers"])
        if "v" in a:
            g = cfg["gate"]
            air = np.asarray(a["airframe"])
            viol = np.empty(len(air))
            f = np.empty(len(air))
            for name in set(air):
                idx = np.flatnonzero(air == name)
                J = ref.judge_scaled(ref.Problem(cfg["mission"], name, ts=ts, wind=wind),
                                     sc, a["v"][idx])
                viol[idx], f[idx] = J["viol"], J["f"]
            f_star = None
            if g.get("cost_gap") is not None:
                own = g.get("golden_airframe", cfg["aircraft"])
                f_star = sc.s_f * ref.golden_cost(
                    ref.Problem(cfg["mission"], own, ts=ts, wind=wind),
                    os.path.join(cell.bench, g["golden"]))
            ok = kind(cell).gate(cfg, air, a["converged"], viol, f, f_star)
            a.update(viol=viol, f=f, gated=ok)
        else:
            prob = ref.Problem(cfg["mission"], cfg["aircraft"], goal=r["goal"],
                               stitch=r["stitch"], ts=ts,
                               wind=kind(cell).leg_wind(cfg, r))
            J = ref.judge_physical(prob, sc, a["Z"], a["dt"])
            a.update(F=float(J["F"]), converged=bool(a["converged"]) and float(
                J["viol"]) <= cfg["mission_layer"]["feas_tol"])
        out.append({**r, "answers": a})
    return out


def judge(cell, ref, rec, requests, device="cpu") -> dict:
    from harness.spec import kind

    return kind(cell).judge(cell, ref, requests, rec, device)


def loosen(cell, k: float) -> None:
    """The cell's program with its KKT tolerance ``k`` times looser (the
    gate's ``kkt_tol`` stays)."""
    c = cell.config
    if cell.traffic["kind"] == "mission_legs":
        c["mission_layer"]["tol"] *= k
    else:
        for p in ("base", "endgame"):
            c["params"][p]["tol"] *= k


def force_tf32() -> None:
    """TF32 products on, whatever the program sets afterwards."""
    import torch

    for mod in (torch.backends.cuda.matmul, torch.backends.cudnn):
        cls = type(mod)
        orig = cls.__setattr__

        def setattr_(self, name, value, orig=orig):
            orig(self, name, True if name == "allow_tf32" else value)
        cls.__setattr__ = setattr_
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def digests(requests: list) -> list:
    """A digest of each request's answers, to compare two processes."""
    out = []
    for r in requests:
        a = r["answers"]
        out.append(hashlib.sha256(np.ascontiguousarray(
            a["v"] if "v" in a else a["Z"]).tobytes()).hexdigest()[:16])
    return out


def stop_early(cell, gen) -> None:
    """``gen`` (a set-up system) stopped early, its answers all claimed
    converged: a batch's dive, group cap and budget halved; a leg after
    its first slice (a new leg solver: the budget is its configuration's)."""
    import numpy as np
    import torch

    s = gen.sys
    if cell.traffic["kind"] == "mission_legs":
        leg = s.leg

        def claimed_leg(*a, **k):
            doc = leg(*a, **k)
            doc["converged"] = True
            return doc
        s.leg = claimed_leg
        return
    b = cell.config["batch"]
    half = lambda p, k: p._replace(max_iter=torch.tensor(
        k // 2, dtype=torch.int32, device=p.max_iter.device))
    s.n1 = b["dive_iters"] // 2
    s.p1, s.p2d = half(s.p1, b["budget"]), half(s.p2d, b["budget"])
    s.p2 = half(s.p2, b["group_cap"])
    solve = s.run

    def claimed(*a, **k):
        res = solve(*a, **k)
        return res._replace(converged=np.ones_like(res.converged))
    s.run = claimed


def readings(cell, ref, gen, seed, seconds, device, tf32_control=True) -> dict:
    """One window of ``gen`` on ``seed``: the comparison's numbers, and
    the TF32 control's (claimed and honest)."""
    import run
    from harness import check

    requests, window_s = run.window(gen, seed,
                                    run.requests_for(cell, seconds))
    rec = dict(kind=cell.traffic["kind"], requests=requests, **gen.record())
    numbers = judge(cell, ref, rec, requests, device)
    out = dict(workload=cell.name, seed=seed, window_s=window_s,
               request_s=[r.get("wall_s", r.get("ms", 0.0) * 1e-3) for r in requests],
               attempted=sum(r["lanes"] for r in requests),
               failed=sum(r["failed"] for r in requests),
               correct=check.verdict(numbers, cell.checks)[0], numbers=numbers,
               answers_digests=digests(requests))
    if tf32_control:
        low = rounded(requests)
        out["control"] = {}
        for name, reqs in (("claimed", low), ("honest", honest(cell, ref, low))):
            n = judge(cell, ref, rec, reqs, device)
            out["control"][name] = dict(correct=check.verdict(n, cell.checks)[0],
                                        numbers=n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tf32", type=int, default=0)
    ap.add_argument("--half-seeds", default="")
    ap.add_argument("--loose-tol", type=float, default=0.0)
    ap.add_argument("--loose-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    import run
    from harness.spec import load_cell, reference

    if args.tf32:
        force_tf32()
    device = "cuda"
    cell = load_cell(args.workload)
    ref = reference(cell)
    _, gen, parts = run.set_up(cell, device, time.time())
    print(json.dumps(dict(workload=cell.name, setup=parts, card=run.card_line())),
          flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        if hasattr(gen, "goals"):
            gen.goals = None          # each seed's own stream of goals
        out = readings(cell, ref, gen, seed, args.seconds, device)
        print(json.dumps(dict(out, tf32_products=bool(args.tf32))), flush=True)
    if args.half_seeds:
        if cell.traffic["kind"] == "mission_legs":
            del gen
            torch.cuda.empty_cache()
            early = load_cell(args.workload)
            ml = early.config["mission_layer"]
            ml["leg_max_iter"] = ml["slice"]
            _, gen, _ = run.set_up(early, device, time.time())
        stop_early(cell, gen)
        for seed in (int(s) for s in args.half_seeds.split(",")):
            if hasattr(gen, "goals"):
                gen.goals = None
            out = readings(cell, ref, gen, seed, args.seconds, device, False)
            print(json.dumps(dict(out, stopped_early=True)), flush=True)
    if args.loose_tol:
        del gen
        torch.cuda.empty_cache()
        loosen(cell, args.loose_tol)
        _, gen, _ = run.set_up(cell, device, time.time())
        for seed in (int(s) for s in args.loose_seeds.split(",")):
            if hasattr(gen, "goals"):
                gen.goals = None
            out = readings(cell, ref, gen, seed, args.seconds, device, False)
            print(json.dumps(dict(out, loose_tol=args.loose_tol)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
