"""Command-line entry point (port of ``tol_tpu/__main__.py``):

    python -m tol_tpu_torch EAST NORTH UP EAST_GOAL NORTH_GOAL UP_GOAL RADIUS \\
        AIRCRAFT MISSION [--out snopt_results.json] [--device cpu]

positions and goals in datum-relative ENU meters, mission in {G7, S10};
writes a ``snopt_results.json``-compatible document and exits 0 when the
solve converged.  The mission console:

    python -m tol_tpu_torch mission --goal E,N,U,R [--aircraft tempest]

Both run on the CUDA device unless ``--device`` names another (without a
GPU they raise).  The solve runs in float64 on the CPU and in float32 on
the card, as the JAX package runs with x64 on the CPU and without it on
the accelerator; the default tolerances follow the type.
"""

from __future__ import annotations

import argparse
import sys


def _device_and_dtype(device):
    import torch

    from tol_tpu_torch.problems.base import resolve_device

    dev = resolve_device(device)
    return dev, (torch.float64 if dev.type == "cpu" else torch.float32)


def solve_cli(argv):
    p = argparse.ArgumentParser(prog="tol_tpu_torch")
    p.add_argument("east", type=float)
    p.add_argument("north", type=float)
    p.add_argument("up", type=float)
    p.add_argument("east_goal", type=float)
    p.add_argument("north_goal", type=float)
    p.add_argument("up_goal", type=float)
    p.add_argument("radius_goal", type=float)
    p.add_argument("aircraft")
    p.add_argument("mission", choices=["G7", "S10"])
    p.add_argument("--out", default="snopt_results.json")
    p.add_argument("--ts", type=int, default=None)
    p.add_argument("--wind-model", type=int, default=1)
    p.add_argument("--tol", type=float, default=None,
                   help="KKT tolerance (default: 1e-6 on f64, 5e-3 f32)")
    p.add_argument("--max-iter", type=int, default=800)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    import torch

    from tol_tpu_torch.api import make_config, make_problem
    from tol_tpu_torch.config import Goal
    from tol_tpu_torch.io.results import results_document, write_results_json
    from tol_tpu_torch.solver.alm import ALMOptions, solve
    from tol_tpu_torch.solver.canonical import canonicalize
    from tol_tpu_torch.solver.kkt_condensed import make_condensed_kkt

    device, dtype = _device_and_dtype(args.device)
    f64 = dtype == torch.float64
    # ENU -> NED goal.
    goal = Goal(xg=args.north_goal, yg=args.east_goal, zg=-args.up_goal,
                rg=args.radius_goal)
    print(f"TOL STATUS: Building {args.mission}...", flush=True)
    tol = args.tol if args.tol is not None else (1e-6 if f64 else 5e-3)
    nlp = make_problem(args.mission, aircraft=args.aircraft, ts=args.ts,
                       wind_model=args.wind_model, goal=goal, dtype=dtype,
                       device=device)
    can = canonicalize(nlp, scaling="auto")
    kkt = make_condensed_kkt(can, refine=1, chain="cr")
    print("TOL STATUS: Solving now", flush=True)
    res = solve(can, kkt,
                ALMOptions(tol=tol, feas_tol=(1e-5 if f64 else 1e-4),
                           max_iter=args.max_iter, gamma_init=0.01,
                           gamma_min=5e-6, gamma_shrink=0.2,
                           gamma_eager=True, mu_init=6e-5,
                           mu_shrink=0.1, kappa_inner=2.0,
                           prox=2.5e-3, dual_refine_k=4))
    Z, dt, _ = can.split(can.to_physical(res.v[0]))
    cfg = make_config(args.mission, args.aircraft, ts=args.ts,
                      wind_model=args.wind_model)
    f = float(res.f[0])
    converged = bool(res.converged[0])
    doc = results_document(cfg, goal, Z, dt, f / float(can.scaling.s_f),
                           aircraft_name=args.aircraft,
                           east=args.east, north=args.north, up=args.up)
    doc["converged"] = converged
    doc["kkt_err"] = float(res.kkt_err[0])
    doc["iterations"] = int(res.iterations[0])
    write_results_json(args.out, doc)
    status = "Run Complete!" if converged else (
        f"NOT CONVERGED (kkt={doc['kkt_err']:.2e})")
    print(f"TOL STATUS: {status}  f={f:.6f} -> {args.out}")
    return 0 if converged else 1


def mission_cli(argv):
    p = argparse.ArgumentParser(prog="tol_tpu_torch mission")
    p.add_argument("--goal", required=True,
                   help="east,north,up,radius (datum-relative ENU meters)")
    p.add_argument("--aircraft", default="tempest")
    p.add_argument("--ts", type=int, default=100)
    p.add_argument("--wind-model", type=int, default=1)
    p.add_argument("--kml", default="trajectory.kml")
    p.add_argument("--json", default="trajectory.json")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)

    from tol_tpu_torch.mission import FakeAutopilot, Mission, MissionConfig

    device, dtype = _device_and_dtype(args.device)
    goal = tuple(float(x) for x in args.goal.split(","))
    cfg = MissionConfig(aircraft=args.aircraft, ts=args.ts,
                        wind_model=args.wind_model, device=str(device),
                        dtype=dtype)
    m = Mission(cfg, FakeAutopilot())
    traj = m.run(goal)
    for line in m.log:
        print(line)
    traj.write_to_kml(args.kml)
    traj.write_to_json(args.json)
    print(f"mission complete: {len(traj)} samples -> {args.kml}, {args.json}")
    return 0


def main():
    argv = sys.argv[1:]
    if argv and argv[0] == "mission":
        raise SystemExit(mission_cli(argv[1:]))
    raise SystemExit(solve_cli(argv))


if __name__ == "__main__":
    main()
