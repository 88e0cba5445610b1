"""Benchmark of ``tol_tpu_torch`` on NVIDIA GPUs: one cell of
``BENCHMARK.json`` per run.

    python3 benchmark/run.py --workload s10_batch --seed 7 --seconds 45 --trace 0

Run from the root of a checkout on a machine with the GPUs the cell asks
for; it refuses to run (exit 2, no result) without them.  Set-up builds
the cell's system through the program's normal entry points and warms up
every program the traffic uses; then the window sends a fixed amount of
work: ``round(--seconds / request_s)`` requests (at least one), back to
back, one at a time, where the mix's ``request_s`` is the seconds one
request is planned to take.  So two runs of one seed do the same work, and
the window lasts about ``--seconds``.
With ``--trace 1`` a bounded slice is profiled after the window
(``harness/trace.py``) and the cell's per-layer metrics are printed in
place of its end-to-end ones.  Once the window has closed and the peak
memory has been read, the configuration's plain float64 reference judges
every answer of the window (``harness/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``card`` (name and power limit), ``setup`` (set-up's
parts in seconds), ``requests`` (each request's seconds, and the step
programs it captured or the leg program's replays), ``readings`` (the
comparison's numbers that the cell does not limit) and, last, ``check``
(each compared number beside its limit); the check's numbers are
also the last lines of standard error, after a line per request.  The run exits non-zero with no result if
``jax``, ``jaxlib``, ``flax`` or ``tol_tpu`` was loaded.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

FORBIDDEN = ("jax", "jaxlib", "flax", "tol_tpu")
TRACE_STEPS = 8        # steps (or replays) of each program in the slice


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the run may not load,
    compared whole (``tol_tpu_torch`` is not ``tol_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (out.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0] \
        if out.returncode == 0 else f"nvidia-smi failed: {out.stderr.strip()}"


def set_up(cell, device: str, t0: float = T0) -> tuple:
    """The cell's system, built and warmed up: (kind module, system,
    set-up's parts in seconds)."""
    import torch

    from harness import program, spec

    kind = spec.kind(cell)
    program.prepare()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    parts = dict(imports_s=time.time() - t0)
    t = time.time()
    gen = kind.System(cell, device)
    parts["build_s"] = time.time() - t
    t = time.time()
    parts.update(gen.warm_up() or {}, warm_up_s=time.time() - t)
    return kind, gen, parts


def requests_for(cell, seconds: float) -> int:
    """The window's number of requests: ``seconds`` over the mix's
    planned seconds a request, rounded, at least one."""
    return max(1, round(seconds / cell.traffic["request_s"]))


def window(gen, seed: int, count: int) -> tuple:
    """Requests ``0 .. count - 1`` back to back: (requests, seconds
    taken)."""
    t_start = time.perf_counter()
    requests = [gen.request(seed, k) for k in range(count)]
    return requests, time.perf_counter() - t_start


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float = T0) -> tuple:
    """Set-up, window, optional slice, and the check of one cell.
    Returns (result dict, record)."""
    import torch

    from harness import check, spec
    from harness import trace as tracing
    from reference.roofline import SYMBOLS

    cuda = torch.device(device).type == "cuda"
    kind, gen, parts = set_up(cell, device, t0)
    setup_s = time.time() - t0
    requests, window_s = window(gen, seed, requests_for(cell, seconds))
    peak = torch.cuda.max_memory_allocated(device) if cuda else None

    record = dict(kind=cell.traffic["kind"], config=cell.config,
                  traffic=cell.traffic, ts=cell.config["ts"], setup_s=setup_s,
                  window_s=window_s, requests=requests, trace=None,
                  **gen.record())
    dev_info = dict(platform="gpu" if cuda else "cpu",
                    kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                    count=cell.chips, memory_peak_bytes=peak)
    if trace and cuda:
        record["trace"] = tracing.profile(gen.slice_stages(TRACE_STEPS),
                                          SYMBOLS, device)
        dev_info["busy_s"] = sum(s["busy_s"] for s in record["trace"].values())
        dev_info["window_s"] = sum(s["wall_s"] for s in record["trace"].values())

    del gen
    if cuda:
        torch.cuda.empty_cache()

    numbers = kind.judge(cell, spec.reference(cell), requests, record, device)
    correct, rows = check.verdict(numbers, cell.checks)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(cell, m["name"])(record)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    result = dict(correct=correct,
                  attempted=sum(r["lanes"] for r in requests),
                  failed=sum(r["failed"] for r in requests),
                  metrics=metrics, device=dev_info)
    if record["trace"]:
        result["breakdown"] = tracing.breakdown(record["trace"])
    if cuda:
        result["card"] = card_line()
    result["setup"] = parts
    result["requests"] = [
        dict(s=r.get("wall_s", r.get("ms", 0.0) * 1e-3),
             **{k: r[k] for k in ("captured", "replays") if k in r})
        for r in requests]
    result["readings"] = {k: v for k, v in numbers.items() if k not in cell.checks}
    result["check"] = {name: dict(value=v, limit=lim) for name, v, lim in rows}
    return result, record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {result.get('card')}", file=sys.stderr)
    print("setup: " + ", ".join(f"{k} {v!r}" for k, v in result["setup"].items()),
          file=sys.stderr)
    for i, r in enumerate(result["requests"]):
        print(f"request {i}: " + ", ".join(f"{k} {v!r}" for k, v in r.items()),
              file=sys.stderr)
    for name, v in result["readings"].items():
        print(f"reading {name}: {v!r} (not compared)", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
