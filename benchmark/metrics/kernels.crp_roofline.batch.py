"""Percent of the least time K1-K3 could take that their launches took:
the sum of each launch's bound (bytes over 3.35 TB/s or flops over
67 TFLOP/s, the larger, from ``reference/roofline.py``'s counts of the
launch shape) over their summed device time, both per step of each stage
program and weighted by the window's steps per stage."""

import os

from harness.reduce import weighted_per_step
from harness.spec import load_module

_RF = load_module(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reference", "roofline.py"), "bench_roofline")


def read(rec):
    cfg = rec["config"]
    lanes = cfg["batch"]["group"]
    ts = rec["ts"]
    n_pad = 1 << (ts - 1).bit_length()
    border = rec["n"] - (ts + 1) * 11 + 11     # z_0, dt and the slacks

    def bound(s):
        n = s["launches"]
        return _RF.launches_bound_s(n["K1"], n["K2"], n["K3"], lanes, n_pad,
                                    border)

    b = weighted_per_step(rec, bound)
    t = weighted_per_step(rec, lambda s: s["hand_s"])
    return None if not b or not t else 100.0 * b / t
