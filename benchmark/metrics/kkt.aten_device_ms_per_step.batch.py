"""Device milliseconds per step outside the hand kernels K1-K3: the
profiled slice's busy time less the hand kernels' time, per step of each
stage program, weighted by the window's steps per stage."""

from harness.reduce import weighted_per_step


def read(rec):
    v = weighted_per_step(rec, lambda s: s["busy_s"] - s["hand_s"])
    return None if v is None or v <= 0 else 1e3 * v
