"""Percent of the window's time per step in which the card ran nothing:
1 - (device busy ms per step in the profiled slice, weighted by the
window's steps per stage) / (untraced ms per step of the same run)."""

from harness.reduce import batch_steps, weighted_per_step


def read(rec):
    mix = batch_steps(rec)
    busy = weighted_per_step(rec, lambda s: s["busy_s"])
    if not mix or not busy:
        return None
    step_s = rec["window_s"] / sum(mix.values())
    return 100.0 * (1.0 - busy / step_s)
