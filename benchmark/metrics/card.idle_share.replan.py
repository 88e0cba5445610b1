"""Percent of a leg's time in which the card ran nothing: 1 - (device busy
seconds per replay of the leg program in the profiled slice x the
window's mean replays per leg, the program's own count) / (untraced
seconds per leg)."""

from harness.reduce import replays_per_leg


def read(rec):
    tr, reps = rec.get("trace"), replays_per_leg(rec)
    if not tr or not reps:
        return None
    steps = sum(s["steps"] for s in tr.values())
    busy_leg = sum(s["busy_s"] for s in tr.values()) / steps * reps
    return 100.0 * (1.0 - busy_leg / (rec["window_s"] / len(rec["requests"])))
