"""Milliseconds from a new goal to a stitched, converged-or-given-up leg:
the window's whole wall time over the legs it completed."""


def read(rec):
    if rec["kind"] != "mission_legs" or not rec["requests"]:
        return None
    return 1e3 * rec["window_s"] / len(rec["requests"])
