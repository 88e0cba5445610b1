"""Arithmetic shared by the metric readers.

A run's record (``run.py``) holds the window's requests, its wall
seconds, the set-up seconds and, in a traced run, the profiled slice's
sessions.  The slice's per-step figures are weighted by the window's own
mix of steps, so that a per-step number speaks for the window.
"""

from __future__ import annotations


def batch_steps(rec) -> dict | None:
    """The window's 128-lane steps by stage program: the dive runs
    ``dive_iters`` steps per group, the rest of a group's executed
    iterations are endgame steps, and drain chunks add their own."""
    if rec["kind"] != "grouped_batch":
        return None
    reqs = rec["requests"]
    dive = sum(r["dive_steps"] for r in reqs)
    group = sum(r["group_iters"] for r in reqs)
    return dict(dive=dive, endgame=group - dive,
                drain=sum(r["drain_iters"] for r in reqs))


def weighted_per_step(rec, value) -> float | None:
    """The window-weighted mean over stages of ``value(session) / steps``
    (None without a traced slice)."""
    mix, tr = batch_steps(rec), rec.get("trace")
    if mix is None or not tr:
        return None
    total = sum(mix.values())
    if total <= 0:
        return None
    return sum(n * value(tr[k]) / tr[k]["steps"]
               for k, n in mix.items() if n) / total


def replays_per_leg(rec) -> float | None:
    """Mean replays of the leg program per window leg, as the program's
    own counters count them (None where a leg has no count)."""
    if rec["kind"] != "mission_legs" or not rec["requests"]:
        return None
    n = [r.get("replays") for r in rec["requests"]]
    if any(x is None for x in n):
        return None
    return sum(n) / len(n)
