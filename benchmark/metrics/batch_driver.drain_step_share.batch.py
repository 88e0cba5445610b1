"""Percent of the window's 128-lane steps spent in drain chunks (a count
of the grouped solver's own iterations)."""


def read(rec):
    if rec["kind"] != "grouped_batch":
        return None
    drain = sum(r["drain_iters"] for r in rec["requests"])
    steps = drain + sum(r["group_iters"] for r in rec["requests"])
    return 100.0 * drain / steps if steps else None
