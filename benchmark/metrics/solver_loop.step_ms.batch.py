"""Milliseconds per 128-lane solver step in the window: its wall time
over the steps the batches executed (each group's executed iterations
plus each drain chunk's extra ones)."""


def read(rec):
    if rec["kind"] != "grouped_batch":
        return None
    steps = sum(r["group_iters"] + r["drain_iters"] for r in rec["requests"])
    return 1e3 * rec["window_s"] / steps if steps else None
