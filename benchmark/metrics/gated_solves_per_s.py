"""Lanes that pass the configuration's gate per second: every gated lane
of every batch the window ran, over the window's whole wall time."""


def read(rec):
    if rec["kind"] != "grouped_batch" or rec["window_s"] <= 0:
        return None
    return sum(r["gated"] for r in rec["requests"]) / rec["window_s"]
