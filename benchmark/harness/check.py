"""The comparison that decides ``correct``: every answer the window
produced, judged by the configuration's plain float64 reference once the
window has closed.  Each request kind (``kinds/<kind>.py``) works out its
numbers in its ``judge``; each number that ``checks/<workload>.json``
gives a limit passes at or under it (a number with no limit there is
reported, not compared):

- ``unanswered``: the share of requests (lanes, legs) that did not come
  back as a passing answer of their own: the configuration's gate on the
  program's claims (batch) or its convergence flag (legs) says no, or the
  lane's answer is bit for bit an earlier lane's (no two lanes solved
  apart end on the same bits).
- ``viol_err`` (batch): the largest gap between the scaled violation the
  program reports for a lane and the reference's, over the lanes with a
  finite answer, as a share of the gate's feasibility limit.  The
  reference counts the rows and the boxes.
- ``viol_ratio`` (legs): the largest violation the reference finds on a
  leg the program calls converged, as a share of the feasibility limit
  (rows, boxes, and node 0's stitch box about the previous leg).
- ``cost_err``: the largest relative gap between the cost the program
  reports (lanes: scaled; legs: the document's physical ``FinalCost``)
  and the reference's, and, where the gate has a cost side, between the
  program's cost of the golden point and the reference's.
- ``kkt_ratio``: the largest KKT error that the reference works out again
  (its own multipliers, ``reference.certificate``) at an answer the
  program passes (a gated lane, a converged leg), as a share of the
  certificate's tolerance ``gate.kkt_tol``.
"""

from __future__ import annotations

import numpy as np


def first_of_equal_rows(v) -> np.ndarray:
    """(B,) True where a row of ``v`` is not bit for bit an earlier row."""
    v = np.ascontiguousarray(v)
    rows = v.view(np.dtype((np.void, v.dtype.itemsize * v.shape[1])))[:, 0]
    first = np.zeros(len(v), dtype=bool)
    first[np.unique(rows, return_index=True)[1]] = True
    return first


def verdict(numbers: dict, checks: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number that ``checks``
    limits at or under its limit; a number that is not finite fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        if name not in checks:
            continue
        limit = checks[name]["limit"]
        good = bool(np.isfinite(value)) and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
