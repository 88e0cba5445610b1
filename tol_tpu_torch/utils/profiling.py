"""Tracing / profiling hooks (port of ``tol_tpu/utils/profiling.py``).

``trace`` wraps ``torch.profiler`` and writes a Chrome trace (open it in
Perfetto or ``chrome://tracing``); ``stage_timer`` gives cheap wall-clock
stage accounting that waits for the device work of the tensors it is
told to block on.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the body with ``torch.profiler`` (CPU activity, plus CUDA
    activity when a CUDA device is present) and write its Chrome trace to
    ``logdir/trace_<pid>_<ns>.json``.  Yields the profile, whose
    ``trace_path`` names the file once the body has run.  A no-op that
    yields None when ``logdir`` is None."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = None
    with prof:
        yield prof
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


def _synchronize(tree) -> None:
    """Wait for the CUDA devices that hold the tensors of ``tree`` (the
    counterpart of ``jax.block_until_ready``); CPU tensors need no wait."""
    devices = {x.device for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


class stage_timer:
    """Accumulating wall-clock stage timer.

        timer = stage_timer()
        with timer("solve", block_on=out):
            out = run(...)
        timer.report()

    ``block_on`` (any tree of tensors) is waited for before the clock
    stops."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{k}: {v:.3f}s over {self.counts[k]} calls"
                 for k, v in sorted(self.totals.items())]
        return "\n".join(lines)
