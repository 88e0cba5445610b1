"""Tracing / profiling hooks (port of ``tol_tpu/utils/profiling.py``).

``trace`` wraps ``torch.profiler`` and writes a Chrome trace (open it in
Perfetto or ``chrome://tracing``); ``stage_timer`` gives cheap wall-clock
stage accounting that waits for the device work of the tensors it is
told to block on.

The program's own spans
-----------------------
The solve path opens named spans (:func:`span`) at its layer boundaries
and around the regions of a Newton step (:data:`REGIONS`).  They record
nothing until :func:`recording` switches the one :class:`Recorder` on:
then each span is a ``torch.profiler.record_function`` range (so a
profiler session, and ``trace``'s Chrome trace, shows the program's
names) and a record in memory (name, parent, request, start and end on
``time.perf_counter_ns``).  A captured step program's replays are timed
by CUDA events from a reused pool (:func:`replay`), read only at a host
sync the loop makes anyway (:func:`synced_int`) and placed on the host's
clock there, so host spans and device intervals share one clock.
:meth:`Recorder.summary` puts each part of a gap between replays down to
the innermost span open on the host through it; :func:`step_regions` splits
one eager step's device time by region.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import Counter
from typing import Callable, Dict, Optional

import torch
from torch.utils._pytree import tree_leaves

# A span of one of these names starts a request: every span under it
# carries its request id.
REQUEST_SPANS = ("batch.solve", "mission.leg")
# The regions of one Newton step (solver/alm.py ``substep``,
# solver/kkt_condensed.py ``kkt_prepare``); each opens once per substep,
# ``step.dual_refine`` (inside ``step.update``) only where the step runs
# the least-squares dual refinement (``dual_refine_k`` > 0), and
# ``wind.grid`` (models/wind.py, the gridded field's interpolation) inside
# whichever region evaluates wind model 3, once per evaluation.
REGIONS = ("step.residuals", "kkt.blocks", "kkt.condense", "kkt.chain",
           "kkt.solve", "step.armijo", "step.update", "step.dual_refine",
           "wind.grid")
NO_SPAN = "(no span)"

_recorder: Optional["Recorder"] = None   # switched on by recording()
_OFF = contextlib.nullcontext()          # every span while it is off


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the body with ``torch.profiler`` (CPU activity, plus CUDA
    activity when a CUDA device is present) and write its Chrome trace to
    ``logdir/trace_<pid>_<ns>.json``.  The recorder is on for the body, so
    the trace carries the program's span names.  Yields the profile, whose
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
    with prof, recording():
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

    def _add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def __call__(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self._add(name, time.perf_counter() - t0)

    def report(self) -> str:
        lines = [f"{k}: {v:.3f}s over {self.counts[k]} calls"
                 for k, v in sorted(self.totals.items())]
        return "\n".join(lines)


class Recorder(stage_timer):
    """What the program's spans and replays recorded while it was on (see
    the module docstring).  Its span totals and counts by name are
    ``stage_timer``'s table.

    ``spans``: ``[name, parent index, request id, start ns, end ns]`` in
    the order they opened; ``intervals``: ``(program, start ns, end ns)``
    of each timed replay on the host's clock; ``replays``: replays by
    program name; ``counters``: what :func:`count` added, by name;
    ``window``: the recording's start and end."""

    def __init__(self):
        super().__init__()
        self.spans: list = []
        self.intervals: list = []
        self.replays: Counter = Counter()
        self.counters: Counter = Counter()
        self.window = [time.perf_counter_ns(), None]
        self._stack: list = []
        self._requests = 0
        self._pending: list = []     # (program, start event, end event)
        self._pool: list = []        # events free for reuse

    # -- spans ------------------------------------------------------------
    def _open(self, name: str) -> int:
        parent = self._stack[-1] if self._stack else None
        request = self.spans[parent][2] if parent is not None else None
        if request is None and name in REQUEST_SPANS:
            self._requests += 1
            request = self._requests
        self.spans.append([name, parent, request, time.perf_counter_ns(), None])
        self._stack.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def _close(self, i: int) -> None:
        rec = self.spans[i]
        rec[4] = time.perf_counter_ns()
        self._stack.pop()
        self._add(rec[0], (rec[4] - rec[3]) * 1e-9)

    # -- device intervals -------------------------------------------------
    def _event(self):
        return (self._pool.pop() if self._pool
                else torch.cuda.Event(enable_timing=True))

    def _place(self, anchor, t_ns: int) -> None:
        """Put every pending replay on the host's clock: ``anchor`` was
        recorded after them and had completed by ``t_ns``."""
        for program, e0, e1 in self._pending:
            self.intervals.append(
                (program, t_ns - round(e0.elapsed_time(anchor) * 1e6),
                 t_ns - round(e1.elapsed_time(anchor) * 1e6)))
            self._pool += (e0, e1)
        self._pool.append(anchor)
        self._pending.clear()

    def _flush(self) -> None:
        if self._pending:
            anchor = self._event()
            anchor.record()
            anchor.synchronize()
            self._place(anchor, time.perf_counter_ns())

    # -- the report -------------------------------------------------------
    def summary(self) -> dict:
        """The recording as host numbers: its wall seconds, the union of
        the replays' device intervals (``replay_s``), the gaps between
        them and at the window's two edges in seconds by the innermost
        span open on the host through each part of a gap
        (:func:`split_gaps`), replays by program, the counters, and each
        span name's count, total and self seconds (self: less the time its
        child spans cover)."""
        t0, t1 = self.window
        t1 = t1 if t1 is not None else time.perf_counter_ns()
        busy, gaps = _union_and_gaps(
            [(s, e) for _, s, e in self.intervals], t0, t1)
        spans = [(s[3], s[4] if s[4] is not None else t1, s[0])
                 for s in self.spans]
        child = Counter()
        for s, (start, end, _) in zip(self.spans, spans):
            if s[1] is not None:
                child[s[1]] += end - start
        self_ns = Counter()
        for i, (start, end, name) in enumerate(spans):
            self_ns[name] += end - start - child[i]
        return dict(
            window_s=(t1 - t0) * 1e-9, replay_s=busy * 1e-9,
            gaps={k: v * 1e-9 for k, v in split_gaps(spans, gaps).items()},
            replays=dict(self.replays), counters=dict(self.counters),
            spans={k: dict(n=self.counts[k], total_s=self.totals[k],
                           self_s=self_ns[k] * 1e-9)
                   for k in sorted(self.totals)},
            requests=self._requests)


class _Span:
    __slots__ = ("rec", "name", "rf", "i")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.i = self.rec._open(self.name)

    def __exit__(self, *exc):
        self.rec._close(self.i)
        self.rf.__exit__(*exc)


class _Replay(_Span):
    """The ``alm.replay`` span; a graph replay between two timing events.
    The program is named by its caller's span, the innermost one open,
    and its lane count: ``batch.dive[128]``, ``mission.slice[128]``."""

    __slots__ = ("program", "timed", "e0")

    def __init__(self, rec: Recorder, lanes: int, timed: bool):
        super().__init__(rec, "alm.replay")
        caller = rec.spans[rec._stack[-1]][0] if rec._stack else "alm.solve"
        self.program, self.timed = f"{caller}[{lanes}]", timed

    def __enter__(self):
        super().__enter__()
        self.rec.replays[self.program] += 1
        if self.timed:
            self.e0 = self.rec._event()
            self.e0.record()

    def __exit__(self, *exc):
        if self.timed:
            e1 = self.rec._event()
            e1.record()
            self.rec._pending.append((self.program, self.e0, e1))
        super().__exit__(*exc)


def span(name: str):
    """A named span of the program: a shared no-op context while the
    recorder is off, else a ``record_function`` range recorded in memory."""
    rec = _recorder
    return _OFF if rec is None else _Span(rec, name)


def count(name: str, n: int) -> None:
    """Add ``n`` (a host number, never read from a tensor) to the
    recorder's counter ``name``; nothing while the recorder is off."""
    rec = _recorder
    if rec is not None:
        rec.counters[name] += n


def replay(lanes: int, timed: bool):
    """The span of one step of a step program of ``lanes`` lanes; ``timed``:
    a CUDA graph replay, whose device interval the recorder takes by two
    events (never call it with ``timed`` under a capture)."""
    rec = _recorder
    return _OFF if rec is None else _Replay(rec, lanes, timed)


def synced_int(x: torch.Tensor) -> int:
    """``int(x)``, a host sync.  With the recorder on, the replays timed
    before it are placed on the host's clock by an event recorded just
    before the sync."""
    rec = _recorder
    if rec is None or not rec._pending:
        return int(x)
    anchor = rec._event()
    anchor.record()
    n = int(x)
    rec._place(anchor, time.perf_counter_ns())
    return n


@contextlib.contextmanager
def recording():
    """Switch the recorder on for the body and yield it, fresh (it was
    cleared on entry).  On exit replays not yet placed are placed (one
    sync, after the window closed)."""
    global _recorder
    outer, rec = _recorder, Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        rec.window[1] = time.perf_counter_ns()
        _recorder = outer
        rec._flush()


def _union_and_gaps(intervals, t0: int, t1: int):
    """Union length of ``intervals`` clipped to [t0, t1], and the gaps
    between them and at the two edges, as [(start, end)]."""
    busy, gaps, cur = 0, [], t0
    for s, e in sorted(intervals):
        s, e = max(s, t0), min(e, t1)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
        busy += e - max(s, cur)
        cur = e
    if t1 > cur:
        gaps.append((cur, t1))
    return busy, gaps


def split_gaps(spans, gaps) -> Counter:
    """Gap lengths ``[(start, end)]`` divided among ``spans`` ``[(start,
    end, name)]`` (one thread's, so they nest): each part of a gap goes to
    the innermost span open on the host through it, :data:`NO_SPAN` where
    none is.  So a gap that runs from one stage's tail into the next
    stage's set-up is shared between them."""
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    out, stack, t, j = Counter(), [], -math.inf, 0
    gaps = sorted(gaps)
    for when, opens, i in marks + [(math.inf, 0, None)]:
        # [t, when): the innermost open span is stack[-1]
        while j < len(gaps) and gaps[j][0] < when:
            a, b = max(gaps[j][0], t), min(gaps[j][1], when)
            if b > a:
                out[spans[stack[-1]][2] if stack else NO_SPAN] += b - a
            if gaps[j][1] <= when:
                j += 1
            else:
                break
        t = when
        if i is None:
            break
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    return out


def innermost(spans, points) -> Counter:
    """Weights ``[(time, weight)]`` summed by the innermost of ``spans``
    ``[(start, end, name)]`` (one thread's, so they nest) open at each
    time; :data:`NO_SPAN` where none is."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = Counter(), [], 0
    for t, w in sorted(points):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[stack[-1][2] if stack else NO_SPAN] += w
    return out


def attribute_kernels(events, regions=REGIONS) -> dict:
    """Device operations of profiler ``events`` by the innermost region
    span open on the host when each was launched: ``{region: {"ms",
    "kernels"}}``, with ``"unattributed"`` for operations launched outside
    every region, and ``"unlinked"``, the operations among them whose
    launch was not found.  An operation's launch is the CUDA runtime call
    with its correlation id, else the operator its
    ``linked_correlation_id`` names."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    runtime = {e.id: e.time_range.start for e in cpu if e.name.startswith("cu")}
    ops = {e.id: e.time_range.start for e in cpu if not e.name.startswith("cu")}
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
             if e.name in regions]
    launches, unlinked = [], 0
    for e in events:
        # a range's projection on the device timeline is no operation
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False) or e.name in regions:
            continue
        t = runtime.get(e.id, ops.get(getattr(e, "linked_correlation_id", 0)
                                      or -1))
        if t is None:
            unlinked += 1
            t = float("-inf")
        launches.append((t, e.time_range.end - e.time_range.start))
    us = innermost(spans, launches)
    n = innermost(spans, [(t, 1) for t, _ in launches])
    out = {r: dict(ms=us[r] * 1e-3, kernels=n[r]) for r in regions}
    out["unattributed"] = dict(ms=us[NO_SPAN] * 1e-3, kernels=n[NO_SPAN])
    out["unlinked"] = unlinked
    return out


def step_regions(steps: Dict[str, Callable[[], None]]) -> dict:
    """Run each of ``steps`` (name -> one eager solver step on a CUDA
    device) once, in a profiler session of its own with the recorder on,
    and split its device time by region (:func:`attribute_kernels`); the
    recorder's counters of the step are added as numbers beside the
    regions."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, step in steps.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with recording() as rec:
                step()
                torch.cuda.synchronize()
        out[name] = {**attribute_kernels(prof.events()), **rec.counters}
    return out
