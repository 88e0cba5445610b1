"""The traced run's profiled slice, kept in memory and reduced to numbers.

A 128-lane step program replays 4,000-21,000 kernel nodes, so a whole
window under the profiler would be far too large.  The slice is bounded:
a few steps of each stage program on one group (batch mixes: dive,
endgame, drain, each run through the grouped solver's stage entry points,
host checks included), or a few whole legs (mission mixes; a leg is 48 or
more replays, each counted by the program).  Each stage is one
profiler session; from its events this module takes the device's busy
time (the union of its operations' intervals), the hand kernels' device
time and launches, the device operations by name, and the idle gaps
between device operations, each named by the innermost host operation
that spans it.
"""

from __future__ import annotations

import re
import time
from collections import Counter

import torch


def _names(symbol: str, key: str) -> bool:
    return re.search(rf"(?<!\w){symbol}(?!\w)", key) is not None


def _short(name: str) -> str:
    """A device operation's name without its return type and namespaces,
    cut to 120 characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(junk, "")
    return name[:120]


def _innermost(cpu, gaps):
    """For gaps [(mid, dur)], the innermost host operation spanning each
    mid (host events of one thread nest)."""
    cpu = sorted(cpu, key=lambda e: (e[0], -e[1]))
    gaps = sorted(gaps)
    out, stack, i = Counter(), [], 0
    for mid, dur in gaps:
        while i < len(cpu) and cpu[i][0] <= mid:
            while stack and stack[-1][1] < cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "(no host operation)"] += dur
    return out


def reduce_events(events, symbols: dict) -> dict:
    """Busy seconds, hand-kernel seconds and launches, device seconds by
    operation, idle seconds by host operation, from profiler events."""
    from torch.autograd import DeviceType

    dev, cpu_by_thread = [], {}
    for e in events:
        r = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((r.start, r.end, e.name))
        elif e.device_type == DeviceType.CPU:
            cpu_by_thread.setdefault(e.thread, []).append((r.start, r.end, e.name))
    dev.sort()
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((0.5 * (cur_e + s), s - cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    ops, hand, launches = Counter(), 0.0, Counter()
    for s, e, name in dev:
        ops[_short(name)] += (e - s) * 1e-6
        for k, sym in symbols.items():
            if _names(sym, name):
                hand += e - s
                launches[k] += 1
    main = max(cpu_by_thread.values(), key=len) if cpu_by_thread else []
    idle = _innermost(main, gaps)
    return dict(busy_s=busy * 1e-6, hand_s=hand * 1e-6,
                launches={k: launches[k] for k in symbols},
                ops=dict(ops), gaps={k: v * 1e-6 for k, v in idle.items()})


def profile(stages: dict, symbols: dict, device) -> dict:
    """Run each of ``stages`` (name -> (callable, steps)) once under the
    profiler; returns per stage its reduction, its steps (what the
    callable returns, where ``steps`` is None) and its host-clock
    seconds."""
    from torch.profiler import ProfilerActivity, profile as _profile

    out = {}
    for name, (run, steps) in stages.items():
        with _profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            ran = run()
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        out[name] = dict(reduce_events(prof.events(), symbols),
                         steps=ran if steps is None else steps, wall_s=wall)
    return out


def breakdown(sessions: dict) -> dict:
    """The ten device operations with the most time and the ten host
    operations that spanned the most idle device time, over the slice."""
    ops, gaps = Counter(), Counter()
    for s in sessions.values():
        ops.update(s["ops"])
        gaps.update(s["gaps"])
    return dict(device_ops=[[k, v] for k, v in ops.most_common(10)],
                idle_gaps=[[k, v] for k, v in gaps.most_common(10)])
