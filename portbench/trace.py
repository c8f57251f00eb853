"""The traced part of a ``--trace 1`` run, after the window has closed.

Two short runs of the fleet are traced with ``torch.profiler``, one of
``SHORT`` and one of ``LONG`` ticks, then one control round and one
refill.  A run
of the fleet also copies the state in and out once, so the per-tick
numbers are the differences of the two runs over ``LONG - SHORT`` ticks:
what is left is the captured tick alone.

* kernels a tick, and the sum of their device time a tick;
* the device's busy time a tick: the union of the kernel intervals, and
  a run's busy time besides its ticks (the state copied in and out);
* the card's busy time in the control round and in one refill;
* the counters' instructions and walks a tick (for the bytes a tick);
* the breakdown: the kernels that took most time in the long run and the
  control round, and the idle gaps between kernels there, summed by the
  innermost host operation running at the gap's midpoint.
"""
from __future__ import annotations

import collections
import heapq
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

SHORT, LONG = 8, 24
TOP = 10


def profile(fn: Callable[[], Any]) -> Tuple[List[Any], float]:
    """(the profiler's events, the traced wall seconds) of ``fn()``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return list(prof.events()), wall


def _kernels(events) -> List[Tuple[float, float, str]]:
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _merged(spans: List[Tuple[float, float, str]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e, _ in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _busy_us(kernels) -> float:
    return sum(e - s for s, e in _merged(kernels))


def _gaps(events, kernels) -> Dict[str, float]:
    """Idle µs between busy intervals, and before the first and after the
    last, by the innermost host operation running at each gap's
    midpoint."""
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU)
    out: Dict[str, float] = collections.defaultdict(float)
    # the traced span's own ends bound the first and the last gap
    t0 = min(h[0] for h in host)
    t1 = max(h[1] for h in host)
    busy = [[t0, t0]] + _merged(kernels) + [[t1, t1]]
    # midpoints rise, so a host op that has ended stays ended: a heap by
    # duration, whose expired tops are dropped, gives the innermost one
    live: List[Tuple[float, float, str]] = []
    nxt = 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        while nxt < len(host) and host[nxt][0] <= mid:
            hs, he, name = host[nxt]
            heapq.heappush(live, (he - hs, he, name))
            nxt += 1
        while live and live[0][1] < mid:
            heapq.heappop(live)
        out[live[0][2] if live else "host code outside any traced op"] += s1 - e0
    return out


def measure(sweep) -> Dict[str, Any]:
    """Trace the sweep's fleet (module docstring)."""
    def sums():
        cs = sweep.fleet.counters()
        return (sum(int(c.instret) for c in cs),
                sum(int(c.walks) for c in cs))

    ev_a, _ = profile(lambda: sweep.run(SHORT))
    i0, w0 = sums()
    ev_b, wall_b = profile(lambda: sweep.run(LONG))
    i1, w1 = sums()
    refilled = []
    ev_c, wall_c = profile(lambda: refilled.append(sweep.control()))
    # one refill alone: lane 0 spliced with its own state, which changes
    # nothing and costs what a refill costs
    again = sweep.fleet[0]
    ev_r, _ = profile(lambda: sweep.fleet.replace_hart(0, again))

    ka, kb, kc = _kernels(ev_a), _kernels(ev_b), _kernels(ev_c)
    ticks = LONG - SHORT
    refill_s = _busy_us(_kernels(ev_r)) / 1e6
    out: Dict[str, Any] = {
        "harts": sweep.harts,
        "instret_per_tick": (i1 - i0) / LONG,
        "walks_per_tick": (w1 - w0) / LONG,
        "busy_s": (_busy_us(kb) + _busy_us(kc)) / 1e6,
        "window_s": wall_b + wall_c,
        # the card's time in a control round without its refills (the
        # counters' copies), and in one refill (``replace_hart``'s clones)
        "control_busy_s": _busy_us(kc) / 1e6 - refilled[0] * refill_s,
        "refill_busy_s": refill_s,
    }
    if not kb:                     # no device trace (a CPU rehearsal)
        return out
    per_tick_us = (_busy_us(kb) - _busy_us(ka)) / ticks
    out.update({
        "kernels_per_tick": (len(kb) - len(ka)) / ticks,
        "kernel_ms_per_tick": (sum(e - s for s, e, _ in kb)
                               - sum(e - s for s, e, _ in ka)) / ticks / 1e3,
        "busy_ms_per_tick": per_tick_us / 1e3,
        # what a run of the fleet keeps the card busy with besides its
        # ticks: the state copied into the graph's buffers and out again
        "run_busy_s": (_busy_us(ka) - SHORT * per_tick_us) / 1e6,
    })
    by_name: Dict[str, float] = collections.defaultdict(float)
    for s, e, name in kb + kc:
        by_name[name[:120]] += (e - s) / 1e6
    gaps: Dict[str, float] = collections.defaultdict(float)
    for ev, k in ((ev_b, kb), (ev_c, kc)):
        for name, us in _gaps(ev, k).items():
            gaps[name[:120]] += us / 1e6
    out["breakdown"] = {
        "device_ops": [[n, s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n, s] for n, s in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }
    return out
