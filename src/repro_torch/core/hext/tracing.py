"""In-process spans of the hext fleet, on while a ``torch.profiler`` records.

    from repro_torch.core.hext import tracing
    fleet.run(512, chunk=512)
    with torch.profiler.profile(activities=[CPU, CUDA]):
        fleet.run(8, chunk=8)
        fleet.counters()
    tracing.report()

Tracing is on exactly while a profiler is recording
(``torch.autograd.profiler._is_profiler_enabled``); there is no other
switch.  Off, :func:`span` costs one check and records nothing.

Two kinds of span:

* **host spans** (:func:`span` outside a capture, profiler on): name,
  start and end on the profiler's clock (``time.time_ns``), the
  enclosing span, an optional byte count and, with ``device=`` a CUDA
  device, the device ms between two timing events on the current stream.
  Each also opens a ``_RecordFunctionFast`` range, which the profiler
  shows on its CPU timeline only (a ``record_function`` range would get a
  copy on the device timeline, counted there as device work).
* **stage spans** (:func:`span` while a :class:`Capture` is open, whether
  or not a profiler records): a timing event at each end, recorded *into*
  the CUDA graph being captured (``external=True``: event-record nodes),
  so every replay times each stage again.  Each event sits on a side
  branch of the graph that waits for the work before it, and nothing
  waits for the event, so the tick's kernels run as without it.  The
  stage table samples replays made while tracing was off: on the H100 the
  profiler's device tracing stretched a replay of the tick from 10.2 ms
  to 11.0–24.5 ms.

Device times are read lazily: a host span's event pair once ``query()``
says it is done (at a later span or at :func:`report`), a graph's stage
events after the run loop's own read has waited for the replay; never by
a sync of their own.  One tracer per process (:data:`TRACER`).
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["Tracer", "Capture", "TRACER", "span", "report", "reset",
           "enabled"]

# finished host spans kept whole (name, parent, start_ns, end_ns); the
# aggregates count every span
RECENT = 4096


def enabled() -> bool:
    """True while a ``torch.profiler`` records."""
    return _autograd_profiler._is_profiler_enabled


def _timing_event():
    return torch.cuda.Event(enable_timing=True)


def _mark(cap: "Capture"):
    """A timing event recorded into the graph being captured, on a side
    branch that waits for the work enqueued so far."""
    if cap.side is None:
        cap.side = torch.cuda.Stream()
    cap.side.wait_stream(torch.cuda.current_stream())
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record(cap.side)
    return ev


class _Off:
    """The span a caller gets while tracing is off: records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def nbytes(self) -> int:
        return 0

    @nbytes.setter
    def nbytes(self, value) -> None:
        pass


_OFF = _Off()


class _HostSpan:
    __slots__ = ("name", "device", "nbytes", "parent", "_rf", "_t0", "_e0")

    def __init__(self, name: str, device):
        self.name, self.device, self.nbytes = name, device, 0

    def __enter__(self):
        t = TRACER
        t._resolve()
        self.parent = t._stack[-1] if t._stack else None
        t._stack.append(self.name)
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        self._e0 = None
        if self.device is not None:
            self._e0 = _timing_event()
            self._e0.record(torch.cuda.current_stream(self.device))
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        pair = None
        if self._e0 is not None:
            e1 = _timing_event()
            e1.record(torch.cuda.current_stream(self.device))
            pair = (self._e0, e1)
        self._rf.__exit__(None, None, None)
        t = TRACER
        t._stack.pop()
        t._finish(self.name, self.parent, self._t0, t1, pair, self.nbytes)
        return False


class _StageSpan:
    __slots__ = ("name", "cap", "_e0")

    def __init__(self, name: str, cap: "Capture"):
        self.name, self.cap = name, cap

    def __enter__(self):
        self._e0 = _mark(self.cap)
        self.cap._stack.append(self.name)
        return self

    def __exit__(self, *exc):
        e1 = _mark(self.cap)
        stack = self.cap._stack
        stack.pop()
        self.cap.stages.append((self.name, stack[-1] if stack else None,
                                self._e0, e1))
        return False


class Capture:
    """Open while a CUDA graph is captured: every :func:`span` inside
    records a timing event into the graph at each of its ends.  ``stages``
    lists (name, parent, start event, end event) in the order the spans
    closed; the events outlive the graph.  On leaving, the side branch
    that holds the events joins the capturing stream."""

    def __init__(self, ips: int = 1):
        self.ips = int(ips)
        self.stages: List[Tuple[str, Optional[str], Any, Any]] = []
        self.side = None
        self._stack: List[str] = []

    def __enter__(self):
        if TRACER._capture is not None:
            raise RuntimeError("a capture is already open")
        TRACER._capture = self
        return self

    def __exit__(self, *exc):
        TRACER._capture = None
        if self.side is not None:
            torch.cuda.current_stream().wait_stream(self.side)
        return False


def span(name: str, device=None):
    """A span named ``name`` (a context manager; ``as sp`` gives an object
    whose ``nbytes`` the caller may add to).  ``device``: the CUDA device
    whose current stream the span's device ms are timed on (host spans);
    None times nothing on the device."""
    cap = TRACER._capture
    if cap is not None:
        return _StageSpan(name, cap)
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if device is not None and torch.device(device).type != "cuda":
        device = None
    return _HostSpan(name, device)


class Tracer:
    """Spans and stage samples of one process (module docstring)."""

    def __init__(self):
        self._capture: Optional[Capture] = None
        self.reset()

    def reset(self) -> None:
        """Forget every span and sample (a capture in progress stays)."""
        self._stack: List[str] = []
        self.recent: collections.deque = collections.deque(maxlen=RECENT)
        self._spans: Dict[str, Dict[str, Any]] = {}
        self._pending: List[Tuple[str, Any, Any]] = []
        self._stages: Dict[str, Dict[str, Any]] = {}

    # -- host spans ---------------------------------------------------------
    def _finish(self, name, parent, t0, t1, pair, nbytes) -> None:
        self.recent.append((name, parent, t0, t1))
        agg = self._spans.get(name)
        if agg is None:
            agg = self._spans[name] = {
                "parent": parent, "count": 0, "host_ms": 0.0,
                "device_count": 0, "device_ms": 0.0, "bytes": 0}
        agg["count"] += 1
        agg["host_ms"] += (t1 - t0) / 1e6
        agg["bytes"] += int(nbytes)
        if pair is not None:
            self._pending.append((name,) + pair)

    def _resolve(self) -> None:
        """Read every host span's event pair that the card has finished."""
        if not self._pending:
            return
        left = []
        for name, e0, e1 in self._pending:
            if e1.query():
                agg = self._spans[name]
                agg["device_count"] += 1
                agg["device_ms"] += e0.elapsed_time(e1)
            else:
                left.append((name, e0, e1))
        self._pending = left

    # -- the stage table ----------------------------------------------------
    def sample(self, cap: Capture) -> None:
        """One sample of the stage table: ``cap``'s events as its graph's
        latest replay left them.  The run loop calls it, while tracing is
        on, once its own read has waited for that replay, and only for a
        replay made with tracing off; a replay still running is skipped."""
        if not cap.stages or not cap.stages[-1][3].query():
            return
        ms: Dict[str, float] = collections.defaultdict(float)
        for name, parent, e0, e1 in cap.stages:
            ms[name] += e0.elapsed_time(e1)
            self._stages.setdefault(name, {"parent": parent, "samples": 0,
                                           "ms_sum": 0.0})
        for name, v in ms.items():
            st = self._stages[name]
            st["samples"] += 1
            st["ms_sum"] += v / cap.ips

    def report(self) -> Dict[str, Any]:
        """``spans``: per host-span name its parent, count, summed host ms,
        the count and sum of its device ms, and its bytes.  ``stages``: the
        tick's stage table, per stage its parent and its device ms a tick
        (the mean over the samples; a stage that runs more than once in a
        tick, as the walks with their fills, is summed first)."""
        self._resolve()
        stages = {name: {"parent": st["parent"], "samples": st["samples"],
                         "ms": st["ms_sum"] / st["samples"]}
                  for name, st in self._stages.items()}
        return {"spans": {k: dict(v) for k, v in self._spans.items()},
                "stages": stages}


TRACER = Tracer()


def report() -> Dict[str, Any]:
    """:meth:`Tracer.report` of the process's tracer."""
    return TRACER.report()


def reset() -> None:
    """Forget every span and sample of the process's tracer."""
    TRACER.reset()
