"""The port's in-process tracer (``repro_torch.core.hext.tracing``) and the
benchmark's readers of it.

(a) with no profiler recording, a span records nothing;
(b) under ``torch.profiler``, host spans nest with the right parents and
    counts, their stamps fall within 0.5 ms of the profiler's own CPU
    event of the same range, and no device-typed event carries a
    ``hext.*`` name;
(c) a CPU fleet's ``counters()`` and ``replace_hart()`` leave their
    spans, the latter with the batch's bytes;
(d) the captured tick's stage spans, with stand-in timing events on the
    CPU: every stage with its parent, the walks' two intervals summed, the
    mean over ``ips`` ticks, no sample of a replay still running;
(e) each of the five readers under ``portbench/metrics`` returns None on
    an empty report (and without the tracer) and its value on a planted
    report;
(f) on the card (marker ``cuda``): the stage table of a captured tick,
    its top-level stages summing to ``hext.tick`` within 1 %, and
    ``hext.tick`` within 10 % of a replay timed with CUDA events.
"""
import importlib
import sys
import time

import pytest
import torch

from repro_torch.core.hext import engine, programs, tracing
from repro_torch.core.hext.sim import Fleet, HartState

CPU = [torch.profiler.ProfilerActivity.CPU]
TOP = ("hext.interrupts", "hext.fetch", "hext.execute", "hext.retire",
       "hext.graph.copy_back")
PARENTS = {"hext.tick": None, **{n: "hext.tick" for n in TOP},
           "hext.fetch_walk": "hext.fetch",
           "hext.data_walk": "hext.execute", "hext.system": "hext.execute",
           "hext.trap": "hext.retire", "hext.retire.store": "hext.retire"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


def _wl(name):
    return next(w for w in programs.WORKLOADS if w.name == name)


def _pair():
    return Fleet.boot([_wl("sha"), _wl("fft")], guest=[False, True],
                      device="cpu")


def test_a_span_records_nothing_with_the_profiler_off():
    assert not tracing.enabled()
    fleet = _pair()
    with tracing.span("hext.outer") as sp:
        sp.nbytes += 8
        fleet.run(4, chunk=2).counters()
        fleet.replace_hart(0, fleet[1])
    assert tracing.report() == {"spans": {}, "stages": {}}
    assert len(tracing.TRACER.recent) == 0


def test_spans_nest_with_parents_and_counts():
    with torch.profiler.profile(activities=CPU):
        assert tracing.enabled()
        with tracing.span("hext.a"):
            for _ in range(3):
                with tracing.span("hext.b") as sp:
                    sp.nbytes += 5
                    with tracing.span("hext.c"):
                        pass
        with tracing.span("hext.b"):
            pass
    spans = tracing.report()["spans"]
    assert {k: (v["parent"], v["count"], v["bytes"])
            for k, v in spans.items()} == {
        "hext.a": (None, 1, 0), "hext.b": ("hext.a", 4, 15),
        "hext.c": ("hext.b", 3, 0)}
    assert all(v["device_count"] == 0 for v in spans.values())
    parents = [(n, p) for n, p, _, _ in tracing.TRACER.recent]
    assert parents == [("hext.c", "hext.b"), ("hext.b", "hext.a")] * 3 + [
        ("hext.a", None), ("hext.b", None)]
    a = [r for r in tracing.TRACER.recent if r[0] == "hext.a"][0]
    assert all(a[2] <= r[2] <= r[3] <= a[3] for r in tracing.TRACER.recent
               if r[1] is not None)


def test_stamps_meet_the_profilers_clock_on_its_cpu_timeline_only():
    with torch.profiler.profile(activities=CPU) as prof:
        with tracing.span("hext.sleep"):
            torch.ones(64).sum()
            time.sleep(0.003)
    (name, _, t0, t1), = tracing.TRACER.recent
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ev = [e for e in prof.events() if e.name == "hext.sleep"]
    assert len(ev) == 1
    assert ev[0].device_type == torch.autograd.DeviceType.CPU
    assert abs(start_ns + ev[0].time_range.start * 1e3 - t0) < 0.5e6
    assert abs(start_ns + ev[0].time_range.end * 1e3 - t1) < 0.5e6
    assert not [e.name for e in prof.events()
                if e.name.startswith("hext.")
                and e.device_type != torch.autograd.DeviceType.CPU]


def test_fleet_counters_and_replace_hart_leave_their_spans():
    fleet = _pair()
    batch = sum(t.nbytes for t in _leaves(fleet.harts.unwrap().to_raw()))
    with torch.profiler.profile(activities=CPU):
        fleet.counters()
        fleet.replace_hart(1, fleet[0])
        fleet.replace_hart(0, fleet[1])
    spans = tracing.report()["spans"]
    c, r = spans["hext.fleet.counters"], spans["hext.fleet.replace_hart"]
    assert (c["count"], c["parent"], c["host_ms"] > 0) == (1, None, True)
    assert (r["count"], r["bytes"]) == (2, 2 * batch)
    assert r["device_count"] == 0              # no card, no device ms


def _leaves(raw):
    for v in raw.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


class _Event:
    """A stand-in for a timing event in a graph, stamped on the host
    clock when the span reaches it."""

    def __init__(self, cap=None):
        self.ns = time.perf_counter_ns()

    def query(self):
        return self.ns is not None

    def elapsed_time(self, end):
        return (end.ns - self.ns) / 1e6


@pytest.mark.parametrize("ips", [1, 2])
def test_stage_spans_of_a_capture_make_the_stage_table(monkeypatch, ips):
    monkeypatch.setattr(tracing, "_mark", _Event)
    raw = HartState.stack([HartState.boot(_wl("fft"), guest=g, device="cpu")
                           for g in (False, True)]).to_raw()
    cap = tracing.Capture(ips)
    with torch.no_grad(), cap:
        engine._tick_body(raw, ips)
    names = [n for n, _, _, _ in cap.stages]
    # per tick one span a stage, but two intervals of each walk (the
    # gated walk and its TLB fill)
    for n in PARENTS:
        want = 1 if n in ("hext.tick", "hext.graph.copy_back") else ips
        if n in ("hext.fetch_walk", "hext.data_walk"):
            want *= 2
        assert names.count(n) == want, n
    assert {n: p for n, p, _, _ in cap.stages} == PARENTS
    assert names[-1] == "hext.tick"
    assert tracing.report()["stages"] == {}
    tracing.TRACER.sample(cap)
    tracing.TRACER.sample(cap)                     # a second replay
    stages = tracing.report()["stages"]
    assert {n: (s["parent"], s["samples"]) for n, s in stages.items()} == \
        {n: (p, 2) for n, p in PARENTS.items()}
    walk = sum(e0.elapsed_time(e1) for n, _, e0, e1 in cap.stages
               if n == "hext.fetch_walk")
    assert stages["hext.fetch_walk"]["ms"] == pytest.approx(walk / ips)
    tick = stages["hext.tick"]["ms"]
    top = sum(stages[n]["ms"] for n in TOP)
    assert 0 < top <= tick


def test_a_replay_still_running_is_no_sample(monkeypatch):
    monkeypatch.setattr(tracing, "_mark", _Event)
    cap = tracing.Capture(1)
    with cap, tracing.span("hext.tick"):
        pass
    e1 = cap.stages[-1][3]
    e1.ns = None                                   # not yet done
    tracing.TRACER.sample(cap)
    assert tracing.report()["stages"] == {}
    e1.ns = time.perf_counter_ns()
    tracing.TRACER.sample(cap)
    assert tracing.report()["stages"]["hext.tick"]["samples"] == 1


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

def _span(count, host_ms, device_count, device_ms):
    return {"parent": None, "count": count, "host_ms": host_ms,
            "device_count": device_count, "device_ms": device_ms,
            "bytes": 0}


STAGE_MS = {"hext.tick": 10.5, "hext.interrupts": 0.1, "hext.fetch": 2.0,
            "hext.execute": 4.0, "hext.retire": 3.0,
            "hext.graph.copy_back": 1.5, "hext.fetch_walk": 1.25,
            "hext.data_walk": 0.75, "hext.system": 0.5, "hext.trap": 0.25,
            "hext.retire.store": 2.5}
PLANTED = {
    "spans": {"hext.fleet.counters": _span(2, 600.0, 0, 0.0),
              "hext.fleet.replace_hart": _span(4, 2.0, 4, 6.4)},
    "stages": {n: {"parent": PARENTS[n], "samples": 2, "ms": ms}
               for n, ms in STAGE_MS.items()}}
READERS = {"tick_graph_ms": 10.5, "tick_copy_ms": 2.5 + 1.5,
           "tick_walk_ms": 1.25 + 0.75, "counters_read_ms": 300.0,
           "refill_ms_per_job": 1.6}


def _reader(name):
    return importlib.import_module(f"portbench.metrics.{name}").read


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_from_an_empty_report(name):
    assert _reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_the_tracer(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "repro_torch.core.hext.tracing", None)
    assert _reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_a_planted_report(monkeypatch, name):
    monkeypatch.setattr(tracing, "report", lambda: PLANTED)
    assert _reader(name)({}) == pytest.approx(READERS[name])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_stage_table_of_a_captured_tick_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (timing events inside a graph)")
    dev = torch.device("cuda")
    fleet = Fleet.boot(list(programs.WORKLOADS) * 4, guest=True, device=dev)
    fleet.run(8, chunk=8)           # captures the graph, replays untraced
    g = engine.CapturedTicks(fleet.harts.unwrap().to_raw(), 1)
    reps = 50
    for _ in range(5):
        g.replay()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    plain = e0.elapsed_time(e1) / reps
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fleet.run(16, chunk=16)
        fleet.counters()
        fleet.replace_hart(0, fleet[1])
        torch.cuda.synchronize()
    rep = tracing.report()
    stages = rep["stages"]
    assert {n: s["parent"] for n, s in stages.items()} == PARENTS
    # one sample: the untraced replay before the traced run
    assert stages["hext.tick"]["samples"] == 1
    tick = stages["hext.tick"]["ms"]
    top = sum(stages[n]["ms"] for n in TOP)
    assert abs(top - tick) <= 0.01 * tick, (top, tick)
    assert abs(tick - plain) <= 0.1 * plain, (tick, plain)
    r = rep["spans"]["hext.fleet.replace_hart"]
    assert r["device_count"] == 1 and r["device_ms"] > 0
    assert not [e.name for e in prof.events()
                if e.name.startswith("hext.")
                and e.device_type != torch.autograd.DeviceType.CPU]
