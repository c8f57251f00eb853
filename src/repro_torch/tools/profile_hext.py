"""Where the time of the port's hext tick goes on the card.

    PYTHONPATH=src python -m repro_torch.tools.profile_hext \\
        [--engine eager|graph] [--ips N] [--ticks 64]

Boots the 10-hart fleet of ``chip_smoke.py`` (sha, crc32, basicmath,
stringsearch, fft × {native, guest}) on CUDA, steps it past boot, then
times ``--ticks`` ticks on the chosen engine and traces them with
``torch.profiler``, and prints one JSON line:

* ``eager`` — ``step_batched`` with host gates: host ms per tick (under
  the profiler and, separately, without it);
* ``graph`` — ``--ips`` device-gated ticks captured as one CUDA graph
  (``engine.CapturedTicks``) and replayed: the capture seconds, host ms
  per tick spent enqueueing replays, and wall ms per tick;

and for both: device kernels per tick, the device's busy and idle share
over the traced window (union of kernel intervals over the span from the
first kernel start to the last kernel end; and the same busy time over
the unprofiled wall, since the tracer widens the gaps between a graph's
kernels), the kernels launched most
often, and the device µs a tick of each gated branch (fetch walk, data
walk, SYSTEM, trap): the kernels launched under its ``record_function``
span in ``--branch-ticks`` eagerly run ticks with the engine's gates (a
graph replay has no host spans).  Needs a CUDA device; the numbers are
the card's.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import torch

from repro_torch.core.hext import engine, machine, programs
from repro_torch.core.hext.sim import Fleet

WORKLOADS = ("sha", "crc32", "basicmath", "stringsearch", "fft")
BRANCHES = ("hext.fetch_walk", "hext.data_walk", "hext.system", "hext.trap")


def _boot(dev):
    by_name = {w.name: w for w in programs.WORKLOADS}
    wls = [by_name[n] for n in WORKLOADS]
    return Fleet.boot(wls * 2, guest=[False] * 5 + [True] * 5, device=dev,
                      engine="eager")


def _busy_share(kernels):
    """(busy µs, span µs) of the union of [start, end) intervals."""
    spans = sorted((k.time_range.start, k.time_range.end) for k in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def _profile(fn):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.events(), wall


def _kernels(events):
    """Device events, less the device-timeline copies of the branch spans
    (an annotation covers its launch gaps, so it is not busy time)."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in BRANCHES]


def _branch_us(events, ticks: int) -> dict:
    """Device µs and kernels a tick under each branch span: every CPU op
    inside a span's host interval contributes the kernels it launched."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    out = {}
    for name in BRANCHES:
        spans = [(e.time_range.start, e.time_range.end)
                 for e in cpu if e.name == name]
        us, n = 0.0, 0
        for e in cpu:
            if e.name in BRANCHES or not e.kernels:
                continue
            t = e.time_range.start
            if any(s <= t and e.time_range.end <= end for s, end in spans):
                us += sum(k.duration for k in e.kernels)
                n += len(e.kernels)
        out[name] = {"device_us_per_tick": us / ticks,
                     "kernels_per_tick": n / ticks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("eager", "graph"), default="eager")
    ap.add_argument("--ips", type=int, default=engine.GRAPH_IPS,
                    help="graph: ticks a replay advances")
    ap.add_argument("--ticks", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--branch-ticks", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_hext needs a CUDA device")
    if args.ticks % args.ips:
        raise SystemExit("--ips must divide --ticks")
    dev = torch.device("cuda", 0)

    fleet = _boot(dev).run(args.warmup, chunk=args.warmup)
    raw = fleet.harts.to_raw()
    torch.cuda.synchronize()
    out = {"device": torch.cuda.get_device_name(0), "engine": args.engine,
           "ticks": args.ticks}
    gates = "host" if args.engine == "eager" else "device"

    if args.engine == "eager":
        def window():
            r = raw
            for _ in range(args.ticks):
                r = machine.step_batched(r)
            return r

        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        out["host_ms_per_tick"] = \
            (time.perf_counter() - t0) * 1e3 / args.ticks
    else:
        g = engine.CapturedTicks(raw, args.ips)
        out["ips"] = args.ips
        out["capture_s"] = g.capture_s
        g.load(raw)

        def window():
            for _ in range(args.ticks // args.ips):
                g.replay()

        t0 = time.perf_counter()
        window()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out["host_ms_per_tick"] = host * 1e3 / args.ticks
        out["wall_ms_per_tick"] = \
            (time.perf_counter() - t0) * 1e3 / args.ticks
        g.load(raw)

    events, wall = _profile(window)
    out["wall_ms_per_tick_profiled"] = wall * 1e3 / args.ticks
    kernels = _kernels(events)
    out["kernels_per_tick"] = len(kernels) / args.ticks
    if kernels:
        busy, span = _busy_share(kernels)
        unprofiled = out.get("wall_ms_per_tick", out["host_ms_per_tick"])
        out.update({"device_busy_ms_per_tick": busy / args.ticks / 1e3,
                    "device_busy_share": busy / span,
                    "device_idle_share": 1.0 - busy / span,
                    # the tracer widens a graph's gaps: the same busy time
                    # against the unprofiled wall of the window
                    "device_idle_share_vs_unprofiled_wall":
                        1.0 - busy / args.ticks / 1e3 / unprofiled})
        per_name = collections.defaultdict(lambda: [0, 0.0])
        for k in kernels:
            per_name[k.name][0] += 1
            per_name[k.name][1] += k.time_range.end - k.time_range.start
        top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
        out["top_kernels"] = [
            {"kernel": name[:80], "per_tick": n / args.ticks,
             "us_per_tick": us / args.ticks} for name, (n, us) in top]

    def branch_window():
        r = raw
        with torch.no_grad():
            for _ in range(args.branch_ticks):
                r = machine.step_batched(r, gates=gates)

    branch_window()                   # warm the lazily built constants
    torch.cuda.synchronize()
    events, _ = _profile(branch_window)
    out["branches"] = _branch_us(events, args.branch_ticks)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
