"""Where the time of the port's hext tick goes on the card.

    PYTHONPATH=src python -m repro_torch.tools.profile_hext [--ticks 64]

Boots the 10-hart fleet of ``chip_smoke.py`` (sha, crc32, basicmath,
stringsearch, fft × {native, guest}) on CUDA, steps it past boot, then
traces ``--ticks`` ticks with ``torch.profiler`` and prints, as one JSON
line: host milliseconds per tick (under the profiler and, separately,
without it), device kernels per tick, the device's busy and idle share
over the traced window (union of kernel intervals over the window from
the first kernel start to the last kernel end), and the device kernels
launched most often.  Needs a CUDA device; the numbers are the card's.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import torch

from repro_torch.core.hext import machine, programs
from repro_torch.core.hext.sim import Fleet

WORKLOADS = ("sha", "crc32", "basicmath", "stringsearch", "fft")


def _boot(dev):
    by_name = {w.name: w for w in programs.WORKLOADS}
    wls = [by_name[n] for n in WORKLOADS]
    return Fleet.boot(wls * 2, guest=[False] * 5 + [True] * 5, device=dev)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_hext needs a CUDA device")
    dev = torch.device("cuda", 0)

    raw = _boot(dev).harts.to_raw()
    for _ in range(args.warmup):
        raw = machine.step_batched(raw)
    torch.cuda.synchronize()

    # the same window without the profiler, for the host cost per tick
    plain = dict(raw)
    t0 = time.perf_counter()
    for _ in range(args.ticks):
        plain = machine.step_batched(plain)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.ticks

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            raw = machine.step_batched(raw)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / args.ticks
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"device": torch.cuda.get_device_name(0), "ticks": args.ticks,
           "host_ms_per_tick": host_ms,
           "host_ms_per_tick_profiled": prof_ms,
           "kernels_per_tick": len(kernels) / args.ticks}
    if kernels:
        busy, span = _busy_share(kernels)
        out.update({"device_busy_us_per_tick": busy / args.ticks,
                    "device_busy_share": busy / span,
                    "device_idle_share": 1.0 - busy / span})
        per_name = collections.defaultdict(lambda: [0, 0.0])
        for k in kernels:
            per_name[k.name][0] += 1
            per_name[k.name][1] += k.time_range.end - k.time_range.start
        top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
        out["top_kernels"] = [
            {"kernel": name[:80], "per_tick": n / args.ticks,
             "us_per_tick": us / args.ticks} for name, (n, us) in top]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
