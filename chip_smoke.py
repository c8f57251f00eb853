#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root

Phases, one line each; any failure raises and the script exits non-zero:

1. environment — torch/CUDA versions and the card's name and power limit;
2. build       — every CUDA kernel of the port, from ``src/repro_torch/csrc``;
3. pagewalk    — the two-stage table walk at 8 tenants x 64 requests x 512
                 pages (G = 4096): its path (``ops.two_stage_translate``
                 over every page of every request once, shuffled) is driven
                 with the launch count set to 0 just before and read just
                 after; then the kernel is held bit-exact against the plain
                 version on the card at B in {1, 7, 512, 513, 262144} and
                 timed (CUDA events, median) beside its byte bound;
4. hext        — ``Fleet.boot`` of sha, crc32, basicmath, stringsearch and
                 fft x {native, guest} on the card (10 harts, 256 KiB each)
                 run to completion; every counter of every hart must equal
                 ``benchmarks/results/hext_runs.json`` (read, never written);
5. kernels     — one JSON line listing each ported kernel.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 2026
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)

# pagewalk at the realistic size of its docstring: 1 MiB stage-1 tables
T, R, P, G = 8, 64, 512, 4096
PAGEWALK_BATCHES = (1, 7, 512, 513, T * R * P)

HEXT_WORKLOADS = ("sha", "crc32", "basicmath", "stringsearch", "fft")
HEXT_FIELDS = ("done", "exit_code", "instret", "instret_virt", "ticks",
               "exc_by_level", "int_by_level", "pagefaults", "walks",
               "timer_irqs", "ctx_switches", "ok")
HEXT_MAX_TICKS = 4096
HEXT_CHUNK = 32


def phase(name: str, **kv) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, torch, iters: int = 50, warmup: int = 5,
              flush=None) -> float:
    """Median milliseconds of ``fn`` by CUDA events, one event pair per
    call; ``flush`` (untimed) runs before each call.  A ~1 ms device spin
    is queued ahead of each start event, so the pair times the device
    work and not the host's launch latency."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pagewalk_phase(torch, np, dev) -> dict:
    from repro_torch.kernels.pagewalk import kernel as K
    from repro_torch.kernels.pagewalk import ops
    from repro_torch.kernels.pagewalk.ref import two_stage_translate_ref

    rng = np.random.default_rng(SEED)
    vs = rng.integers(-1, G, size=(T, R, P), dtype=np.int32)
    perm = rng.integers(0, 4, size=(T, R, P), dtype=np.int32)
    g = rng.integers(-1, T * G, size=(T, G), dtype=np.int32)
    tables = [torch.as_tensor(x, device=dev) for x in (vs, perm, g)]

    def queries(b: int):
        if b == T * R * P:       # every page of every request, shuffled
            flat = rng.permutation(b)
            t, r, p = flat // (R * P), (flat // P) % R, flat % P
        else:
            t = rng.integers(0, T, b)
            r = rng.integers(0, R, b)
            p = rng.integers(0, P, b)
        w = rng.integers(0, 2, b).astype(bool)
        return [torch.as_tensor(x.astype(np.int32), device=dev)
                for x in (t, r, p)] + [torch.as_tensor(w, device=dev)]

    qs = {b: queries(b) for b in PAGEWALK_BATCHES}
    big = qs[T * R * P]

    # ---- the path: the entry point a user calls, counts read around it --
    K.two_stage_translate_kernel.launches = 0
    path_out = ops.two_stage_translate(*tables, *big[:3], big[3],
                                       device=dev)
    torch.cuda.synchronize()
    launches = K.two_stage_translate_kernel.launches
    if launches < 1:
        raise RuntimeError("pagewalk path ran without launching its kernel")

    # ---- kernel vs plain version on the card, bit-exact ------------------
    max_err = 0
    for b, q in qs.items():
        got = K.two_stage_translate_kernel(*tables, *q)
        want = two_stage_translate_ref(*tables, *q)
        torch.cuda.synchronize()
        for name, x, y in zip(("slot", "fault", "stage"), got, want):
            if not torch.equal(x, y):
                raise RuntimeError(f"pagewalk B={b}: {name} differs from "
                                   f"the plain version")
            max_err = max(max_err, int((x.long() - y.long()).abs().max()))
        phase("pagewalk", B=b, bit_exact=True)
    for x, y in zip(path_out, two_stage_translate_ref(*tables, *big)):
        if not torch.equal(x, y):
            raise RuntimeError("pagewalk path output differs from the "
                               "plain version")

    # ---- time at the path's shape, L2 flushed before every call ----------
    scratch = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    k_ms = time_cuda(lambda: K.two_stage_translate_kernel(*tables, *big),
                     torch, flush=flush)
    k_warm_ms = time_cuda(lambda: K.two_stage_translate_kernel(*tables, *big),
                          torch)
    plain_ms = time_cuda(lambda: two_stage_translate_ref(*tables, *big),
                         torch, flush=flush)
    # bytes this run's data needs: coordinates in (3 x int32 + bool), results
    # out (int32 + bool + int32), each touched stage-1 entry of both tables,
    # each touched stage-2 entry
    t, r, p, w = (x.long() for x in big)
    flat1 = (t * R + r) * P + p
    s1 = two_stage_translate_ref(*tables, *big)[2] == 1
    tp = tables[0].view(-1)[flat1].clamp(0, G - 1)
    n1 = int(torch.unique(flat1).numel())
    n2 = int(torch.unique((t * G + tp)[~s1]).numel())
    b = big[0].numel()
    nbytes = b * (3 * 4 + 1) + b * (4 + 1 + 4) + n1 * 2 * 4 + n2 * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    phase("pagewalk", B=b, kernel_us=f"{k_ms * 1e3:.2f}",
          kernel_warm_l2_us=f"{k_warm_ms * 1e3:.2f}",
          plain_us=f"{plain_ms * 1e3:.2f}", bytes=nbytes,
          bound_us=f"{bound_ms * 1e3:.3f}", launches=launches)
    return {"name": "pagewalk", "route": "cuda",
            "source": "src/repro_torch/csrc/pagewalk.cu",
            "replaces": "src/repro/kernels/pagewalk/kernel.py:53",
            "launches": launches, "max_abs_err": max_err, "ms": k_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}


def hext_phase(torch, dev) -> None:
    from repro_torch.core.hext import programs
    from repro_torch.core.hext.sim import Fleet
    from repro_torch.kernels.pagewalk import kernel as K

    golden = json.loads((ROOT / "benchmarks/results/hext_runs.json")
                        .read_text())["workloads"]
    by_name = {w.name: w for w in programs.WORKLOADS}
    wls = [by_name[n] for n in HEXT_WORKLOADS]
    fleet = Fleet.boot(wls * 2, guest=[False] * len(wls) + [True] * len(wls),
                       device=dev)
    torch.cuda.synchronize()
    # no kernel of the port lies on this path; the counts are read around
    # it all the same
    K.two_stage_translate_kernel.launches = 0
    t0 = time.perf_counter()
    fleet.run(HEXT_MAX_TICKS, chunk=HEXT_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phase("hext", path_kernel_launches=K.two_stage_translate_kernel.launches)
    report = fleet.report()
    for label, entry in report.items():
        name, mode = label.split("/")
        want = golden[name][mode]
        bad = {f: (entry[f], want[f]) for f in HEXT_FIELDS
               if entry[f] != want[f]}
        if bad:
            raise RuntimeError(f"hext {label}: counters differ from "
                               f"hext_runs.json (got, want): {bad}")
    lockstep = max(e["ticks"] for e in report.values())
    hart_ticks = sum(e["ticks"] for e in report.values())
    phase("hext", harts=len(report), all_counters_match=True,
          wall_s=f"{wall:.3f}", lockstep_ticks=lockstep,
          lockstep_ticks_per_s=f"{lockstep / wall:.1f}",
          hart_ticks_per_s=f"{hart_ticks / wall:.1f}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0])
    print(smi, flush=True)

    t0 = time.perf_counter()
    info = build.compile_source("pagewalk")
    phase("build", kernel="pagewalk", seconds=f"{time.perf_counter() - t0:.2f}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    kernels = [pagewalk_phase(torch, np, dev)]
    hext_phase(torch, dev)

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
