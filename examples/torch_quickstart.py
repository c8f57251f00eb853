"""Quickstart on the PyTorch port: boot a guest VM under the xvisor-lite
hypervisor and compare it against native execution, on an H100 (or the
CPU with ``--device cpu``).

The optional second argument picks the execution backend of
``repro_torch.core.hext.engine``: ``graph`` (the default on the card:
the tick captured as CUDA graphs), ``eager`` (the default on the CPU),
``sharded`` (one shard per card) or ``oracle`` (the pure-Python
reference model: slow, but every counter, ``walks`` included, matches
the device engines bit for bit).

    PYTHONPATH=src python examples/torch_quickstart.py [workload] [engine]
        [--device cpu] [--chunk 1024]
"""
import argparse
import time

from repro_torch.core.hext import programs
from repro_torch.core.hext.engine import ENGINES
from repro_torch.core.hext.sim import Fleet


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workload", nargs="?", default="crc32")
    ap.add_argument("engine", nargs="?", default=None,
                    help="graph (default on cuda), eager (default on the "
                    "CPU), sharded or oracle")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--chunk", type=int, default=8192,
                    help="ticks between the all-done checks")
    args = ap.parse_args(argv)
    by_name = {w.name: w for w in programs.WORKLOADS}
    if args.workload not in by_name:
        ap.error(f"unknown workload {args.workload!r}; "
                 f"choose from: {', '.join(sorted(by_name))}")
    if args.engine is not None and args.engine not in ENGINES:
        ap.error(f"unknown engine {args.engine!r}; "
                 f"choose from: {', '.join(sorted(ENGINES))}")
    wl = by_name[args.workload]
    fleet = Fleet.boot([wl, wl], guest=[False, True], engine=args.engine,
                       device=args.device)
    print(f"workload: {wl.name}   golden checksum: {wl.golden()}   "
          f"engine: {getattr(fleet.engine, 'name', 'custom')}   device: "
          f"{args.device or 'cuda'}")
    t0 = time.time()
    fleet.run(max_ticks=120000, chunk=args.chunk)
    wall = time.time() - t0
    ok = True
    for spec, c in zip(fleet.specs, fleet.counters()):
        label = ("guest (two-stage, xvisor-lite)" if spec.guest else "native")
        ok &= bool(c.ok(wl.golden()))
        print(f"{label:34s} checksum_ok={c.ok(wl.golden())}  "
              f"instret={int(c.instret)}  "
              f"exceptions M/HS/VS={c.exc_by_level.tolist()}  "
              f"pagefaults={int(c.pagefaults)}")
    print(f"fleet wall={wall:.1f}s (both machines in one lockstep run)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
