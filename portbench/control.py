"""The control of ``correct``: the port with its software TLB switched
off, run through the whole of a cell, has to come out incorrect.

    python3 -m portbench.control --workload <cell> --seed <n> \\
        --seconds <s>

Every lookup misses, so every fetch and data access walks the page
tables.  The architectural results stay as they were, but the machine no
longer models the 16-entry TLB that the configuration states (``walks``
counts its fetch-side misses, and its fills move the replacement
pointer): the step a later change could take because the captured tick
computes the walk every tick anyway.  The benchmark's own runs never
plant it.  Prints the run's checks, and exits 0 when the control came
out incorrect, 1 when the check missed it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Iterator


@contextlib.contextmanager
def tlb_off() -> Iterator[None]:
    """Plant the control in the port: ``tlb.lookup`` never hits."""
    import torch

    from repro_torch.core.hext import tlb

    lookup = tlb.lookup

    def miss(*args, **kwargs):
        v = lookup(*args, **kwargs)
        return v._replace(hit=torch.zeros_like(v.hit))

    tlb.lookup = miss
    try:
        yield
    finally:
        tlb.lookup = lookup


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from portbench import bench, procs, run
    with procs.Guard():
        b = bench.load()
        cell = bench.cell(b, args.workload)
        run.environment(bench.ROOT)
        import torch
        if not torch.cuda.is_available():
            print("portbench.control: no CUDA device", file=sys.stderr)
            return 2
        with tlb_off():
            rec = run.measure(bench.config(b, cell["config"]),
                              bench.mix(cell["traffic"]), args.seed,
                              args.seconds, False, "cuda", t_start)
        out = run.result(rec, [], {}, False)
        print(json.dumps({"control": "tlb_off", "workload": args.workload,
                          "seed": args.seed, "correct": out["correct"],
                          "window_ticks": rec["window_ticks"],
                          "lanes": rec["checks"]["lanes"],
                          "jobs": rec["checks"]["jobs"],
                          "checks": out["checks"]}))
        return 1 if out["correct"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
