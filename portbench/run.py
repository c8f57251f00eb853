"""The benchmark of the PyTorch port's hext fleet (``repro_torch``).

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  One run: set-up (the images from the frozen assembler, one padded
host copy onto the card, the graph's capture, one warm-up chunk and one
control round), then ``--seconds`` of a sweep with a backlog
(:mod:`portbench.sweep`), then with ``--trace 1`` a short traced part
(:mod:`portbench.trace`), then the comparison of every answer with the
reference (:mod:`portbench.check`).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones, each read by
``portbench/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit.
The same numbers close standard error.  No result is printed, and the
exit code is not 0, when the card is missing, when JAX or the JAX
package was loaded, or when the run fails.  A child process alive at the
end makes the run incorrect (:mod:`portbench.procs`).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

from portbench import bench, check, procs  # noqa: E402

# top-level module names the run must not hold when it reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

def environment(root) -> None:
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def measure(config: Dict[str, Any], mix: Dict[str, Any], seed: int,
            seconds: float, trace: bool, device, t_start: float,
            max_rounds: Optional[int] = None) -> Dict[str, Any]:
    """Set-up, window, optional trace and the comparison; the record the
    metric readers read, with ``checks``."""
    import torch

    from portbench import trace as tracing
    from portbench.sweep import Sweep

    dev = torch.device(device)
    start = time.perf_counter() - t_start
    sweep = Sweep(config, mix, seed, dev)
    sweep.warm()
    rec: Dict[str, Any] = {"setup_s": time.perf_counter() - t_start,
                           "harts": sweep.harts,
                           "phases": {"start": start, **sweep.phases}}
    rec["window_s"], rec["window_ticks"] = sweep.window(seconds, max_rounds)
    rec["retired"], rec["refills"] = sweep.retired, sweep.refills
    rec["spans"] = list(sweep.spans)
    rec["run_ticks"] = list(sweep.run_ticks)
    rec["rounds"] = sum(1 for n, _ in sweep.spans if n == "run")
    rec["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    if trace:
        rec["trace"] = tracing.measure(sweep)
    port = sweep.state()
    kinds, ages, harvest = list(sweep.kind), sweep.age.copy(), sweep.harvest
    images, goldens = sweep.images, sweep.goldens
    bad_exit = sweep.bad_exit
    del sweep
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["checks"] = check.compare(port, kinds, ages, harvest, images, goldens)
    rec["checks"]["exit_codes_wrong"] = max(
        rec["checks"]["exit_codes_wrong"], bad_exit)
    rec["check_s"] = time.perf_counter() - t0
    return rec


def result(rec: Dict[str, Any], metrics, device: Dict[str, Any],
           trace: bool) -> Dict[str, Any]:
    """The result line's object; ``checks`` comes last."""
    ck = rec["checks"]
    checks = {k: {"value": ck[k], "limit": lim}
              for k, lim in check.LIMITS.items()}
    out: Dict[str, Any] = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": ck["lanes"] + ck["jobs"],
        "failed": ck["lanes_wrong"] + ck["jobs_wrong"],
        "metrics": {},
        "device": device,
    }
    for m in metrics:
        v = bench.reader(m["name"])(rec)
        if v is not None:
            out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    if trace and rec.get("trace", {}).get("breakdown"):
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = checks
    return out


def _card() -> Dict[str, Any]:
    """One sample of the card's name and power limit beside the run."""
    out = procs.run_once(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"])
    return {"nvidia_smi": out.strip().splitlines()[0]} if out else {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with procs.Guard():
        bench_ = bench.load()
        cell = bench.cell(bench_, args.workload)
        config = bench.config(bench_, cell["config"])
        mix = bench.mix(cell["traffic"])
        environment(bench.ROOT)
        import torch
        chips = int(cell["chips"])
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 1
        rec = measure(config, mix, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
        loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                        & set(FORBIDDEN))
        if loaded:
            print(f"portbench: the run loaded {', '.join(loaded)}",
                  file=sys.stderr)
            return 2
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": chips, "memory_peak_bytes": rec["peak_bytes"]}
        if args.trace:
            device["busy_s"] = rec["trace"]["busy_s"]
            device["window_s"] = rec["trace"]["window_s"]
        device.update(_card())
        out = result(rec, bench.metrics(bench_, args.workload,
                                        bool(args.trace)),
                     device, bool(args.trace))
        alive = sorted(procs.children())
        if alive:
            procs.reap(alive)
            out["correct"] = False
            out["checks"]["children_alive"] = {"value": len(alive),
                                               "limit": 0}
        print(f"portbench: {args.workload} seed {args.seed}: "
              f"{rec['harts']} harts, setup {rec['setup_s']:.3f} s, "
              f"window {rec['window_s']:.3f} s ({rec['rounds']} rounds, "
              f"{rec['window_ticks']} ticks), {rec['retired']} instructions, "
              f"{rec['checks']['jobs']} jobs finished, check "
              f"{rec['check_s']:.3f} s", file=sys.stderr)
        print("portbench: set-up " + ", ".join(
            f"{k} {v:.3f} s" for k, v in rec["phases"].items()),
            file=sys.stderr)
        print("portbench: window " + " ".join(
            f"{k[0]}{v:.3f}" for k, v in rec["spans"]), file=sys.stderr)
        print("portbench: ms a tick by run " + " ".join(
            f"{1e3 * s / t:.3f}" for s, t in zip(
                (v for k, v in rec["spans"] if k == "run"),
                rec["run_ticks"])), file=sys.stderr)
        for name, c in out["checks"].items():
            print(f"check {name} {c['value']} limit {c['limit']}",
                  file=sys.stderr)
        print(json.dumps(out))
        sys.stdout.flush()
        return 1 if alive else 0


if __name__ == "__main__":
    raise SystemExit(main())
