"""Fleet-as-a-service walkthrough on the PyTorch port: submit -> evict ->
resume -> drain, on the card (or the CPU with ``--device cpu``).

Boots a two-hart pod (two scheduler guests per hart) plus one solo lane,
fills it with four long-running tenants, then submits a fifth while
every slot is busy: the control plane parks the youngest guest as a
per-guest checkpoint (eviction), serves the newcomer, resumes the parked
guest into a reserved slot, and drains everything to its registry
golden.  Prints the control-plane event log and a per-tenant
time-to-result table.  ``--engine`` picks the backend (``graph`` by
default on the card, ``eager`` on the CPU).

    PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]
"""
import argparse

from repro_torch.core.hext import programs
from repro_torch.core.hext.policies import BinPackPolicy
from repro_torch.core.hext.service import FleetService

BY_NAME = {w.name: w for w in programs.WORKLOADS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--engine", default=None)
    args = ap.parse_args(argv)
    svc = FleetService(n_harts=2, guests_per_hart=2, n_solo=1,
                       timeslice=300, slice_ticks=2048, chunk=512,
                       policy=BinPackPolicy(partial_after=1),
                       engine=args.engine, device=args.device)

    print("== submit: four long tenants fill both harts ==")
    for tenant, name in enumerate(["qsort", "bitcount", "dijkstra",
                                   "susan"]):
        jid = svc.submit(BY_NAME[name], tenant=tenant)
        print(f"  tenant {tenant}: {name} -> job {jid}")
    svc.step()                       # placement happens on the next round

    print("== submit under pressure: tenant 4 arrives, no free slot ==")
    late = svc.submit(BY_NAME["sha"], tenant=4)
    solo = svc.submit(BY_NAME["crc32"], tenant=5, mode="native")
    print(f"  tenant 4: sha -> job {late} (queued; eviction incoming)")
    print(f"  tenant 5: crc32 -> job {solo} (native solo lane)")

    ok = svc.drain(max_slices=500)
    print(f"\n== drained in {svc.slices} control rounds "
          f"({svc.ticks} simulated ticks), all goldens ok: {ok} ==")
    print("stats:", svc.stats)

    print("\n== per-tenant time-to-result ==")
    print(f"  {'job':>3} {'tenant':>6} {'workload':>12} {'mode':>7} "
          f"{'slices':>6}  ok")
    for j in svc.jobs():
        print(f"  {j.job_id:>3} {j.tenant:>6} {j.name:>12} {j.mode:>7} "
              f"{j.time_to_result():>6}  ok={j.ok}")

    evicted = [j for j in svc.jobs()
               if any("parked" in e for e in j.events)]
    print("\n== control-plane log of the evicted tenant ==")
    for j in evicted:
        for e in j.events:
            print(f"  job {j.job_id}: {e}")

    m = svc.metrics()
    print(f"\np50 time-to-result: {m['p50_ttr_slices']} slices, "
          f"p99: {m['p99_ttr_slices']} slices")
    assert ok and evicted, "demo should evict at least one tenant"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
