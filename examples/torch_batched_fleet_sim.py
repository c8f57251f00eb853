"""The 'gem5 pod' on the PyTorch port: simulate a fleet of VMs in
lockstep, one batched tick for the whole fleet, through the typed
``Fleet`` facade, on an H100 (or the CPU with ``--device cpu``).

The MiBench-like workloads run natively AND as guests in one run that
stops once every machine is done; per-machine architectural counters come
back as typed ``Counters`` records.  Then two guests per hart under the
HS scheduler's timer slices, a heterogeneous 4-guest fleet, and a
checkpoint/restore with a live migration.  ``--workloads`` runs a subset
(all nine by default).

    PYTHONPATH=src python examples/torch_batched_fleet_sim.py [--device cpu]
        [--engine eager] [--workloads crc32,sha]
"""
import argparse
import tempfile
import time

from repro_torch.core.hext import programs
from repro_torch.core.hext.sim import Fleet, MigrationError


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--engine", default=None,
                    help="graph (default on cuda), eager, sharded, oracle")
    ap.add_argument("--workloads", default="",
                    help="comma-separated names (default: all nine)")
    ap.add_argument("--chunk", type=int, default=8192)
    args = ap.parse_args(argv)
    by_name = {w.name: w for w in programs.WORKLOADS}
    wls = ([by_name[n] for n in args.workloads.split(",")]
           if args.workloads else list(programs.WORKLOADS))
    kw = dict(device=args.device, engine=args.engine)
    ok = True

    fleet = Fleet.boot(wls + wls, guest=[False] * len(wls) + [True] * len(wls),
                       **kw)
    print(f"fleet: {len(fleet)} machines, lockstep batched simulation")
    t0 = time.time()
    fleet.run(120000, chunk=args.chunk)
    wall = time.time() - t0
    counters = fleet.counters()
    total = sum(int(c.instret) for c in counters)
    print(f"all done: {fleet.all_done}   total instructions: {total:,}   "
          f"wall: {wall:.1f}s   ({total / wall:,.0f} instr/s aggregate)")
    n = len(wls)
    for i, w in enumerate(wls):
        nat, gst = counters[i], counters[i + n]
        ok &= bool(nat.ok(w.golden())) and bool(gst.ok(w.golden()))
        print(f"  {w.name:14s} native_ok={nat.ok(w.golden())} "
              f"guest_ok={gst.ok(w.golden())} "
              f"overhead={int(gst.instret) / max(int(nat.instret), 1):.2f}x")

    # two guests per hart, the HS scheduler round-robins them on timer
    # interrupts every `timeslice`
    print("\npreemptive multi-guest fleet (2 VMs per hart, timer-sliced):")
    pfleet = Fleet.boot(wls, guests_per_hart=2, timeslice=1000, **kw)
    t0 = time.time()
    pfleet.run(120000, chunk=args.chunk)
    wall = time.time() - t0
    for label, e in pfleet.report().items():
        ok &= bool(e["ok"])
        print(f"  {label:28s} ok={e['ok']} timer_irqs={e['timer_irqs']} "
              f"ctx_switches={e['ctx_switches']}")
    print(f"preempt fleet wall: {wall:.1f}s")

    # consolidation density: four *different* tenants per hart, each with
    # its own G-stage tables, 64 KiB window and virtual time base
    print("\nheterogeneous 4-guest fleet (4 mixed tenants per hart):")
    quads = [tuple(wls[(i + k) % len(wls)] for k in range(4))
             for i in range(0, len(wls), 4)]
    hfleet = Fleet.boot(quads, guests_per_hart=4, timeslice=500, **kw)
    t0 = time.time()
    hfleet.run(480000, chunk=args.chunk)
    wall = time.time() - t0
    for label, e in hfleet.report().items():
        ok &= bool(e["ok"])
        print(f"  {label:44s} ok={e['ok']} guests_ok={e['ok_guests']} "
              f"irq={e['timer_irqs']} ctxsw={e['ctx_switches']}")
    print(f"4-guest fleet wall: {wall:.1f}s")

    # checkpointing + live migration: run two 2-tenant harts partway,
    # snapshot the pod, restore it, then evacuate one mid-flight VM from
    # hart 0 to hart 1; it still reaches its golden checksum there
    print("\ncheckpoint/restore + live migration (crc32 evacuates "
          "hart 0 → hart 1):")
    sha, crc, bits, fft = (programs.SHA(), programs.CRC32(),
                           programs.BitCount(), programs.FFT())
    mfleet = Fleet.boot([(sha, crc), (bits, fft)], guests_per_hart=2,
                        timeslice=300, **kw)
    mfleet.run(1000, chunk=1024)
    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/pod.npz"
        mfleet.snapshot(path)
        print(f"  snapshot taken mid-run → {path}")
        mfleet = Fleet.restore(path, **kw)         # resumes bit-identically
    for _ in range(12):                            # wait until descheduled
        try:
            mfleet.migrate_guest(0, 1, guest=1)
            print("  migrated: hart 0 guest 1 (crc32) → hart 1 slot 1")
            break
        except MigrationError:
            mfleet.run(300, chunk=1024)
    else:
        print("  WARNING: guest never became migratable; the reports "
              "below are for the unmigrated fleet")
    mfleet.run(120000, chunk=1024)
    for label, e in mfleet.report().items():
        ok &= bool(e["ok"])
        print(f"  {label:32s} ok={e['ok']} guests_ok={e['ok_guests']} "
              f"checksums={[hex(c) for c in e['checksums']]}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
