"""Share of the window in which the card runs nothing, in %.

The card's busy time is taken from the trace and laid over the
window's own unprofiled wall time: each tick of the window counts the
traced union of kernel intervals a tick, each run of the fleet the traced
busy time of the state copied in and out, each control round the traced
busy time of its counters' copies, and each refill the traced busy time
of one ``replace_hart``.  So a card that runs the same kernels with
longer gaps between them (the "slow mode" of ``PERF.md``) reads idle.

The tracer lengthens each kernel a little (about 3 % of a tick's kernel
time on the H100), so the share reads that much low, and can dip below 0
on a card that is fast and a window with short control rounds.
"""


def read(rec):
    tr = rec.get("trace") or {}
    if tr.get("busy_ms_per_tick") is None:
        return None
    busy = (rec["window_ticks"] * tr["busy_ms_per_tick"] / 1e3
            + rec["rounds"] * (tr["run_busy_s"] + tr["control_busy_s"])
            + rec["refills"] * tr["refill_busy_s"])
    return 100.0 * (1.0 - busy / rec["window_s"])
