"""Device milliseconds of one tick: the kernels' time a tick in the
trace (the difference of two traced runs of the fleet)."""


def read(rec):
    tr = rec.get("trace") or {}
    return tr.get("kernel_ms_per_tick")
