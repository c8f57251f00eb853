"""Kernels the captured tick launches: traced kernels a tick (the
difference of two traced runs of the fleet)."""


def read(rec):
    tr = rec.get("trace") or {}
    return tr.get("kernels_per_tick")
