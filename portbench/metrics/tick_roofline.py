"""The tick's share of its HBM roofline: the least bytes one tick needs
(``portbench.roofline.tick_bytes``) at 3.35e12 B/s, over the traced
device time of a tick, in %."""
from portbench import roofline


def read(rec):
    tr = rec.get("trace") or {}
    if tr.get("kernel_ms_per_tick") is None:
        return None
    return roofline.tick_roofline_pct(
        tr["harts"], tr["instret_per_tick"], tr["walks_per_tick"],
        tr["kernel_ms_per_tick"] / 1e3)
