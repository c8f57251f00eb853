"""The port's own spans (``repro_torch.core.hext.tracing``), as the
per-layer readers take them.  The tracer records while the traced part of
a ``--trace 1`` run holds a profiler open; a program without the tracer,
or a span that never ran or was never timed, gives None."""
from __future__ import annotations

from typing import Any, Dict, Optional


def report() -> Optional[Dict[str, Any]]:
    """The tracer's report, or None where the program has no tracer."""
    try:
        from repro_torch.core.hext import tracing
    except ImportError:
        return None
    return tracing.report()


def stage_ms(*names: str) -> Optional[float]:
    """Device ms a tick of the captured tick's stages ``names``, summed;
    None unless every one was sampled."""
    rep = report()
    if rep is None or not all(n in rep["stages"] for n in names):
        return None
    return sum(rep["stages"][n]["ms"] for n in names)


def per_call_ms(name: str, clock: str) -> Optional[float]:
    """Mean ms a call of the host span ``name`` on the ``host`` clock, or
    of its timed device work (``device``)."""
    rep = report()
    agg = None if rep is None else rep["spans"].get(name)
    if agg is None:
        return None
    n = agg["count"] if clock == "host" else agg["device_count"]
    return agg[f"{clock}_ms"] / n if n else None
