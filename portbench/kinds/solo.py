"""Single-tenant jobs: one MiBench workload a hart, built by the frozen
assembler (:mod:`portbench.reference.programs`).

* ``"<workload>/native"`` — the workload under an S-mode kernel;
* ``"<workload>/guest"``  — the same under a VS-mode kernel, on the HS
  hypervisor (two-stage translation).

Mix keys: ``workloads`` and ``modes``.  A job runs until it finishes, and
its exit code is the workload's checksum.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from portbench.kinds import pad
from portbench.reference import programs as P

MASK64 = (1 << 64) - 1
MODES = ("native", "guest")
WORKLOADS = {w.name: w for w in P.WORKLOADS}


def kinds(mix: Dict[str, Any], config: Dict[str, Any]) -> List[str]:
    if config["guests_per_hart"] != 1:
        raise ValueError("a solo mix needs a fleet of single-tenant harts")
    bad = [m for m in mix["modes"] if m not in MODES]
    if bad:
        raise ValueError(f"unknown modes {bad}")
    return [f"{w}/{m}" for w in mix["workloads"] for m in mix["modes"]]


def image(kind: str, config: Dict[str, Any]) -> np.ndarray:
    name, mode = kind.rsplit("/", 1)
    return pad(P.build_image(WORKLOADS[name], mode == "guest"), config, kind)


def golden(kind: str) -> int:
    return int(WORKLOADS[kind.rsplit("/", 1)[0]].golden()) & MASK64
