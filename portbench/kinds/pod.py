"""Pods: a cohort of MiBench guests on one hart, one a slot, under the
preemptive HS scheduler, with the configuration's ``timeslice``
(:func:`portbench.reference.programs.build_image_nguest`).

Kind ``"<w0>+<w1>+.../pod"``.  Mix key: ``cohorts``, lists of workload
names as long as the configuration's ``guests_per_hart``.  A pod runs
until all its guests are done, and its exit code is the sum of their
checksums (mod 2**64).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from portbench.kinds import pad
from portbench.kinds.solo import MASK64, WORKLOADS
from portbench.reference import programs as P


def kinds(mix: Dict[str, Any], config: Dict[str, Any]) -> List[str]:
    n = config["guests_per_hart"]
    for c in mix["cohorts"]:
        if len(c) != n:
            raise ValueError(f"cohort {c} is not {n} guests")
    return ["+".join(c) + "/pod" for c in mix["cohorts"]]


def _cohort(kind: str) -> List[Any]:
    return [WORKLOADS[n] for n in kind.rsplit("/", 1)[0].split("+")]


def image(kind: str, config: Dict[str, Any]) -> np.ndarray:
    return pad(P.build_image_nguest(tuple(_cohort(kind)),
                                    timeslice=int(config["timeslice"])),
               config, kind)


def golden(kind: str) -> int:
    return sum(int(w.golden()) for w in _cohort(kind)) & MASK64
