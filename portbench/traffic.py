"""The one traffic generator: a mix file and a seed → a backlog of jobs.

A job is one bootable system image, built by the frozen assembler
(:mod:`portbench.reference.programs`) and named by its *kind*:

* ``"<workload>/native"`` — the workload under an S-mode kernel;
* ``"<workload>/guest"``  — the same under a VS-mode kernel, on the HS
  hypervisor (two-stage translation);
* ``"<w0>+<w1>+.../pod"`` — a cohort of guests, one per slot, under the
  preemptive HS scheduler.

Mix keys: ``kind`` (``"solo"`` or ``"pod"``); for ``solo``,
``workloads`` and ``modes``; for ``pod``, ``cohorts`` (lists of workload
names, as long as the configuration's ``guests_per_hart``); and
``poll_ticks``, the ticks the sweep runs between two control rounds.

Every seed runs the same multiset of jobs in another order: the fleet
starts with the kinds in equal shares, shuffled over its lanes, and the
backlog is an endless run of blocks that each hold every kind once, each
block shuffled.  So seeds change where and when a job runs, not how much
work there is.
"""
from __future__ import annotations

import random
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

from portbench.reference import programs as P

MASK64 = (1 << 64) - 1
MODES = ("native", "guest")

_BY_NAME = {w.name: w for w in P.WORKLOADS}


def kinds(mix: Dict[str, Any], config: Dict[str, Any]) -> List[str]:
    if mix["kind"] == "solo":
        if config["guests_per_hart"] != 1:
            raise ValueError("a solo mix needs a fleet of single-tenant harts")
        bad = [m for m in mix["modes"] if m not in MODES]
        if bad:
            raise ValueError(f"unknown modes {bad}")
        return [f"{w}/{m}" for w in mix["workloads"] for m in mix["modes"]]
    if mix["kind"] == "pod":
        n = config["guests_per_hart"]
        for c in mix["cohorts"]:
            if len(c) != n:
                raise ValueError(f"cohort {c} is not {n} guests")
        return ["+".join(c) + "/pod" for c in mix["cohorts"]]
    raise ValueError(f"unknown mix kind {mix['kind']!r}")


def _split(kind: str) -> Tuple[List[Any], str]:
    names, mode = kind.rsplit("/", 1)
    return [_BY_NAME[n] for n in names.split("+")], mode


def image(kind: str, config: Dict[str, Any]) -> np.ndarray:
    """The job's memory image as uint64 words, ``config["mem_words"]``
    long."""
    wls, mode = _split(kind)
    if mode == "pod":
        img = P.build_image_nguest(tuple(wls),
                                   timeslice=int(config["timeslice"]))
    else:
        img = P.build_image(wls[0], mode == "guest")
    img = np.asarray(img, dtype=np.uint64)
    if img.shape[0] != int(config["mem_words"]):
        raise ValueError(f"{kind}: image of {img.shape[0]} words, the "
                         f"fleet has {config['mem_words']} a hart")
    return img


def golden(kind: str) -> int:
    """The exit code a finished job must report: the workload's checksum,
    or for a pod the sum of its guests' (mod 2**64)."""
    wls, _ = _split(kind)
    return sum(int(w.golden()) for w in wls) & MASK64


def plan(kinds_: List[str], harts: int,
         seed: int) -> Tuple[List[str], Iterator[str]]:
    """(the kind of each lane at boot, the backlog of refills)."""
    rng = random.Random(seed)
    first = [kinds_[i % len(kinds_)] for i in range(harts)]
    rng.shuffle(first)

    def backlog() -> Iterator[str]:
        while True:
            block = list(kinds_)
            rng.shuffle(block)
            yield from block

    return first, backlog()
