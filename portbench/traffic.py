"""The one traffic generator: a mix file and a seed → a backlog of jobs.

A job is one bootable system image, named by its *kind*.  The mix's
``kind`` names the module that knows its jobs, ``portbench/kinds/<kind>.py``
(:mod:`portbench.kinds`): their names, images and goldens.
Mix keys: ``kind``, the module's own keys, and ``poll_ticks``, the ticks
the sweep runs between two control rounds.

Every seed runs the same multiset of jobs in another order: the fleet
starts with the kinds in equal shares, shuffled over its lanes, and the
backlog is an endless run of blocks that each hold every kind once, each
block shuffled.  So seeds change where and when a job runs, not how much
work there is.
"""
from __future__ import annotations

import importlib
import random
from types import ModuleType
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np


def module(mix: Dict[str, Any]) -> ModuleType:
    """The module of the mix's ``kind``, ``portbench/kinds/<kind>.py``."""
    name = mix["kind"]
    path = f"portbench/kinds/{name}.py"
    if not (isinstance(name, str) and name.isidentifier()):
        raise ValueError(f"mix kind {name!r} names no file {path}")
    qual = f"portbench.kinds.{name}"
    try:
        return importlib.import_module(qual)
    except ModuleNotFoundError as e:
        if e.name != qual:
            raise
        raise ValueError(f"unknown mix kind {name!r}: there is no file "
                         f"{path}") from None


def image(mod: ModuleType, kind: str,
          config: Dict[str, Any]) -> np.ndarray:
    """The job's memory image from its kind's module ``mod``, held to
    uint64 words, ``config["mem_words"]`` long."""
    img = mod.image(kind, config)
    want = (int(config["mem_words"]),)
    if not isinstance(img, np.ndarray) or img.dtype != np.uint64 or \
            img.shape != want:
        raise ValueError(f"{kind}: the image is not {want[0]} uint64 "
                         f"words")
    return img


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
