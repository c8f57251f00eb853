"""Kinds of job, one module a mix ``kind``: ``portbench/kinds/<kind>.py``.

:mod:`portbench.traffic` imports the module that a mix's ``kind`` names,
as :func:`portbench.bench.reader` imports a metric.  The module gives

* ``kinds(mix, config) -> List[str]`` — the names of the mix's jobs;
* ``image(kind, config) -> np.ndarray`` — a job's bootable memory image,
  uint64, ``config["mem_words"]`` long (:func:`pad` pads a shorter one);
* ``golden(kind) -> int | None`` — the exit code a finished job must
  report, or ``None`` where there is none: the exit code is then held to
  the reference's, as every other counter is.

A job keeps its lane until it finishes.  So a later change adds a kind of job by adding a module here, a mix that
names it and, where the module needs one, a frozen generator under
``portbench/reference/``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def pad(img: Any, config: Dict[str, Any], kind: str) -> np.ndarray:
    """``img`` as uint64 words, zero-padded to ``config["mem_words"]``."""
    img = np.asarray(img, dtype=np.uint64)
    words = int(config["mem_words"])
    if img.shape[0] > words:
        raise ValueError(f"{kind}: image of {img.shape[0]} words, the "
                         f"fleet has {words} a hart")
    return img if img.shape[0] == words else np.pad(img,
                                                    (0, words - img.shape[0]))
