"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and runs on ``cuda`` by default;
``cpu`` is used only when the caller asks for it (the CPU tests do).  With
no usable GPU and no explicit CPU request the entry point raises — there is
no silent CPU path.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` → ``cuda``; anything else is taken as given.  Raises
    ``RuntimeError`` when a CUDA device is asked for and none is usable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev
