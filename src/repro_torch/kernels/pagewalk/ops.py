"""Entry point of the two-stage table walk: CPU tensors → the plain
version (``ref.py``), CUDA tensors → the CUDA kernel (``kernel.py``).

There is no fallback: on the card the kernel launches or the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.kernels.pagewalk.kernel import two_stage_translate_kernel
from repro_torch.kernels.pagewalk.ref import two_stage_translate_ref


def two_stage_translate(vs_table, vs_perm, g_table, tenant, req, page,
                        want_write=None, force: str = "auto", device=None):
    """Translate B (tenant, req, page) queries through both table stages.

    Inputs (tensors or arrays) are placed on ``device`` (default
    ``cuda``).  ``force``: ``auto`` (by device), ``ref`` (only valid on
    the CPU) or ``kernel`` (only valid on CUDA) — a forced path that does
    not match the device raises instead of falling back."""
    if force not in ("auto", "ref", "kernel"):
        raise ValueError(f"force must be auto|ref|kernel, got {force!r}")
    dev = resolve(device)
    tables = [torch.as_tensor(x, dtype=torch.int32, device=dev)
              for x in (vs_table, vs_perm, g_table)]
    coords = [torch.as_tensor(x, dtype=torch.int32, device=dev)
              for x in (tenant, req, page)]
    if want_write is None:
        want = torch.zeros_like(coords[0], dtype=torch.bool)
    else:
        want = torch.as_tensor(want_write, dtype=torch.bool, device=dev)
    if dev.type == "cuda":
        if force == "ref":
            raise ValueError("force='ref' is the CPU path; CUDA tensors "
                             "run the kernel")
        return two_stage_translate_kernel(
            *[x.contiguous() for x in tables + coords + [want]])
    if force == "kernel":
        raise ValueError(f"force='kernel' needs CUDA tensors, got {dev}")
    return two_stage_translate_ref(*tables, *coords, want)
