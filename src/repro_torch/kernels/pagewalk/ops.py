"""Entry points of the two-stage table walk: CPU tensors → the plain
version (``ref.py``), CUDA tensors → the CUDA kernel (``kernel.py``).

* ``two_stage_translate`` — the TPU kernel's function over 1-d query
  vectors;
* ``translate`` — the whole of JAX's ``page_table.translate`` (broadcast
  coordinates, optional fused cache) as one walk: ``plan_coords`` turns
  the coordinates into the kernel's own arguments, which the plain
  version takes too.

There is no fallback: on the card the kernel launches or the call raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels.pagewalk.kernel import (translate_kernel,
                                                 two_stage_translate_kernel)
from repro_torch.kernels.pagewalk.ref import (Coord, translate_ref,
                                              two_stage_translate_ref)


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


class Plan(NamedTuple):
    """The walk of ``outer * inner`` queries that ``shape`` flattens to:
    (tenant, req, page, want_write) as the kernel's ``Coord`` arguments."""
    shape: torch.Size
    outer: int
    inner: int
    coords: tuple


def _int32(v: int) -> int:
    """A Python int cut to int32, as ``torch.as_tensor(v).to(int32)``."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _collapse(sizes, strides):
    """The one stride of dimensions ``sizes``/``strides`` read as a single
    dimension, or None if they do not collapse (0 for no dimension)."""
    for k in range(len(sizes) - 1):
        if strides[k] != strides[k + 1] * sizes[k + 1]:
            return None
    return strides[-1] if sizes else 0


def plan_coords(tenant, req, page, want_write, device) -> Plan:
    """The kernel's arguments for JAX-style broadcast coordinates.

    A Python (or numpy) int or bool is a value: no tensor, no copy.  A
    ``range`` is a 1-d coordinate computed in the kernel (start + index x
    step).  Anything else becomes a tensor on ``device`` (int32 or int64
    coordinates, bool ``want_write``; other types are converted).  The
    broadcast shape's dimensions of size > 1 are split into [outer, inner]
    where every coordinate's strides collapse on both sides; where no
    split works the tensors are materialised as contiguous vectors."""
    items = []
    for k, x in enumerate((tenant, req, page, want_write)):
        if isinstance(x, (bool, int, np.bool_, np.integer)):
            items.append(int(bool(x)) if k == 3 else _int32(int(x)))
        elif isinstance(x, range) and k < 3:
            items.append(x)
        else:
            x = torch.as_tensor(x, device=device)
            if k == 3 and x.dtype != torch.bool:
                x = x.to(torch.bool)
            elif k < 3 and x.dtype not in (torch.int32, torch.int64):
                x = x.to(torch.int32)
            items.append(x)
    shape = torch.broadcast_shapes(*(
        (len(x),) if isinstance(x, range) else
        x.shape if isinstance(x, torch.Tensor) else () for x in items))
    nd = len(shape)

    def strides(x):
        if isinstance(x, torch.Tensor):
            return x.expand(shape).stride()
        if isinstance(x, range):
            return (0,) * (nd - 1) + (x.step if len(x) > 1 else 0,)
        return (0,) * nd

    dims = [d for d in range(nd) if shape[d] != 1]
    sizes = [shape[d] for d in dims]
    all_strides = [[strides(x)[d] for d in dims] for x in items]
    for split in range(len(dims) + 1):
        cut = [(_collapse(sizes[:split], s[:split]),
                _collapse(sizes[split:], s[split:])) for s in all_strides]
        if all(o is not None and i is not None for o, i in cut):
            break
    else:
        split = 0
        items = [x if not isinstance(x, (torch.Tensor, range)) else
                 _as_tensor(x, device).expand(shape).reshape(-1)
                 .contiguous()
                 for x in items]
        cut = [(0, 0) if isinstance(x, int) else (0, 1) for x in items]
    outer, inner = math.prod(sizes[:split]), math.prod(sizes[split:])
    coords = []
    for x, (so, si) in zip(items, cut):
        if isinstance(x, torch.Tensor):
            coords.append(Coord(x, 0, so, si))
        elif isinstance(x, range):
            coords.append(Coord(None, x.start, so, si))
        else:
            coords.append(Coord(None, x, 0, 0))
    return Plan(shape, outer, inner, tuple(coords))


def _as_tensor(x, device):
    if isinstance(x, range):
        return torch.arange(x.start, x.stop, x.step, dtype=torch.int32,
                            device=device)
    return x


def translate(vs_table, vs_perm, g_table, tenant, req, page,
              want_write=False, fused=None, fused_ok=None):
    """JAX's ``page_table.translate`` as one walk: (slot int32, fault
    bool, stage int32), each of the coordinates' broadcast shape.  On
    CUDA tables one kernel launch (no other kernel, no host-to-device copy
    for int or bool coordinates); on CPU tables the plain version of the
    same arguments."""
    dev = vs_table.device
    plan = plan_coords(tenant, req, page, want_write, dev)
    walk = translate_kernel if dev.type == "cuda" else translate_ref
    out = walk(vs_table, vs_perm, g_table, *plan.coords, plan.outer,
               plan.inner, fused, fused_ok)
    return tuple(x.reshape(plan.shape) for x in out)
