"""Plain PyTorch version of the two-stage table walk — the CPU path of
``ops.two_stage_translate`` and ``ops.translate``, and the yardstick the
CUDA kernel is held against on the card.

Semantics of ``repro.kernels.pagewalk.ref`` (== the dense-table walk of
``repro.core.vmem.page_table.translate`` without the fused cache):
stage 1: (tenant, req, page) → tenant_page (perm-checked);
stage 2: (tenant, tenant_page) → host slot.
Coordinates are read as a JAX gather reads them, and as the kernel reads
them: a negative coordinate ``i`` of a dimension ``n`` wraps once to
``i + n``, then every coordinate is clamped into ``[0, n - 1]``.

``translate_ref`` takes the kernel's own arguments (``Coord`` descriptors
over an [outer, inner] grid of queries, optional fused cache) and is the
whole of JAX's ``page_table.translate``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.indexing import gather_index

PERM_R, PERM_W = 1, 2


class Coord(NamedTuple):
    """One coordinate of a walk over an [outer, inner] grid of queries.
    Query (o, i) reads ``tensor`` at element offset ``o * s_outer + i *
    s_inner`` from the tensor's own start (int32 or int64, cut to int32 as
    JAX's ``asarray(x, int32)`` does; bool for ``want_write``); without a
    tensor its coordinate is ``value + o * s_outer + i * s_inner`` (a
    Python int: strides 0; a ``range``: its step)."""
    tensor: Optional[torch.Tensor]
    value: int
    s_outer: int
    s_inner: int


def two_stage_translate_ref(vs_table, vs_perm, g_table, tenant, req, page,
                            want_write):
    """vs_table/vs_perm [T,R,P] int32; g_table [T,G] int32; coords [B]
    int32; want_write [B] bool → (slot [B] int32, fault [B] bool,
    stage [B] int32)."""
    T, R, P = vs_table.shape
    G = g_table.shape[1]
    t = gather_index(tenant, T)
    r = gather_index(req, R)
    p = gather_index(page, P)
    tp = vs_table[t, r, p]
    perm = vs_perm[t, r, p]
    want = torch.where(want_write, PERM_W, PERM_R)
    s1_fault = (tp < 0) | ((perm & want) == 0)
    slot = g_table[t, gather_index(tp.clamp(min=0), G)]
    s2_fault = ~s1_fault & (slot < 0)
    fault = s1_fault | s2_fault
    out = torch.where(fault, -1, slot).to(torch.int32)
    stage = torch.where(s1_fault, 1, torch.where(s2_fault, 2, 0))
    return out, fault, stage.to(torch.int32)


def read_coord(c: Coord, outer: int, inner: int, device) -> torch.Tensor:
    """The [outer * inner] values of ``c``, as the kernel reads them."""
    if c.tensor is not None:
        return c.tensor.as_strided((outer, inner),
                                   (c.s_outer, c.s_inner)).reshape(-1)
    o = torch.arange(outer, device=device)[:, None]
    i = torch.arange(inner, device=device)[None, :]
    return (c.value + o * c.s_outer + i * c.s_inner).reshape(-1)


def translate_ref(vs_table, vs_perm, g_table, tenant: Coord, req: Coord,
                  page: Coord, want_write: Coord, outer: int, inner: int,
                  fused=None, fused_ok=None):
    """The walk of ``outer * inner`` queries given as the kernel's
    arguments; with ``fused``/``fused_ok`` the fused-cache select of JAX's
    ``page_table.translate`` at the same clamped (t, r, p).  Returns flat
    (slot int32, fault bool, stage int32)."""
    dev = vs_table.device
    t, r, p = (read_coord(c, outer, inner, dev).to(torch.int32)
               for c in (tenant, req, page))
    w = read_coord(want_write, outer, inner, dev).to(torch.bool)
    slot, fault, stage = two_stage_translate_ref(vs_table, vs_perm, g_table,
                                                 t, r, p, w)
    if fused is None:
        return slot, fault, stage
    at = tuple(gather_index(x, n) for x, n in zip((t, r, p), fused.shape))
    hit = fused_ok[at]
    return (torch.where(hit, fused[at], slot), fault & ~hit,
            torch.where(hit, 0, stage).to(torch.int32))
