"""Plain PyTorch version of the batched two-stage table walk — the CPU
path of ``ops.two_stage_translate`` and the yardstick the CUDA kernel is
held against on the card.

Semantics of ``repro.kernels.pagewalk.ref`` (== the dense-table walk of
``repro.core.vmem.page_table.translate`` without the fused cache):
stage 1: (tenant, req, page) → tenant_page (perm-checked);
stage 2: (tenant, tenant_page) → host slot.
Coordinates are read as a JAX gather reads them, and as the kernel reads
them: a negative coordinate ``i`` of a dimension ``n`` wraps once to
``i + n``, then every coordinate is clamped into ``[0, n - 1]``.
"""
from __future__ import annotations

import torch

from repro_torch.indexing import gather_index

PERM_R, PERM_W = 1, 2


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
