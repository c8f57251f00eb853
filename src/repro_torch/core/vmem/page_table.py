"""Two-stage page tables for the KV-cache virtual memory — the port of
``repro.core.vmem.page_table``.

Mirrors the H extension:

  stage 1 (VS-stage / ``vsatp``):  per-request logical page → tenant page
  stage 2 (G-stage  / ``hgatp``):  tenant page → host pool slot

Entries carry R/W permission bits; the fused cache (logical → host) is the
TLB analogue and is invalidated by ``hfence()`` after a stage-2 edit.

``translate`` is one call of ``kernels.pagewalk.ops.translate``: on CUDA
tables one launch of the ``pagewalk`` kernel does the broadcast, the walk
and the fused-cache select (Python int and bool coordinates go in as
kernel arguments, so no host-to-device copy); on CPU tables that
kernel's plain version runs on the same arguments.  Every index follows
JAX's rules (:mod:`repro_torch.indexing`), so out-of-range coordinates
give the reference's answer.  Tables are edited functionally: each edit returns
a new ``TwoStageTable`` (they are small), as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.indexing import put
from repro_torch.device import resolve
from repro_torch.kernels.pagewalk import ops as pagewalk

INVALID = -1

# permission bits (stage-1 entries)
PERM_R = 1
PERM_W = 2


class TwoStageTable(NamedTuple):
    """Batched tables for T tenants.

    vs_table:  [T, reqs_per_tenant, logical_pages] int32 → tenant page
    vs_perm:   same shape, permission bits
    g_table:   [T, tenant_pages] int32                 → host slot
    fused:     [T, reqs_per_tenant, logical_pages]     → host slot (TLB)
    fused_ok:  validity of fused entries (bool)
    """
    vs_table: torch.Tensor
    vs_perm: torch.Tensor
    g_table: torch.Tensor
    fused: torch.Tensor
    fused_ok: torch.Tensor

    @staticmethod
    def create(n_tenants: int, reqs_per_tenant: int, logical_pages: int,
               tenant_pages: int, device=None) -> "TwoStageTable":
        dev = resolve(device)
        shp1 = (n_tenants, reqs_per_tenant, logical_pages)
        i32 = dict(dtype=torch.int32, device=dev)
        return TwoStageTable(
            vs_table=torch.full(shp1, INVALID, **i32),
            vs_perm=torch.zeros(shp1, **i32),
            g_table=torch.full((n_tenants, tenant_pages), INVALID, **i32),
            fused=torch.full(shp1, INVALID, **i32),
            fused_ok=torch.zeros(shp1, dtype=torch.bool, device=dev))

    @classmethod
    def from_numpy(cls, src, device=None) -> "TwoStageTable":
        """From the reference's tables (a ``TwoStageTable`` of JAX arrays,
        or a mapping of its fields), read through ``numpy.asarray``."""
        dev = resolve(device)
        get = src.__getitem__ if isinstance(src, dict) else \
            lambda f: getattr(src, f)
        return cls(**{f: torch.as_tensor(np.array(np.asarray(get(f))),
                                         device=dev) for f in cls._fields})

    def to_numpy(self) -> dict:
        """The fields as numpy arrays (int32, ``fused_ok`` bool)."""
        return {f: getattr(self, f).cpu().numpy() for f in self._fields}


class Translation(NamedTuple):
    slot: torch.Tensor      # host pool slot (or -1), int32
    fault: torch.Tensor     # bool: translation fault (either stage)
    stage: torch.Tensor     # 1 = VS-stage fault, 2 = G-stage fault, 0 = ok


def translate(t: TwoStageTable, tenant, req, page, acc_write=False,
              use_fused=True) -> Translation:
    """Translate (tenant, request, logical page) → host slot.

    The coordinates and ``acc_write`` (a bool or a bool array) broadcast
    against each other: scalars, ``range``s or any leading batch shape."""
    fused = (t.fused, t.fused_ok) if use_fused else (None, None)
    return Translation(*pagewalk.translate(
        t.vs_table, t.vs_perm, t.g_table, tenant, req, page, acc_write,
        *fused))


def map_stage1(t: TwoStageTable, tenant, req, page, tenant_page,
               perm=PERM_R | PERM_W) -> TwoStageTable:
    """Guest (tenant runtime) edits its own stage-1 table."""
    at = (tenant, req, page)
    return t._replace(
        vs_table=put(t.vs_table, at, tenant_page),
        vs_perm=put(t.vs_perm, at, perm),
        # stage-1 edits invalidate that fused line only
        fused_ok=put(t.fused_ok, at, False))


def map_stage2(t: TwoStageTable, tenant, tenant_page, slot) -> TwoStageTable:
    """Hypervisor (scheduler) maps a tenant page to a host slot."""
    return t._replace(g_table=put(t.g_table, (tenant, tenant_page), slot))


def unmap_stage2(t: TwoStageTable, tenant, tenant_page) -> TwoStageTable:
    return t._replace(
        g_table=put(t.g_table, (tenant, tenant_page), INVALID))


def hfence(t: TwoStageTable, tenant=None) -> TwoStageTable:
    """hfence.gvma analogue: invalidate fused (TLB) entries — all tenants or
    one tenant's."""
    if tenant is None:
        return t._replace(fused_ok=torch.zeros_like(t.fused_ok))
    return t._replace(fused_ok=put(t.fused_ok, (tenant,), False))


def fill_fused(t: TwoStageTable, tenant, req, page) -> TwoStageTable:
    """Populate the fused cache for given coordinates (post-walk TLB fill)."""
    tr = translate(t, tenant, req, page, use_fused=False)
    ok = ~tr.fault
    at = (tenant, req, page)
    return t._replace(
        fused=put(t.fused, at, torch.where(ok, tr.slot, INVALID)),
        fused_ok=put(t.fused_ok, at, ok))


def translate_block(t: TwoStageTable, tenant, req, n_pages: int,
                    acc_write=False) -> Translation:
    """Translate all logical pages [0, n_pages) of one request — the decode
    path (the whole per-request page list in one walk; the pages are the
    walk's own index, so no page vector is made)."""
    return translate(t, tenant, req, range(n_pages), acc_write=acc_write)
