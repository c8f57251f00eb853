"""Paged KV cache backed by the two-stage tables — the port of
``repro.core.vmem.kvcache``.

The pool holds KV pages for all tenants:
    k_pool, v_pool: [n_slots, page_size, n_kv_heads, head_dim]

A request's logical page p is resolved via ``page_table.translate``
(tenant-local stage 1 → host stage 2), which runs the ``pagewalk`` kernel
on the card.  Decode attention runs the ``paged_attention`` kernel over
the translated page list.  Faults surface to the scheduler, which
allocates through ``PagePool`` and edits the tables:

    guest page fault  →  stage-1 edit by the tenant runtime (map_stage1)
    G-stage fault     →  alloc(pool) + map_stage2 by the "hypervisor",
                          then hfence(tenant) to keep the fused cache sound

Functional vs in place.  JAX returns new arrays for every edit; copying a
pool of gigabytes for each ``write_token`` is not an option on the card.
So the tables and the ``PagePool`` are edited functionally (clone, then
edit; they are small), while ``k_pool``/``v_pool`` are updated IN PLACE:
``write_token`` writes into the pools it was given, and the
``PagedKVCache`` it returns shares their storage.  Callers follow the
reference's ``kv = f(kv, ...)`` pattern, and an older ``PagedKVCache``
sees the new K/V rows.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.vmem import allocator as AL
from repro_torch.core.vmem import page_table as PT
from repro_torch.indexing import put, take
from repro_torch.device import resolve
from repro_torch.kernels.paged_attention import ops as attention


def _pool_from_numpy(a, dtype_name, dev) -> torch.Tensor:
    """A pool array from numpy; bf16 (ml_dtypes' ``bfloat16``, or its
    uint16 bit pattern when ``dtype_name`` says so) is carried bit-exactly
    as int16 and viewed as ``torch.bfloat16``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or dtype_name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.as_tensor(bits.copy(), device=dev).view(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=dev)


class PagedKVCache(NamedTuple):
    k_pool: torch.Tensor      # [slots, page, kv_heads, head_dim]
    v_pool: torch.Tensor
    tables: PT.TwoStageTable
    pool: AL.PagePool
    page_size: int

    @staticmethod
    def create(n_slots: int, page_size: int, n_kv_heads: int, head_dim: int,
               n_tenants: int, reqs_per_tenant: int, logical_pages: int,
               tenant_pages: int, quotas=None, dtype=torch.bfloat16,
               device=None) -> "PagedKVCache":
        dev = resolve(device)
        quotas = quotas if quotas is not None else [tenant_pages] * n_tenants
        shape = (n_slots, page_size, n_kv_heads, head_dim)
        return PagedKVCache(
            k_pool=torch.zeros(shape, dtype=dtype, device=dev),
            v_pool=torch.zeros(shape, dtype=dtype, device=dev),
            tables=PT.TwoStageTable.create(n_tenants, reqs_per_tenant,
                                           logical_pages, tenant_pages,
                                           device=dev),
            pool=AL.PagePool.create(n_slots, quotas, device=dev),
            page_size=page_size)

    @classmethod
    def from_numpy(cls, src, device=None) -> "PagedKVCache":
        """From the reference's cache (a ``PagedKVCache`` of JAX arrays) or
        from ``to_numpy``'s mapping; bf16 pools are bit-exact."""
        dev = resolve(device)
        get = src.__getitem__ if isinstance(src, dict) else \
            lambda f: getattr(src, f)
        name = src.get("pool_dtype") if isinstance(src, dict) else None
        return cls(k_pool=_pool_from_numpy(get("k_pool"), name, dev),
                   v_pool=_pool_from_numpy(get("v_pool"), name, dev),
                   tables=PT.TwoStageTable.from_numpy(get("tables"), dev),
                   pool=AL.PagePool.from_numpy(get("pool"), dev),
                   page_size=int(get("page_size")))

    def to_numpy(self) -> dict:
        """Numpy arrays; a bf16 pool comes out as its uint16 bit pattern
        (numpy has no bf16), named by ``pool_dtype``."""
        bf16 = self.k_pool.dtype == torch.bfloat16

        def pool(x):
            if bf16:
                return x.view(torch.int16).cpu().numpy().view(np.uint16)
            return x.cpu().numpy()
        return {"k_pool": pool(self.k_pool), "v_pool": pool(self.v_pool),
                "tables": self.tables.to_numpy(),
                "pool": self.pool.to_numpy(), "page_size": self.page_size,
                "pool_dtype": str(self.k_pool.dtype).replace("torch.", "")}


# ---------------------------------------------------------------------------
# scheduler-side fault handling (the hypervisor loop)
# ---------------------------------------------------------------------------

def ensure_mapped(kv: PagedKVCache, tenant: int, req: int,
                  page: int) -> Tuple["PagedKVCache", bool]:
    """Host-side: make (tenant, req, page) resolvable, allocating through
    both stages as needed. Returns (kv, ok)."""
    # without the fused cache a walk faults iff its stage is not 0: one
    # host read per walk
    stage = int(PT.translate(kv.tables, tenant, req, page,
                             use_fused=False).stage)
    if stage == 0:
        return kv, True
    tables, pool = kv.tables, kv.pool
    if stage == 1:
        # stage-1 fault: tenant runtime maps logical → the first tenant
        # page this request's stage-1 row does not use yet (host-side
        # python: this is the control plane, not the data plane)
        n_tp = tables.g_table.shape[1]
        used = set(take(tables.vs_table, tenant, req).tolist())
        tp = next((i for i in range(n_tp) if i not in used), None)
        if tp is None:
            return kv, False
        tables = PT.map_stage1(tables, tenant, req, page, tp)
        stage = int(PT.translate(tables, tenant, req, page,
                                 use_fused=False).stage)
    if stage != 0:  # stage-2: hypervisor allocates a host slot
        tp = int(take(tables.vs_table, tenant, req, page))
        pool, slot = AL.alloc(pool, tenant)
        if int(slot) < 0:
            return kv._replace(tables=tables, pool=pool), False
        tables = PT.map_stage2(tables, tenant, tp, slot)
        tables = PT.hfence(tables, tenant)
    tables = PT.fill_fused(tables, tenant, req, page)
    return kv._replace(tables=tables, pool=pool), True


def evict_tenant(kv: PagedKVCache, tenant: int) -> "PagedKVCache":
    """Tear down a tenant: one stage-2 sweep + pool free — O(tenant pages),
    independent of how many requests/logical pages the tenant had."""
    pool = AL.free_tenant(kv.pool, tenant)
    tables = kv.tables._replace(
        g_table=put(kv.tables.g_table, (tenant,), PT.INVALID),
        vs_table=put(kv.tables.vs_table, (tenant,), PT.INVALID),
        vs_perm=put(kv.tables.vs_perm, (tenant,), 0))
    tables = PT.hfence(tables, tenant)
    return kv._replace(tables=tables, pool=pool)


# ---------------------------------------------------------------------------
# data plane
# ---------------------------------------------------------------------------

def write_token(kv: PagedKVCache, tenant, req, pos, k, v):
    """Append one token's K/V at sequence position `pos` (page must be
    mapped): k, v [n_kv_heads, head_dim].  Writes into the pools in place
    (no host sync); a faulting write leaves them as they were."""
    dev = kv.k_pool.device
    pos = torch.as_tensor(pos, device=dev).long()
    page = pos // kv.page_size
    off = pos % kv.page_size
    tr = PT.translate(kv.tables, tenant, req, page, acc_write=True)
    slot = torch.clamp(tr.slot.long(), min=0)
    n_slots = kv.k_pool.shape[0]
    # the reference's scatter drops a write past the pool (its gather
    # clamps): keep the row as it is then
    keep = tr.fault | (slot >= n_slots)
    slot = slot.clamp(max=n_slots - 1)
    for p, x in ((kv.k_pool, k), (kv.v_pool, v)):
        x = torch.as_tensor(x, device=dev).to(p.dtype)
        p[slot, off] = torch.where(keep, p[slot, off], x)
    return kv, tr.fault


def gather_kv(kv: PagedKVCache, tenant, req, n_pages: int):
    """Decode-side gather: [n_pages*page, kv_heads, hd] K/V for one request.
    Unmapped pages read as zeros (masked by length in attention)."""
    tr = PT.translate_block(kv.tables, tenant, req, n_pages)
    slots = torch.clamp(tr.slot, min=0)
    mask = (~tr.fault)[:, None, None, None]
    k, v = (torch.where(mask, take(p, slots), 0).reshape(-1, *p.shape[2:])
            for p in (kv.k_pool, kv.v_pool))
    return k, v, tr


def paged_decode_attention(kv: PagedKVCache, tenant, req, q, length,
                           scale: float):
    """Single-request decode attention through the two-stage translation.

    q: [n_heads, head_dim]; length: valid tokens. Returns [n_heads, hd] in
    q's dtype.  Two steps: ``translate_block`` (the ``pagewalk`` kernel on
    the card) gives the request's page map, -1 where a page faults; then
    ``paged_attention`` (the CUDA kernel on the card) with
    ``unmapped_reads_zero=1``, so a faulted page below ``length`` counts
    with K = V = 0 as in the reference."""
    dev = kv.k_pool.device
    n_pages = kv.tables.fused.shape[-1]
    tr = PT.translate_block(kv.tables, tenant, req, n_pages)
    page_map = torch.where(tr.fault, -1, torch.clamp(tr.slot, min=0))[None]
    q = torch.as_tensor(q, device=dev)[None]
    lengths = torch.as_tensor(length, device=dev).to(torch.int32).reshape(1)
    out = attention.paged_attention(q, kv.k_pool, kv.v_pool, page_map,
                                    lengths, scale, device=dev,
                                    unmapped_reads_zero=1)
    return out[0]
