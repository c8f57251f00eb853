"""Host page-pool allocator with per-tenant quotas — the port of
``repro.core.vmem.allocator``.

The pool is a fixed set of host slots (the physical KV pages on the card):

  free_stack: [n_slots] int32 — stack of free slot ids
  top:        0-d int32 tensor — number of free slots
  owner:      [n_slots] int32 — tenant owning each slot (-1 free)
  quota/used: [n_tenants] int32

Every operation is tensor code with no host sync and reproduces the
reference on every input, out-of-range ones included, by JAX's indexing
rules (:mod:`repro_torch.indexing`): ``alloc`` computes its
owner write even when the slot is -1 and then discards it, ``free``
gathers ``owner[slot]`` for any slot, and a push past the end of the free
stack is dropped.  Each operation returns a new ``PagePool``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.indexing import put, take
from repro_torch.device import resolve


class PagePool(NamedTuple):
    free_stack: torch.Tensor
    top: torch.Tensor
    owner: torch.Tensor
    quota: torch.Tensor
    used: torch.Tensor

    @staticmethod
    def create(n_slots: int, quotas, device=None) -> "PagePool":
        dev = resolve(device)
        quotas = torch.as_tensor(quotas, device=dev).to(torch.int32)
        return PagePool(
            free_stack=torch.arange(n_slots - 1, -1, -1, dtype=torch.int32,
                                    device=dev),
            top=torch.tensor(n_slots, dtype=torch.int32, device=dev),
            owner=torch.full((n_slots,), -1, dtype=torch.int32, device=dev),
            quota=quotas,
            used=torch.zeros_like(quotas))

    @classmethod
    def from_numpy(cls, src, device=None) -> "PagePool":
        """From the reference's pool (a ``PagePool`` of JAX arrays, or a
        mapping of its fields), read through ``numpy.asarray``."""
        dev = resolve(device)
        get = src.__getitem__ if isinstance(src, dict) else \
            lambda f: getattr(src, f)
        return cls(**{f: torch.as_tensor(
            np.array(np.asarray(get(f)), dtype=np.int32), device=dev)
            for f in cls._fields})

    def to_numpy(self) -> dict:
        """The fields as int32 numpy arrays (``top`` 0-d)."""
        return {f: getattr(self, f).cpu().numpy() for f in self._fields}


def alloc(pool: PagePool, tenant) -> Tuple[PagePool, torch.Tensor]:
    """Pop a slot for `tenant`. Returns (pool, slot) with slot=-1 on
    exhaustion or quota breach (the caller surfaces a capacity fault)."""
    tenant = torch.as_tensor(tenant, device=pool.top.device).to(torch.int32)
    has_free = pool.top > 0
    under_quota = take(pool.used, tenant) < take(pool.quota, tenant)
    ok = has_free & under_quota
    idx = torch.clamp(pool.top - 1, min=0)
    slot = torch.where(ok, take(pool.free_stack, idx), -1).to(torch.int32)
    new = PagePool(
        free_stack=pool.free_stack,
        top=torch.where(ok, pool.top - 1, pool.top),
        owner=torch.where(ok, put(pool.owner, (slot,), tenant), pool.owner),
        quota=pool.quota,
        used=torch.where(ok, put(pool.used, (tenant,), 1, add=True),
                         pool.used))
    return new, slot


def free(pool: PagePool, slot) -> PagePool:
    """Push a slot back (idempotent for already-free slots)."""
    slot = torch.as_tensor(slot, device=pool.top.device).to(torch.int32)
    tenant = take(pool.owner, slot)
    ok = (slot >= 0) & (tenant >= 0)
    return PagePool(
        free_stack=torch.where(ok, put(pool.free_stack, (pool.top,), slot),
                               pool.free_stack),
        top=torch.where(ok, pool.top + 1, pool.top),
        owner=torch.where(ok, put(pool.owner, (slot,), -1), pool.owner),
        quota=pool.quota,
        used=torch.where(ok, put(pool.used, (tenant,), -1, add=True),
                         pool.used))


def free_tenant(pool: PagePool, tenant) -> PagePool:
    """VM teardown: release every slot owned by `tenant` in one shot."""
    n_slots = pool.owner.shape[0]
    dev = pool.owner.device
    tenant = torch.as_tensor(tenant, device=dev).to(torch.int32)
    mine = pool.owner == tenant
    n = mine.sum(dtype=torch.int32)
    # jnp.nonzero(mine, size=n_slots, fill_value=-1) without a host sync:
    # owned slot ids in ascending order, then -1 padding
    rank = torch.cumsum(mine, 0) - 1
    ids = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    ids[torch.where(mine, rank, n_slots)] = torch.arange(
        n_slots, dtype=torch.int32, device=dev)
    slots = ids[:n_slots]
    # push the owned slots at top, top + 1, ...; the rest is dropped
    pos = pool.top + torch.arange(n_slots, dtype=torch.int32, device=dev)
    valid = slots >= 0
    fs = put(pool.free_stack, (torch.where(valid, pos, n_slots),),
             torch.where(valid, slots, 0))
    return PagePool(
        free_stack=fs,
        top=pool.top + n,
        owner=torch.where(mine, -1, pool.owner),
        quota=pool.quota,
        used=put(pool.used, (tenant,), 0))


def check_invariants(pool: PagePool) -> dict:
    """Host-side invariant audit (used by property tests)."""
    owner = pool.owner.cpu().numpy()
    used = pool.used.cpu().numpy()
    quota = pool.quota.cpu().numpy()
    top = int(pool.top)
    free_set = set(pool.free_stack[:top].cpu().numpy().tolist())
    owned = {i for i, o in enumerate(owner.tolist()) if o >= 0}
    ok_disjoint = free_set.isdisjoint(owned)
    ok_cover = len(free_set) + len(owned) == owner.shape[0]
    ok_quota = all(u <= q for u, q in zip(used.tolist(), quota.tolist()))
    counts_ok = all(
        int((owner == t).sum()) == int(used[t]) for t in range(len(used)))
    return {"disjoint": ok_disjoint, "cover": ok_cover, "quota": ok_quota,
            "counts": counts_ok}
