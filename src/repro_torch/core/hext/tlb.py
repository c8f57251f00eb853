"""Two-stage-aware TLB (paper §3.5 challenge (3)) — port of
``repro.core.hext.tlb``.

Each entry caches a *composed* translation (VPN → host PFN) plus the
permission bits derived from both the guest (VS-stage) leaf PTE and the
host (G-stage) leaf PTE.  Entries created in virtualization mode are
tagged ``guest`` so that ``hfence.{vvma,gvma}`` invalidates only them while
``sfence.vma`` touches only native entries; entries also carry the
privilege context (priv/SUM/MXR) their permissions were composed under.

The TLB is a dict of (B, N_TLB) tensors plus a (B,) round-robin ``ptr``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hext import translate as X
from repro_torch.core.hext.bits import lsr

N_TLB = 16

PERM_R, PERM_W, PERM_X = 1, 2, 4

_I64_KEYS = ("vpn", "ppn", "level", "perm", "priv")
_BOOL_KEYS = ("guest", "sum", "mxr", "valid")


class TlbVerdict(NamedTuple):
    """Complete TLB lookup outcome for a batch of accesses.

    ``hit``: an entry matched (VPN + guest tag + privilege context);
    ``pa``: the composed host-physical address of the matched entry
    (garbage when ``hit`` is false — gate on ``hit``);
    ``perm_ok``: the cached composed permissions allow this access.
    ``use`` is the short-circuit predicate: the walk can be skipped."""

    hit: torch.Tensor
    pa: torch.Tensor
    perm_ok: torch.Tensor

    @property
    def use(self):
        return self.hit & self.perm_ok


def init_tlb(batch: int, device) -> dict:
    t = {k: torch.zeros((batch, N_TLB), dtype=torch.int64, device=device)
         for k in _I64_KEYS}
    t.update({k: torch.zeros((batch, N_TLB), dtype=torch.bool,
                             device=device) for k in _BOOL_KEYS})
    t["ptr"] = torch.zeros((batch,), dtype=torch.int64, device=device)
    return t


def select(cond, a: dict, b: dict) -> dict:
    """Per-hart select between two TLBs: cond (B,)."""
    return {k: torch.where(cond if a[k].ndim == 1 else cond[:, None],
                           a[k], b[k]) for k in a}


def _vpn_mask(level):
    """VPN bits that must match for an entry of this level."""
    return ~((1 << (level * 9)) - 1)


def _va_match(tlb, va):
    """Entries whose cached translation covers ``va`` (superpage-aware)."""
    lm = _vpn_mask(tlb["level"])
    return (lsr(va, 12)[:, None] & lm) == (tlb["vpn"] & lm)


def lookup(tlb, va, virt, acc, priv, sum_bit, mxr) -> TlbVerdict:
    """Match only entries whose cached permission context (priv/SUM/MXR at
    insert time) equals the current access's.  The first matching entry
    wins (the reference's ``argmax`` over the match mask)."""
    match = tlb["valid"] & (tlb["guest"] == virt[:, None]) & \
        (tlb["priv"] == priv[:, None]) & (tlb["sum"] == sum_bit[:, None]) & \
        (tlb["mxr"] == mxr[:, None]) & _va_match(tlb, va)
    hit = match.any(1)
    slots = torch.arange(N_TLB, device=va.device)
    idx = (torch.where(match, slots, N_TLB).amin(1) % N_TLB)[:, None]
    level = tlb["level"].gather(1, idx)[:, 0]
    span_mask = (1 << (12 + level * 9)) - 1
    base = (tlb["ppn"].gather(1, idx)[:, 0] << 12) & ~span_mask
    pa = base | (va & span_mask)
    want = X._by_acc(acc, PERM_R, PERM_W, PERM_X)
    perm_ok = (tlb["perm"].gather(1, idx)[:, 0] & want) != 0
    return TlbVerdict(hit=hit, pa=pa, perm_ok=perm_ok)


def compose_perms(vs_pte, g_pte, priv, sum_bit, mxr):
    """Permission bits of the composed entry — guest PTE perms AND host
    PTE perms (paper: store guest PTE permission bits alongside the
    host's)."""
    bits = 0
    for acc, bit in ((X.ACC_R, PERM_R), (X.ACC_W, PERM_W),
                     (X.ACC_X, PERM_X)):
        ok1 = X._leaf_ok(vs_pte, acc, priv, sum_bit, mxr, False)
        ok2 = X._leaf_ok(g_pte, acc, None, None, mxr, True)
        bits = bits | ((ok1 & ok2).long() * bit)
    return bits


def insert(tlb, va, pa, level, perm, virt, priv, sum_bit, mxr):
    i = (tlb["ptr"] % N_TLB)[:, None]
    vals = {"vpn": lsr(va, 12), "ppn": lsr(pa, 12), "level": level,
            "perm": perm, "guest": virt, "priv": priv, "sum": sum_bit,
            "mxr": mxr, "valid": torch.ones_like(virt)}
    t = {k: tlb[k].scatter(1, i, v[:, None]) for k, v in vals.items()}
    t["ptr"] = tlb["ptr"] + 1
    return t


def flush(tlb, guest_only=False, native_only=False, va=None):
    """Host-side flush: full-scope per tag class, or — with ``va`` — only
    the entries of that class that translate the given VA page (the
    rs1≠x0 form of sfence.vma / hfence.vvma)."""
    keep = torch.zeros_like(tlb["valid"])
    if guest_only:
        keep = ~tlb["guest"]       # hfence: drop guest entries only
    if native_only:
        keep = tlb["guest"]        # sfence: drop native entries only
    if va is not None:
        keep = keep | ~_va_match(tlb, va)
    t = dict(tlb)
    t["valid"] = tlb["valid"] & keep
    return t


def flush_where(tlb, cond_guest, cond_native,
                cond_guest_addr=None, cond_native_addr=None, va=None):
    """Per-hart flush; all conditions are (B,) bools.

    ``cond_guest``/``cond_native`` are the full-scope flushes (rs1=x0,
    atp writes).  ``cond_guest_addr``/``cond_native_addr`` are the
    address-targeted forms (rs1≠x0): only entries of that tag class whose
    cached translation covers the ``va`` page are dropped."""
    g = tlb["guest"]
    drop = (g & cond_guest[:, None]) | (~g & cond_native[:, None])
    if cond_guest_addr is not None:
        vm = _va_match(tlb, va)
        drop = drop | (vm & ((g & cond_guest_addr[:, None]) |
                             (~g & cond_native_addr[:, None])))
    t = dict(tlb)
    t["valid"] = tlb["valid"] & ~drop
    return t
