"""Sv39 / Sv39x4 one- and two-stage address translation (paper §3.3) —
port of ``repro.core.hext.translate``.

The VS-stage (``vsatp``) translates guest-virtual → guest-physical; every
page-table access of that walk, and the final guest-physical address, is
itself translated by the G-stage (``hgatp``, Sv39x4: root widened by 2
bits) — guest PA → host PA.  Faults carry (cause, tval=VA, tval2=GPA>>2,
gva).

Every function works on a (B,) batch of harts (``mem`` is (B, W)); the
three levels are unrolled and masked, exactly as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hext import csr as C
from repro_torch.core.hext.bits import lsr, read64, uge

# PTE bits
PTE_V = 1 << 0
PTE_R = 1 << 1
PTE_W = 1 << 2
PTE_X = 1 << 3
PTE_U = 1 << 4
PTE_A = 1 << 6
PTE_D = 1 << 7

ACC_R, ACC_W, ACC_X = 0, 1, 2

PAGE_SHIFT = 12
LEVELS = 3


class XResult(NamedTuple):
    pa: torch.Tensor          # host-physical address
    fault: torch.Tensor       # bool
    cause: torch.Tensor       # exception cause
    tval: torch.Tensor        # faulting VA
    tval2: torch.Tensor       # faulting GPA >> 2; 0 if none
    gva: torch.Tensor         # bool: tval is a guest virtual address
    implicit: torch.Tensor    # bool: G-stage fault on an implicit PTE fetch
    leaf_pte: torch.Tensor    # stage-1 leaf PTE (or all-perm pseudo-PTE)
    g_leaf_pte: torch.Tensor  # G-stage leaf PTE (or all-perm pseudo-PTE)
    level: torch.Tensor       # stage-1 leaf level (0=4K,1=2M,2=1G)


# pseudo-PTE carrying every permission (used for bare/no-paging stages)
ALL_PERM_PTE = PTE_V | PTE_R | PTE_W | PTE_X | PTE_U | PTE_A | PTE_D


def _by_acc(acc, r, w, x):
    """Select by access type; ``acc`` is a tensor or a Python constant."""
    if isinstance(acc, int):
        return (r, w, x)[acc]
    return torch.where(acc == ACC_R, r, torch.where(acc == ACC_W, w, x))


def _acc_cause(acc):
    """Access-fault cause for an access type (PMA-style fault: the PA does
    not exist).  Faults on implicit PTE fetches report the cause of the
    *original* access type, like page faults do."""
    return _by_acc(acc, C.EXC_LACCESS, C.EXC_SACCESS, C.EXC_IACCESS)


def _pf_cause(acc, guest: bool):
    """Page-fault cause for access type; guest=True → guest-page-fault."""
    if guest:
        return _by_acc(acc, C.EXC_LGUEST_PAGE_FAULT,
                       C.EXC_SGUEST_PAGE_FAULT, C.EXC_IGUEST_PAGE_FAULT)
    return _by_acc(acc, C.EXC_LPAGE_FAULT, C.EXC_SPAGE_FAULT,
                   C.EXC_IPAGE_FAULT)


def _leaf_ok(pte, acc, priv, sum_bit, mxr, require_u: bool):
    """Permission check on a leaf PTE.  ``require_u`` is static: G-stage
    walks pass True (guest accesses are "U") and then ``priv``/``sum_bit``
    are not read."""
    r = (pte & PTE_R) != 0
    w = (pte & PTE_W) != 0
    x = (pte & PTE_X) != 0
    u = (pte & PTE_U) != 0
    a = (pte & PTE_A) != 0
    d = (pte & PTE_D) != 0
    perm = _by_acc(acc, r | (mxr & x), w & r, x)
    # U-bit discipline: U-mode needs U=1; S-mode needs U=0 unless SUM
    # (loads/stores only).
    if require_u:
        u_ok = u
    else:
        not_x = acc != ACC_X
        u_ok = torch.where(priv == 0, u, (~u) | (sum_bit & not_x))
    ad_ok = a & _by_acc(acc, True, d, True)
    return perm & u_ok & ad_ok


def _walk(mem, root_pa, vpn2_bits, va, acc, priv, sum_bit, mxr,
          require_u: bool, guest: bool, pte_xlate=None, cause_acc=None):
    """Generic 3-level Sv39(x4) walk over a (B,) batch.

    vpn2_bits: 9 (Sv39) or 11 (Sv39x4).  pte_xlate: optional fn(gpa, acc)
    → XResult used to G-translate each PTE address (the nesting that makes
    two-stage translation expensive — paper Fig 3).  cause_acc: access type
    used for fault *causes* (G-stage faults during implicit PTE fetches
    report the original access type per the spec)."""
    cause_acc = acc if cause_acc is None else cause_acc
    mem_bytes = mem.shape[1] * 8
    zb = torch.zeros_like(va, dtype=torch.bool)
    z = torch.zeros_like(va)
    base = root_pa
    done, fault, f_implicit = zb, zb, zb
    f_cause, f_tval2, pa, leaf_pte, leaf_level = z, z, z, z, z
    acc_cause = _acc_cause(cause_acc)
    pf_cause = _pf_cause(cause_acc, guest)
    for level in (2, 1, 0):
        shift = PAGE_SHIFT + 9 * level
        nbits = vpn2_bits if level == 2 else 9
        vpn = (va >> shift) & ((1 << nbits) - 1)
        pte_addr = base + (vpn << 3)
        if pte_xlate is not None:
            xr = pte_xlate(pte_addr, ACC_R)
            pte_pa, g_fault = xr.pa, xr.fault
        else:
            pte_pa, g_fault = pte_addr, zb
        # a PTE address beyond physical memory is an access fault, not a
        # wrap-around into RAM
        oob = uge(pte_pa, mem_bytes)
        pte = read64(mem, pte_pa)
        valid = (pte & PTE_V) != 0
        # W=1,R=0 encodings are reserved in Sv39/Sv39x4 and page-fault
        reserved = ((pte & PTE_W) != 0) & ((pte & PTE_R) == 0)
        is_leaf = (pte & (PTE_R | PTE_X)) != 0
        ppn = (pte >> 10) & ((1 << 44) - 1)
        perm_ok = _leaf_ok(pte, acc, priv, sum_bit, mxr, require_u)
        if level:
            # superpage alignment: low ppn bits must be zero at level>0
            align_ok = (ppn & ((1 << (9 * level)) - 1)) == 0
            leaf_fault = is_leaf & ~(align_ok & perm_ok)
        else:
            leaf_fault = is_leaf & ~perm_ok
        level_fault = g_fault | oob | ~valid | reserved | leaf_fault
        level_cause = torch.where(oob, acc_cause, pf_cause)
        if pte_xlate is not None:
            level_cause = torch.where(g_fault, xr.cause, level_cause)
        # leaf PA: ppn high bits + VA low bits per level
        mask_low = (1 << shift) - 1
        leaf_pa = ((ppn << PAGE_SHIFT) & ~mask_low) | (va & mask_low)
        new_fault = ~done & level_fault
        fault = fault | new_fault
        f_cause = torch.where(new_fault, level_cause, f_cause)
        if pte_xlate is not None:
            g_new = new_fault & g_fault
            f_tval2 = torch.where(g_new, xr.tval2, f_tval2)
            f_implicit = f_implicit | g_new
        take_leaf = ~done & ~level_fault & is_leaf
        pa = torch.where(take_leaf, leaf_pa, pa)
        leaf_pte = torch.where(take_leaf, pte, leaf_pte)
        leaf_level = torch.where(take_leaf, level, leaf_level)
        done = done | new_fault | take_leaf
        if level:
            # walk down: next base
            base = torch.where(done, base, ppn << PAGE_SHIFT)
    # ran out of levels without leaf → page fault
    miss = ~done
    fault = fault | miss
    f_cause = torch.where(miss, pf_cause, f_cause)
    return pa, fault, f_cause, f_tval2, f_implicit, leaf_pte, leaf_level


def g_translate(mem, hgatp, gpa, acc, mxr, cause_acc=None) -> XResult:
    """G-stage only: guest-physical → host-physical (Sv39x4).

    Guest accesses are treated as user-level (PTE.U required). cause_acc:
    original access type for fault causes (implicit PTE fetches)."""
    mode = (hgatp >> C.ATP_MODE_SHIFT) & 0xF
    root = (hgatp & C.ATP_PPN_MASK) << PAGE_SHIFT
    pa, fault, cause, _, _, lp, lvl = _walk(
        mem, root, 11, gpa, acc, None, None, mxr, True, True,
        cause_acc=cause_acc)
    bare = mode == 0
    zb = torch.zeros_like(bare)
    return XResult(pa=torch.where(bare, gpa, pa), fault=fault & ~bare,
                   cause=torch.where(bare, 0, cause), tval=gpa,
                   tval2=lsr(gpa, 2), gva=zb, implicit=zb,
                   leaf_pte=torch.full_like(gpa, ALL_PERM_PTE),
                   g_leaf_pte=torch.where(bare, ALL_PERM_PTE, lp),
                   level=torch.where(bare, 0, lvl))


def eff_ctx(csrs, virt_eff):
    """Effective (SUM, MXR) for an access: vsstatus supplies both when the
    access is virtualized, mstatus otherwise.  Shared by the walker and the
    TLB so cached permissions always match what a fresh walk would check."""
    st = torch.where(virt_eff, csrs[:, C.R_VSSTATUS], csrs[:, C.R_MSTATUS])
    return (st & C.MSTATUS_SUM) != 0, (st & C.MSTATUS_MXR) != 0


def translate(mem, csrs, priv, virt, va, acc, force_virt=False,
              hlvx=False, mprv_sum=None) -> XResult:
    """Full translation honoring privilege & virtualization mode.

    force_virt: hlv/hsv — execute the access as if V=1 (paper §3.3's
    XlateFlags forced virtualization).  hlvx: require execute permission
    instead of read (HLVX).  ``acc``/``force_virt``/``hlvx`` are (B,)
    tensors or Python constants."""
    virt_eff = virt | force_virt
    s_bit, mxr = eff_ctx(csrs, virt_eff)
    if mprv_sum is not None:
        s_bit = mprv_sum
    if isinstance(hlvx, bool):
        acc_eff = ACC_X if hlvx else acc
    else:
        acc_eff = torch.where(hlvx, ACC_X, acc)

    # hgatp participates only for virtualized accesses; forcing it to BARE
    # otherwise lets one walk serve both cases (g_translate is identity
    # when mode=0).
    hgatp_eff = torch.where(virt_eff, csrs[:, C.R_HGATP], 0)
    atp = torch.where(virt_eff, csrs[:, C.R_VSATP], csrs[:, C.R_SATP])
    mode = (atp >> C.ATP_MODE_SHIFT) & 0xF
    root = (atp & C.ATP_PPN_MASK) << PAGE_SHIFT

    no_paging = (mode == 0) | ((priv >= 3) & ~virt_eff)

    # --- first stage (VS or S), PTE fetches G-translated when virtual -----
    def pte_xlate(gpa, a):
        # implicit VS-stage PTE fetch: needs R at G-stage, but a fault is
        # reported with the ORIGINAL access type — raw `acc`, not acc_eff
        return g_translate(mem, hgatp_eff, gpa, a, mxr, cause_acc=acc)

    pa1, fault1, cause1, tval2_1, implicit1, vs_pte, vs_level = _walk(
        mem, root, 9, va, acc_eff, priv, s_bit, mxr, False, False,
        pte_xlate=pte_xlate)

    gpa_out = torch.where(no_paging, va, pa1)
    stage1_fault = ~no_paging & fault1

    # --- second stage on the final GPA -------------------------------------
    # HLVX carries its execute-permission override through the G-stage too
    # (acc_eff), while fault causes still report the original access type.
    g = g_translate(mem, hgatp_eff, gpa_out, acc_eff, mxr, cause_acc=acc)
    g_fault = ~stage1_fault & g.fault
    fault = stage1_fault | g_fault
    cause = torch.where(stage1_fault, cause1, g.cause)
    tval2 = torch.where(stage1_fault, tval2_1,
                        torch.where(g_fault, g.tval2, 0))
    return XResult(pa=g.pa, fault=fault, cause=cause, tval=va, tval2=tval2,
                   # GVA: tval holds a guest-virtual address whenever the
                   # access ran V=1
                   gva=virt_eff & fault,
                   implicit=stage1_fault & implicit1,
                   leaf_pte=torch.where(no_paging, ALL_PERM_PTE, vs_pte),
                   g_leaf_pte=g.g_leaf_pte,
                   level=torch.where(no_paging, 0, vs_level))
