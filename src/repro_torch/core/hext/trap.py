"""Trap & interrupt routing (paper §3.2, Fig 2) — port of
``repro.core.hext.trap``.

``route``: delegation chain — M unless medeleg/mideleg delegates to HS,
then VS if (V=1 and hedeleg/hideleg delegates further).
``take_trap``: the ``RiscvFault::invoke()`` analogue — updates
{m,s,vs}status/cause/epc/tval (+ htval/mtval2/htinst/mtinst, GVA, MPV,
SPV, SPVP), switches privilege/virtualization mode, and returns the
handler PC.
``pending_interrupt``: the per-tick ``CheckInterrupts()`` with the default
priority order MEI>MSI>MTI>SEI>SSI>STI>SGEI>VSEI>VSSI>VSTI, evaluated for
all ten causes at once as a (B, 10) mask.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.hext import csr as C
from repro_torch.core.hext.bits import device_const, s64, uge


class TrapTarget(NamedTuple):
    priv: torch.Tensor   # target privilege (3=M, 1=S/HS or VS)
    virt: torch.Tensor   # bool target virtualization mode


def route(csrs, priv, virt, cause, is_int):
    """Delegation per §3.2: read {m,h}{e,i}deleg based on current priv."""
    bit = 1 << (cause & 63)
    mdeleg = torch.where(is_int, csrs[:, C.R_MIDELEG], csrs[:, C.R_MEDELEG])
    hdeleg = torch.where(is_int, csrs[:, C.R_HIDELEG], csrs[:, C.R_HEDELEG])
    # traps from M never delegate down
    to_hs_or_vs = ((mdeleg & bit) != 0) & (priv < 3)
    # VS-level interrupts delegated via hideleg go straight to VS when V=1;
    # exceptions likewise require V=1 (HS faults never route to VS)
    to_vs = to_hs_or_vs & ((hdeleg & bit) != 0) & virt
    return TrapTarget(priv=torch.where(to_hs_or_vs, 1, 3), virt=to_vs)


def _set_bit(cond, word, bit):
    return torch.where(cond, word | bit, word & ~bit)


_M_COLS = (C.R_MSTATUS, C.R_MEPC, C.R_MCAUSE, C.R_MTVAL, C.R_MTVAL2,
           C.R_MTINST)
_H_COLS = (C.R_MSTATUS, C.R_HSTATUS, C.R_SEPC, C.R_SCAUSE, C.R_STVAL,
           C.R_HTVAL, C.R_HTINST)
_V_COLS = (C.R_VSSTATUS, C.R_VSEPC, C.R_VSCAUSE, C.R_VSTVAL)


def take_trap(csrs, priv, virt, pc, cause, is_int, tval, tval2, gva, tinst):
    """Apply the trap to the CSR file → (csrs, new_pc, new_priv, new_virt,
    handled_level) with handled_level ∈ {0:M, 1:HS, 2:VS}."""
    tgt = route(csrs, priv, virt, cause, is_int)
    scause = torch.where(is_int, cause | s64(C.INT_BIT), cause)

    mstatus = csrs[:, C.R_MSTATUS]
    hstatus = csrs[:, C.R_HSTATUS]
    vsstatus = csrs[:, C.R_VSSTATUS]

    # ---- to M -------------------------------------------------------------
    mst = (mstatus & ~C.MSTATUS_MPP) | ((priv << 11) & C.MSTATUS_MPP)
    mst = _set_bit((mstatus & C.MSTATUS_MIE) != 0, mst, C.MSTATUS_MPIE)
    mst = mst & ~C.MSTATUS_MIE
    mst = _set_bit(virt, mst, C.MSTATUS_MPV)
    mst = _set_bit(gva, mst, C.MSTATUS_GVA)

    # ---- to HS ------------------------------------------------------------
    sst = _set_bit(priv >= 1, mstatus, C.MSTATUS_SPP)
    sst = _set_bit((mstatus & C.MSTATUS_SIE) != 0, sst, C.MSTATUS_SPIE)
    sst = sst & ~C.MSTATUS_SIE
    hst = _set_bit(virt, hstatus, C.HSTATUS_SPV)
    # SPVP: previous privilege *inside* the guest (only meaningful if V=1)
    hst = torch.where(virt, _set_bit(priv >= 1, hst, C.HSTATUS_SPVP), hst)
    hst = _set_bit(gva, hst, C.HSTATUS_GVA)

    # ---- to VS ------------------------------------------------------------
    vst = _set_bit(priv >= 1, vsstatus, C.MSTATUS_SPP)
    vst = _set_bit((vsstatus & C.MSTATUS_SIE) != 0, vst, C.MSTATUS_SPIE)
    vst = vst & ~C.MSTATUS_SIE
    # VS-level interrupt causes are presented shifted to S encodings
    vs_cause = torch.where(is_int & uge(cause, 2) & uge(10, cause),
                           scause - 1, scause)

    def bank(cols, vals):
        c = csrs.clone()
        c[:, device_const(cols, csrs.device)] = torch.stack(vals, 1)
        return c

    csrs_m = bank(_M_COLS, [mst, pc, scause, tval, tval2, tinst])
    csrs_h = bank(_H_COLS, [sst, hst, pc, scause, tval, tval2, tinst])
    csrs_v = bank(_V_COLS, [vst, pc, vs_cause, tval])

    to_m = tgt.priv == 3
    to_vs = tgt.virt
    new_csrs = torch.where(to_m[:, None], csrs_m,
                           torch.where(to_vs[:, None], csrs_v, csrs_h))
    new_pc = torch.where(to_m, csrs[:, C.R_MTVEC],
                         torch.where(to_vs, csrs[:, C.R_VSTVEC],
                                     csrs[:, C.R_STVEC])) & ~3
    handled = torch.where(to_m, 0, torch.where(to_vs, 2, 1))
    return new_csrs, new_pc, tgt.priv, to_vs, handled


# interrupt priority: MEI, MSI, MTI, SEI, SSI, STI, SGEI, VSEI, VSSI, VSTI
_PRIORITY = (11, 3, 7, 9, 1, 5, 12, 10, 2, 6)


@functools.lru_cache(maxsize=None)
def _prio_tables(device):
    codes = torch.tensor(_PRIORITY + (0,), dtype=torch.int64, device=device)
    return codes, 1 << codes[:-1]


def pending_interrupt(csrs, priv, virt):
    """CheckInterrupts(): → (take, cause).  Reads mip/mie + mstatus.MIE/SIE
    + mideleg/hideleg per current privilege (paper Fig 2)."""
    codes, bits = _prio_tables(csrs.device)
    mstatus = csrs[:, C.R_MSTATUS]
    vsstatus = csrs[:, C.R_VSSTATUS]
    pend = csrs[:, C.R_MIP] & csrs[:, C.R_MIE]
    m_enabled = (priv < 3) | (((mstatus & C.MSTATUS_MIE) != 0) & (priv == 3))
    s_enabled = (priv < 1) | ((priv == 1) & ~virt &
                              ((mstatus & C.MSTATUS_SIE) != 0))
    vs_enabled = (virt & (priv < 1)) | \
        (virt & (priv == 1) & ((vsstatus & C.MSTATUS_SIE) != 0))

    p = (pend[:, None] & bits) != 0                       # (B, 10)
    deleg_hs = (csrs[:, C.R_MIDELEG, None] & bits) != 0
    deleg_vs = deleg_hs & ((csrs[:, C.R_HIDELEG, None] & bits) != 0)
    # where would it be handled?  HS-level interrupts always preempt VS
    en = torch.where(~deleg_hs, m_enabled[:, None],
                     torch.where(deleg_vs, (vs_enabled & virt)[:, None],
                                 (s_enabled | (virt & (priv <= 1)))[:, None]))
    fire = p & en
    take = fire.any(1)
    first = torch.where(fire, torch.arange(10, device=csrs.device),
                        10).amin(1)
    return take, codes[first]
