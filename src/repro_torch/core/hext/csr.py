"""CSR file for RV64 + H extension (paper §3.1, Table 1) — port of
``repro.core.hext.csr``.

Storage is a flat int64 tensor of shape (B, N_CSR), one row per hart,
indexed by the ``R_*`` constants (bit patterns of the reference's uint64).
The behaviour is the reference's, bit for bit: read masks, WARL write
masks, aliasing (``sstatus`` ⊂ ``mstatus``, ``sip/sie`` ⊂ ``mip/mie``,
``hvip/hip/hie`` and the shifted ``vsip/vsie``), VS swapping under V=1,
the counter-enable gates on ``time``, and the illegal / virtual-
instruction access faults.

The reference expresses a CSR access as a where-chain over every known
address.  Here each address is looked up once in host-built tables:
reads gather one column of a candidate matrix (the raw bank plus the
computed aliases), writes gather the (register, WARL mask, value source)
triple of the address and update that single register — the same
function with a few ops instead of ~45 selects per access.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.hext.bits import s64


# --- privilege encodings ----------------------------------------------------
PRV_U, PRV_S, PRV_M = 0, 1, 3

# --- internal storage indices ------------------------------------------------
(R_MSTATUS, R_MEDELEG, R_MIDELEG, R_MIE, R_MTVEC, R_MSCRATCH, R_MEPC,
 R_MCAUSE, R_MTVAL, R_MIP, R_MTVAL2, R_MTINST,
 R_STVEC, R_SSCRATCH, R_SEPC, R_SCAUSE, R_STVAL, R_SATP, R_SCOUNTEREN,
 R_HSTATUS, R_HEDELEG, R_HIDELEG, R_HVIP, R_HGEIP, R_HGEIE, R_HCOUNTEREN,
 R_HTVAL, R_HTINST, R_HGATP,
 R_VSSTATUS, R_VSTVEC, R_VSSCRATCH, R_VSEPC, R_VSCAUSE, R_VSTVAL, R_VSATP,
 R_MCOUNTEREN, R_MISA,
 R_MTIME, R_MTIMECMP, R_STIMECMP, R_VSTIMECMP, R_HTIMEDELTA,
 N_CSR) = range(44)

# Timer comparators boot disarmed (all-ones): the virtual CLINT only drives
# mip bits for a comparator once software writes it, so workloads that never
# opt in see bit-identical interrupt behavior.
TIMER_DISARMED = (1 << 64) - 1   # carried as s64(...) == -1

# --- architectural CSR addresses ---------------------------------------------
CSR_ADDR = {
    # M
    0x300: R_MSTATUS, 0x301: R_MISA, 0x302: R_MEDELEG, 0x303: R_MIDELEG,
    0x304: R_MIE, 0x305: R_MTVEC, 0x306: R_MCOUNTEREN,
    0x340: R_MSCRATCH, 0x341: R_MEPC, 0x342: R_MCAUSE, 0x343: R_MTVAL,
    0x344: R_MIP, 0x34B: R_MTVAL2, 0x34A: R_MTINST,
    # S (0x100 sstatus / 0x104 sie / 0x144 sip handled as aliases)
    0x105: R_STVEC, 0x106: R_SCOUNTEREN, 0x140: R_SSCRATCH, 0x141: R_SEPC,
    0x142: R_SCAUSE, 0x143: R_STVAL, 0x180: R_SATP,
    # H
    0x600: R_HSTATUS, 0x602: R_HEDELEG, 0x603: R_HIDELEG, 0x604: None,  # hie
    0x605: R_HTIMEDELTA,
    0x606: R_HCOUNTEREN, 0x607: R_HGEIE, 0x643: R_HTVAL, 0x644: None,  # hip
    0x645: R_HVIP, 0x64A: R_HTINST, 0x680: R_HGATP, 0xE12: R_HGEIP,
    # VS
    0x200: R_VSSTATUS, 0x204: None,  # vsie
    0x205: R_VSTVEC, 0x240: R_VSSCRATCH, 0x241: R_VSEPC, 0x242: R_VSCAUSE,
    0x243: R_VSTVAL, 0x244: None,  # vsip
    0x280: R_VSATP,
    # Sstc timers: stimecmp swaps to vstimecmp with V=1 (handled below);
    # time (0xC01) is a read-only view of mtime.
    0x14D: None, 0x24D: R_VSTIMECMP, 0xC01: None,
}

# --- mstatus fields ----------------------------------------------------------
MSTATUS_SIE = 1 << 1
MSTATUS_MIE = 1 << 3
MSTATUS_SPIE = 1 << 5
MSTATUS_MPIE = 1 << 7
MSTATUS_SPP = 1 << 8
MSTATUS_MPP = 3 << 11
MSTATUS_FS = 3 << 13
MSTATUS_SUM = 1 << 18
MSTATUS_MXR = 1 << 19
MSTATUS_TVM = 1 << 20
MSTATUS_TW = 1 << 21
MSTATUS_TSR = 1 << 22
MSTATUS_MPV = 1 << 39   # H: previous virtualization mode
MSTATUS_GVA = 1 << 38   # H: guest virtual address

SSTATUS_MASK = (MSTATUS_SIE | MSTATUS_SPIE | MSTATUS_SPP | MSTATUS_FS |
                MSTATUS_SUM | MSTATUS_MXR)
MSTATUS_WMASK = (SSTATUS_MASK | MSTATUS_MIE | MSTATUS_MPIE | MSTATUS_MPP |
                 MSTATUS_TVM | MSTATUS_TW | MSTATUS_TSR | MSTATUS_MPV |
                 MSTATUS_GVA)

# --- hstatus fields ----------------------------------------------------------
HSTATUS_VSBE = 1 << 5
HSTATUS_GVA = 1 << 6
HSTATUS_SPV = 1 << 7     # supervisor previous virtualization
HSTATUS_SPVP = 1 << 8    # supervisor previous virtual privilege
HSTATUS_HU = 1 << 9      # hypervisor-in-U (allows hlv/hsv from U)
HSTATUS_VTVM = 1 << 20
HSTATUS_VTW = 1 << 21
HSTATUS_VTSR = 1 << 22
HSTATUS_WMASK = (HSTATUS_GVA | HSTATUS_SPV | HSTATUS_SPVP | HSTATUS_HU |
                 HSTATUS_VTVM | HSTATUS_VTW | HSTATUS_VTSR)

# --- counter-enable bits (mcounteren/hcounteren/scounteren) ------------------
COUNTEREN_CY = 1 << 0
COUNTEREN_TM = 1 << 1
COUNTEREN_IR = 1 << 2

# --- interrupt bits (mip/mie layout) -----------------------------------------
IP_SSIP = 1 << 1
IP_VSSIP = 1 << 2
IP_MSIP = 1 << 3
IP_STIP = 1 << 5
IP_VSTIP = 1 << 6
IP_MTIP = 1 << 7
IP_SEIP = 1 << 9
IP_VSEIP = 1 << 10
IP_MEIP = 1 << 11
IP_SGEIP = 1 << 12

HS_INTERRUPTS = IP_VSSIP | IP_VSTIP | IP_VSEIP | IP_SGEIP   # hip/hvip-visible
VS_INTERRUPTS = IP_VSSIP | IP_VSTIP | IP_VSEIP
S_INTERRUPTS = IP_SSIP | IP_STIP | IP_SEIP
HVIP_WMASK = VS_INTERRUPTS                                  # hvip writable bits
# mideleg: VS-level interrupts + SGEI are *read-only one* with H (paper §3.1:
# "new read-only 1-bit fields ... these interrupts are now handled by HS")
MIDELEG_FORCED = HS_INTERRUPTS
MIDELEG_WMASK = S_INTERRUPTS
MIP_WMASK = IP_SSIP | IP_STIP | IP_SEIP | VS_INTERRUPTS | IP_MSIP | IP_MTIP
MIE_WMASK = MIP_WMASK | IP_MEIP | IP_SGEIP

# hideleg: only VS-level interrupts delegable to VS
HIDELEG_WMASK = VS_INTERRUPTS

# --- exception causes ---------------------------------------------------------
EXC_IADDR_MISALIGNED = 0
EXC_IACCESS = 1
EXC_ILLEGAL = 2
EXC_BREAK = 3
EXC_LADDR_MISALIGNED = 4
EXC_LACCESS = 5
EXC_SADDR_MISALIGNED = 6
EXC_SACCESS = 7
EXC_ECALL_U = 8
EXC_ECALL_S = 9         # ecall from HS (or S)
EXC_ECALL_VS = 10       # ecall from VS
EXC_ECALL_M = 11
EXC_IPAGE_FAULT = 12
EXC_LPAGE_FAULT = 13
EXC_SPAGE_FAULT = 15
EXC_IGUEST_PAGE_FAULT = 20
EXC_LGUEST_PAGE_FAULT = 21
EXC_VIRTUAL_INSTRUCTION = 22
EXC_SGUEST_PAGE_FAULT = 23

# hedeleg cannot delegate guest-page-faults / ecalls-from-HS etc. to VS
HEDELEG_WMASK = ((1 << EXC_IADDR_MISALIGNED) | (1 << EXC_IACCESS) |
                 (1 << EXC_ILLEGAL) | (1 << EXC_BREAK) |
                 (1 << EXC_LADDR_MISALIGNED) | (1 << EXC_LACCESS) |
                 (1 << EXC_SADDR_MISALIGNED) | (1 << EXC_SACCESS) |
                 (1 << EXC_ECALL_U) | (1 << EXC_IPAGE_FAULT) |
                 (1 << EXC_LPAGE_FAULT) | (1 << EXC_SPAGE_FAULT))
MEDELEG_WMASK = HEDELEG_WMASK | (1 << EXC_ECALL_S) | (1 << EXC_ECALL_VS) | \
    (1 << EXC_VIRTUAL_INSTRUCTION) | (1 << EXC_IGUEST_PAGE_FAULT) | \
    (1 << EXC_LGUEST_PAGE_FAULT) | (1 << EXC_SGUEST_PAGE_FAULT)

INT_BIT = 1 << 63

# satp/hgatp/vsatp
ATP_MODE_SHIFT = 60
ATP_MODE_SV39 = 8
ATP_PPN_MASK = (1 << 44) - 1



# --- host-built access tables --------------------------------------------------
# Read candidates: columns 0..N_CSR-1 are the raw bank; the computed
# aliases follow.
(_C_SSTATUS, _C_VSSTATUS, _C_SIP, _C_SIE, _C_HIP, _C_HIE, _C_HVIP, _C_VSIP,
 _C_VSIE, _C_TIME, _C_VTIME) = range(N_CSR, N_CSR + 11)

# VS swapping: with V=1, supervisor addresses hit the vs bank
_READ_SWAP = {0x105: R_VSTVEC, 0x140: R_VSSCRATCH, 0x141: R_VSEPC,
              0x142: R_VSCAUSE, 0x143: R_VSTVAL, 0x180: R_VSATP}
_READ_ALIAS = {  # addr: (native column, V=1 column)
    0x100: (_C_SSTATUS, _C_VSSTATUS), 0x104: (_C_SIE, _C_VSIE),
    0x144: (_C_SIP, _C_VSIP), 0x604: (_C_HIE, _C_HIE),
    0x644: (_C_HIP, _C_HIP), 0x645: (_C_HVIP, _C_HVIP),
    0x204: (_C_VSIE, _C_VSIE), 0x244: (_C_VSIP, _C_VSIP),
    0xC01: (_C_TIME, _C_VTIME), 0x14D: (R_STIMECMP, R_VSTIMECMP)}

# Write value sources: the operand, or the vsie/vsip operand shifted up to
# the VS bit positions and gated by hideleg.
_V, _V_VSIE, _V_VSIP = 0, 1, 2
_FULL = -1
_NO_BIT0 = -2          # ~1: xepc bit 0 is hard-wired to zero


def _write_cases():
    """addr → ((reg, mask, source) native, (reg, mask, source) V=1).
    mask 0 is a legal write that changes nothing (read-only CSRs)."""
    both = {
        0x300: (R_MSTATUS, MSTATUS_WMASK, _V),
        0x200: (R_VSSTATUS, SSTATUS_MASK, _V),
        0x204: (R_MIE, VS_INTERRUPTS, _V_VSIE),
        0x304: (R_MIE, MIE_WMASK, _V),
        0x604: (R_MIE, HS_INTERRUPTS, _V),
        0x244: (R_MIP, IP_VSSIP, _V_VSIP),
        0x344: (R_MIP, MIP_WMASK, _V),
        0x645: (R_MIP, HVIP_WMASK, _V),     # hvip aliases mip VS bits
        0x644: (R_MIP, IP_VSSIP, _V),       # hip: only VSSIP writable
        0x302: (R_MEDELEG, MEDELEG_WMASK, _V),
        0x303: (R_MIDELEG, MIDELEG_WMASK, _V),   # VS bits read-only-1
        0x602: (R_HEDELEG, HEDELEG_WMASK, _V),
        0x603: (R_HIDELEG, HIDELEG_WMASK, _V),
        0x305: (R_MTVEC, _FULL, _V), 0x306: (R_MCOUNTEREN, _FULL, _V),
        0x340: (R_MSCRATCH, _FULL, _V), 0x341: (R_MEPC, _NO_BIT0, _V),
        0x342: (R_MCAUSE, _FULL, _V), 0x343: (R_MTVAL, _FULL, _V),
        0x34B: (R_MTVAL2, _FULL, _V), 0x34A: (R_MTINST, _FULL, _V),
        0x106: (R_SCOUNTEREN, _FULL, _V),
        0x600: (R_HSTATUS, HSTATUS_WMASK, _V),
        0x605: (R_HTIMEDELTA, _FULL, _V), 0x606: (R_HCOUNTEREN, _FULL, _V),
        0x607: (R_HGEIE, _FULL, _V), 0x643: (R_HTVAL, _FULL, _V),
        0x64A: (R_HTINST, _FULL, _V), 0x680: (R_HGATP, _FULL, _V),
        0x205: (R_VSTVEC, _FULL, _V), 0x240: (R_VSSCRATCH, _FULL, _V),
        0x241: (R_VSEPC, _NO_BIT0, _V), 0x242: (R_VSCAUSE, _FULL, _V),
        0x243: (R_VSTVAL, _FULL, _V), 0x280: (R_VSATP, _FULL, _V),
        0x24D: (R_VSTIMECMP, _FULL, _V),
        # read-only: the write is ignored but legal (misa/hgeip at M);
        # time faults through the read-only-region check
        0xE12: (0, 0, _V), 0x301: (0, 0, _V), 0xC01: (0, 0, _V),
    }
    cases = {a: (c, c) for a, c in both.items()}
    cases[0x100] = ((R_MSTATUS, SSTATUS_MASK, _V),
                    (R_VSSTATUS, SSTATUS_MASK, _V))
    cases[0x104] = ((R_MIE, S_INTERRUPTS, _V),
                    (R_MIE, VS_INTERRUPTS, _V_VSIE))
    cases[0x144] = ((R_MIP, IP_SSIP, _V), (R_MIP, IP_VSSIP, _V_VSIP))
    swap = {0x105: (R_STVEC, R_VSTVEC), 0x140: (R_SSCRATCH, R_VSSCRATCH),
            0x141: (R_SEPC, R_VSEPC), 0x142: (R_SCAUSE, R_VSCAUSE),
            0x143: (R_STVAL, R_VSTVAL), 0x180: (R_SATP, R_VSATP),
            0x14D: (R_STIMECMP, R_VSTIMECMP)}
    for a, (si, vi) in swap.items():
        m = _NO_BIT0 if a == 0x141 else _FULL
        cases[a] = ((si, m, _V), (vi, m, _V))
    return cases


def _build_tables():
    rd = np.full((2, 4096), -1, np.int64)          # [virt, addr] → column
    for a, (n_col, v_col) in _READ_ALIAS.items():
        rd[0, a], rd[1, a] = n_col, v_col
    for a, idx in CSR_ADDR.items():
        if a not in _READ_ALIAS and idx is not None:
            rd[0, a] = idx
            rd[1, a] = _READ_SWAP.get(a, idx)
    wr = np.zeros((2, 4096, 4), np.int64)          # known, reg, mask, source
    for a, cases in _write_cases().items():
        for v, (reg, mask, src) in enumerate(cases):
            wr[v, a] = (1, reg, s64(mask), src)
    return rd, wr


_READ_TAB, _WRITE_TAB = _build_tables()


@functools.lru_cache(maxsize=None)
def _tables(device):
    return (torch.as_tensor(_READ_TAB, device=device),
            torch.as_tensor(_WRITE_TAB, device=device))


def init_csrs(batch: int, device) -> torch.Tensor:
    """Power-on CSR bank for ``batch`` harts: (B, N_CSR) int64."""
    c = torch.zeros((batch, N_CSR), dtype=torch.int64, device=device)
    # misa: RV64 + H + I + M + S + U
    misa = (2 << 62) | (1 << 7) | (1 << 8) | (1 << 12) | (1 << 18) | (1 << 20)
    c[:, R_MISA] = s64(misa)
    c[:, R_MIDELEG] = MIDELEG_FORCED          # forced-one VS bits
    for r in (R_MTIMECMP, R_STIMECMP, R_VSTIMECMP):
        c[:, r] = s64(TIMER_DISARMED)
    return c


def csr_min_priv(addr):
    """CSR address bits [9:8] encode the minimum privilege."""
    return (addr >> 8) & 3


def _addr_row(addr):
    """(in-range mask, clamped index) of a CSR address tensor."""
    in_rng = (addr >= 0) & (addr < 4096)
    return in_rng, torch.clamp(addr, 0, 4095)


def _h_vinst(csrs, a, priv, virt):
    """Common privilege gate: (required priv, virtual-instruction fault)."""
    minp = csr_min_priv(a)
    is_h_csr = minp == 2
    req = torch.where(is_h_csr, 1, minp)
    lower = priv < 3
    vinst = virt & is_h_csr & lower
    # hstatus.VTVM: VS access to satp traps as virtual instruction
    vtvm = (csrs[:, R_HSTATUS] & HSTATUS_VTVM) != 0
    vinst = vinst | (virt & (a == 0x180) & vtvm & lower)
    return req, vinst


def csr_read(csrs, addr, priv, virt):
    """→ (value, ok, vinst_fault), each (B,).

    ok=False → illegal instruction; vinst_fault → virtual-instruction trap
    (V=1 access to H/S-above CSRs)."""
    a = addr
    rd_tab, _ = _tables(csrs.device)
    mstatus = csrs[:, R_MSTATUS]
    mip = csrs[:, R_MIP]
    mie = csrs[:, R_MIE]
    hideleg = csrs[:, R_HIDELEG]
    mideleg = csrs[:, R_MIDELEG]
    mtime = csrs[:, R_MTIME]
    computed = torch.stack([
        mstatus & SSTATUS_MASK,                       # sstatus
        csrs[:, R_VSSTATUS] & SSTATUS_MASK,           # vsstatus view
        mip & mideleg & S_INTERRUPTS,                 # sip
        mie & mideleg & S_INTERRUPTS,                 # sie
        mip & HS_INTERRUPTS,                          # hip
        mie & HS_INTERRUPTS,                          # hie
        mip & VS_INTERRUPTS,                          # hvip
        # vsip/vsie: VS bits shifted down 1 to S positions, gated by hideleg
        (mip & hideleg & VS_INTERRUPTS) >> 1,
        (mie & hideleg & VS_INTERRUPTS) >> 1,
        # time: read-only view of mtime; under V=1 the guest sees the
        # hypervisor-shifted time base mtime + htimedelta
        mtime,
        mtime + csrs[:, R_HTIMEDELTA],
    ], 1)
    cand = torch.cat([csrs, computed], 1)
    in_rng, ac = _addr_row(a)
    col = rd_tab[virt.long(), ac]
    known = in_rng & (col >= 0)
    val = cand.gather(1, torch.clamp(col, min=0)[:, None])[:, 0]
    val = torch.where(known, val, 0)

    req, vinst = _h_vinst(csrs, a, priv, virt)
    # time (0xC01) is gated by the counter-enable TM bits: mcounteren for
    # any sub-M read, scounteren additionally for U/VU, and hcounteren for
    # V=1 (mcounteren clear → illegal; hcounteren/scounteren clear under
    # V=1 → virtual instruction, per the H spec's counter-access rules).
    tm_m = (csrs[:, R_MCOUNTEREN] & COUNTEREN_TM) != 0
    tm_h = (csrs[:, R_HCOUNTEREN] & COUNTEREN_TM) != 0
    tm_s = (csrs[:, R_SCOUNTEREN] & COUNTEREN_TM) != 0
    is_time = a == 0xC01
    user = priv == 0
    time_ill = is_time & (priv < 3) & (~tm_m | (~virt & user & ~tm_s))
    time_vinst = is_time & virt & tm_m & (~tm_h | (user & ~tm_s))
    vinst = vinst | time_vinst
    ok = known & (priv >= req) & ~vinst & ~time_ill
    return val, ok, vinst & known


def csr_write(csrs, addr, value, priv, virt):
    """→ (new_csrs, ok, vinst_fault).  Applies the WARL write mask of the
    addressed register (aliases and VS swapping included)."""
    a = addr
    _, wr_tab = _tables(csrs.device)
    in_rng, ac = _addr_row(a)
    row = wr_tab[virt.long(), ac]                  # (B, 4)
    known = in_rng & (row[:, 0] != 0)
    reg = row[:, 1:2]
    mask = torch.where(in_rng, row[:, 2], 0)
    src = row[:, 3]
    shifted = (value << 1) & csrs[:, R_HIDELEG]
    val = torch.where(src == _V, value,
                      torch.where(src == _V_VSIE, shifted & VS_INTERRUPTS,
                                  shifted & IP_VSSIP))
    old = csrs.gather(1, reg)[:, 0]
    nv = (old & ~mask) | (val & mask)
    new = csrs.scatter(1, reg, nv[:, None])

    req, vinst = _h_vinst(csrs, a, priv, virt)
    read_only = (a >> 10) == 3    # addr[11:10]==11 → read-only region
    ok = known & (priv >= req) & ~vinst & ~read_only
    return new, ok, vinst & known
