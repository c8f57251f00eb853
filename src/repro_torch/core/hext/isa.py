"""RV64IM + Zicsr + H-extension execute — port of ``repro.core.hext.isa``.

Covers LUI/AUIPC/JAL/JALR/branches, loads/stores (B/H/W/D, aligned),
OP/OP-IMM (+W forms), the M extension (MUL/MULH*/DIV*/REM* + W forms),
CSR instructions, ECALL/EBREAK/SRET/MRET/WFI, SFENCE.VMA,
HFENCE.VVMA/HFENCE.GVMA, and the hypervisor loads/stores
HLV/HLVX/HSV (paper §3.3's forced virtualization and HLVX
execute-permission reads).

As in the reference, execution is staged around the decoded
:class:`decode.MicroOp`: :func:`mem_query` computes the memory-access
intent before translation, :func:`exec_sys` is the separable SYSTEM
contributor, and :func:`execute_uop` merges every opclass contributor into
one :class:`ExecOut` delta that ``machine.retire`` commits.  Every
function works on a (B,) batch of harts.

Division is the one place where int64 carriers need real care: RISC-V
divides truncate, ``torch`` ``//`` floors, integer division by zero raises
on the CPU, and the reference divides absolute values as *unsigned* 64-bit
numbers (``|INT_MIN|`` is negative in int64).  :func:`_divrem_u` is an
exact unsigned 64/64 divide built from non-negative signed divides.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hext import csr as C
from repro_torch.core.hext import decode as D
from repro_torch.core.hext import tlb as TLB
from repro_torch.core.hext import tracing
from repro_torch.core.hext import translate as X
from repro_torch.core.hext.bits import (INT_MIN, lsr, sext, uge, ult,
                                        word_deposit, word_extract,
                                        word_index)


class Fault(NamedTuple):
    fault: torch.Tensor
    cause: torch.Tensor
    tval: torch.Tensor
    tval2: torch.Tensor
    gva: torch.Tensor       # bool
    tinst: torch.Tensor


def no_fault(like):
    """All-clear fault record shaped like the (B,) tensor ``like``."""
    z = torch.zeros_like(like, dtype=torch.int64)
    zb = torch.zeros_like(like, dtype=torch.bool)
    return Fault(zb, z, z, z, zb, z)


def mk_fault(cond, cause, tval=0, tval2=0, gva=False, tinst=0):
    return Fault(cond, cause, tval, tval2, gva, tinst)


def merge_fault(f1: Fault, f2: Fault) -> Fault:
    """f1 wins if set."""
    pick = f1.fault
    return Fault(f1.fault | f2.fault,
                 *(torch.where(pick, a, b) for a, b in zip(f1[1:], f2[1:])))


# ---------------------------------------------------------------------------
# 64-bit helpers (mulh / div semantics) on int64 bit patterns
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def mulhu(a, b):
    """High 64 bits of the unsigned 128-bit product (32-bit halves)."""
    a0, a1 = a & _M32, lsr(a, 32)
    b0, b1 = b & _M32, lsr(b, 32)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    mid = lsr(ll, 32) + (lh & _M32) + (hl & _M32)
    return a1 * b1 + lsr(lh, 32) + lsr(hl, 32) + lsr(mid, 32)


def mulh(a, b):
    return mulhu(a, b) - torch.where(a < 0, b, 0) - torch.where(b < 0, a, 0)


def mulhsu(a, b):
    return mulhu(a, b) - torch.where(a < 0, b, 0)


def _divrem_u(a, b):
    """Unsigned 64/64 → (quotient, remainder) for b ≠ 0 (bit patterns).

    A divisor with its top bit set gives a quotient of 0 or 1.  Otherwise
    a dividend with its top bit set is halved, divided and corrected once
    (the remainder of the halved divide is < 2·b)."""
    big = b < 0
    bp = torch.where(b > 0, b, 1)
    q = torch.where(a >= 0, a // bp, (lsr(a, 1) // bp) << 1)
    r = a - q * bp
    corr = uge(r, bp)
    q = q + corr.long()
    r = torch.where(corr, r - bp, r)
    qb = uge(a, b)
    q = torch.where(big, qb.long(), q)
    r = torch.where(big, torch.where(qb, a - b, a), r)
    return q, r


def _abs_u(a):
    neg = a < 0
    return torch.where(neg, -a, a), neg


def _divrem_s(a, b):
    """Truncating signed divide and remainder, RISC-V semantics (divisor
    0 and INT_MIN / -1 as the reference guards them)."""
    bzero = b == 0
    ovf = (a == INT_MIN) & (b == -1)
    ua, na = _abs_u(a)
    ub, nb = _abs_u(b)
    q, r = _divrem_u(ua, torch.where(bzero, 1, ub))
    qs = torch.where(na ^ nb, -q, q)
    rs = torch.where(na, -r, r)
    return (torch.where(bzero, -1, torch.where(ovf, INT_MIN, qs)),
            torch.where(bzero, a, torch.where(ovf, 0, rs)))


def _divrem_uz(a, b):
    bzero = b == 0
    q, r = _divrem_u(a, torch.where(bzero, 1, b))
    return torch.where(bzero, -1, q), torch.where(bzero, a, r)


def divs(a, b):
    return _divrem_s(a, b)[0]


def rems(a, b):
    return _divrem_s(a, b)[1]


def divu(a, b):
    return _divrem_uz(a, b)[0]


def remu(a, b):
    return _divrem_uz(a, b)[1]


# ---------------------------------------------------------------------------
# TLB fill after a walk
# ---------------------------------------------------------------------------

def tlb_fill(state, va, xr, force_virt=False):
    """Insert the composed translation of a successful walk; ``state``
    holds ``tlb``/``csrs``/``priv``/``virt``."""
    virt_eff = state["virt"] | force_virt
    sum_bit, mxr = X.eff_ctx(state["csrs"], virt_eff)
    perm = TLB.compose_perms(xr.leaf_pte, xr.g_leaf_pte, state["priv"],
                             sum_bit, mxr)
    # guest entries are inserted at 4K granularity (composed two-stage
    # leaf); native entries keep their superpage level
    level = torch.where(virt_eff, 0, xr.level)
    new_tlb = TLB.insert(state["tlb"], va, xr.pa, level, perm, virt_eff,
                         state["priv"], sum_bit, mxr)
    return TLB.select(~xr.fault, new_tlb, state["tlb"])


# MMIO
MMIO_CONSOLE = 0x10000000
MMIO_DONE = 0x10000008
MMIO_CTXSW = 0x10000010          # hypervisor pokes: ctx_switches counter
# CLINT-style timer block (classic SiFive layout)
MMIO_MTIMECMP = 0x10004000
MMIO_MTIME = 0x1000BFF8


# ---------------------------------------------------------------------------
# stage 1: memory-access intent (pre-translation)
# ---------------------------------------------------------------------------

class MemQuery(NamedTuple):
    """The memory-access intent of a micro-op batch, computed *before*
    translation so the pipeline can probe the TLB (and decide whether the
    walk is needed at all) ahead of the executor."""

    any_load: torch.Tensor
    any_store: torch.Tensor
    mem_op: torch.Tensor      # legal explicit access (excl. hlv/hsv traps)
    is_hx: torch.Tensor       # hlv/hsv/hlvx family
    hx_vinst: torch.Tensor
    hx_illegal: torch.Tensor
    addr: torch.Tensor        # VA
    size: torch.Tensor        # log2 bytes
    uns: torch.Tensor         # bool: zero-extend load
    hlvx: torch.Tensor        # bool: execute-permission read
    force_virt: torch.Tensor  # bool: access as if V=1
    macc: torch.Tensor        # ACC_R / ACC_W
    misaligned: torch.Tensor


def mem_query(csrs, priv, virt, uop: D.MicroOp, rv1) -> MemQuery:
    is_load = uop.cls == D.CLS_LOAD
    is_store = uop.cls == D.CLS_STORE
    is_hx = (uop.cls == D.CLS_SYSTEM) & (uop.f3 == 4)
    f7_lsb = (uop.f7 & 1) != 0
    is_hlv = is_hx & ~f7_lsb
    is_hsv = is_hx & f7_lsb
    # hlv/hsv legality: M or HS (or U with hstatus.HU); VS/VU → virtual inst
    hu = (csrs[:, C.R_HSTATUS] & C.HSTATUS_HU) != 0
    hx_legal = (priv == 3) | (~virt & ((priv == 1) | ((priv == 0) & hu)))
    hx_vinst = is_hx & virt
    hx_illegal = is_hx & ~virt & ~hx_legal

    any_load = is_load | is_hlv
    any_store = is_store | is_hsv
    # decode put the I-format imm on loads and the S-format imm on stores;
    # hlv/hsv address directly from rs1
    addr = torch.where(is_hx, rv1, rv1 + uop.imm)
    size = torch.where(is_hx, (uop.f7 >> 1) & 3, uop.f3 & 3)
    uns = torch.where(is_hx, (uop.rs2 & 1) == 1, (uop.f3 & 4) != 0)
    misaligned = (addr & ((1 << size) - 1)) != 0
    return MemQuery(any_load=any_load, any_store=any_store,
                    mem_op=(any_load | any_store) & ~hx_vinst & ~hx_illegal,
                    is_hx=is_hx, hx_vinst=hx_vinst, hx_illegal=hx_illegal,
                    addr=addr, size=size, uns=uns,
                    hlvx=is_hlv & (uop.rs2 == 3), force_virt=is_hx,
                    macc=torch.where(any_store, X.ACC_W, X.ACC_R),
                    misaligned=misaligned)


# ---------------------------------------------------------------------------
# SYSTEM contributor (CSR ops, xRET, WFI, fences)
# ---------------------------------------------------------------------------

class SysOut(NamedTuple):
    """Effects of the SYSTEM (non-hlv/hsv) contributor, pre-gated: for a
    non-SYSTEM micro-op every ``*_set``/flag field is False, so the
    all-False record IS the neutral element (``machine`` substitutes it
    when no hart in the batch runs a SYSTEM op)."""

    fault: Fault
    wb: torch.Tensor          # CSR read value
    do_wb: torch.Tensor
    csrs: torch.Tensor        # full post-op CSR bank (valid when csrs_set)
    csrs_set: torch.Tensor
    pc: torch.Tensor          # xRET target (valid when pc_set)
    pc_set: torch.Tensor
    priv: torch.Tensor        # xRET privilege (valid when pv_set)
    virt: torch.Tensor
    pv_set: torch.Tensor
    halt: torch.Tensor        # WFI with nothing pending
    flush_guest: torch.Tensor   # TLB invalidation: full-scope flushes
    flush_native: torch.Tensor
    flush_guest_addr: torch.Tensor   # rs1≠x0: drop only flush_va's entries
    flush_native_addr: torch.Tensor
    flush_va: torch.Tensor


def neutral_sys(csrs) -> SysOut:
    """All-gates-closed SysOut — exact for every non-SYSTEM micro-op."""
    z = csrs[:, 0].new_zeros(csrs.shape[0])
    zb = torch.zeros_like(z, dtype=torch.bool)
    return SysOut(fault=Fault(zb, z, z, z, zb, z), wb=z, do_wb=zb,
                  csrs=csrs, csrs_set=zb, pc=z, pc_set=zb, priv=z, virt=zb,
                  pv_set=zb, halt=zb, flush_guest=zb, flush_native=zb,
                  flush_guest_addr=zb, flush_native_addr=zb, flush_va=z)


def _with_cols(csrs, cols, vals):
    """A copy of the (B, N_CSR) bank with the given columns replaced."""
    c = csrs.clone()
    for k, v in zip(cols, vals):
        c[:, k] = v
    return c


def exec_sys(csrs, priv, virt, pc, rv1, uop: D.MicroOp) -> SysOut:
    """CSR instructions + privileged ops + fences → :class:`SysOut`."""
    instr = uop.instr
    f3 = uop.f3
    is_sys = uop.cls == D.CLS_SYSTEM
    fault = no_fault(pc)

    # ---------------- CSR ops ---------------------------------------------
    is_csr = is_sys & (f3 != 0) & (f3 != 4)
    csr_addr = (instr >> 20) & 0xFFF
    csr_wdata = torch.where(f3 >= 5, uop.rs1, rv1)
    old, r_ok, r_vinst = C.csr_read(csrs, csr_addr, priv, virt)
    op = f3 & 3
    wval = torch.where(op == 1, csr_wdata,
                       torch.where(op == 2, old | csr_wdata,
                                   old & ~csr_wdata))
    csr_do_write = (op == 1) | (uop.rs1 != 0)
    csrs_w, w_ok, w_vinst = C.csr_write(csrs, csr_addr, wval, priv, virt)
    csr_ok = r_ok & (w_ok | ~csr_do_write)
    csr_vinst = r_vinst | (csr_do_write & w_vinst)
    fault = merge_fault(fault, mk_fault(is_csr & csr_vinst,
                                        C.EXC_VIRTUAL_INSTRUCTION, instr))
    fault = merge_fault(fault, mk_fault(is_csr & ~csr_ok & ~csr_vinst,
                                        C.EXC_ILLEGAL, instr))
    csr_commit = is_csr & csr_ok & csr_do_write
    # satp/vsatp/hgatp writes invalidate cached translations
    atp_write = csr_commit & (
        (csr_addr == 0x180) | (csr_addr == 0x280) | (csr_addr == 0x680))

    # ---------------- priv ops --------------------------------------------
    f7s = uop.f7
    sys0 = is_sys & (f3 == 0)
    is_ecall = sys0 & (instr == 0x00000073)
    is_ebreak = sys0 & (instr == 0x00100073)
    is_sret = sys0 & (instr == 0x10200073)
    is_mret = sys0 & (instr == 0x30200073)
    is_wfi = sys0 & (instr == 0x10500073)
    is_sfence = sys0 & (f7s == 0x09)
    is_hfence_v = sys0 & (f7s == 0x11)   # hfence.vvma
    is_hfence_g = sys0 & (f7s == 0x31)   # hfence.gvma

    mstatus = csrs[:, C.R_MSTATUS]
    hstatus = csrs[:, C.R_HSTATUS]
    user = priv == 0

    ecall_cause = torch.where(priv == 3, C.EXC_ECALL_M,
                              torch.where(user, C.EXC_ECALL_U,
                                          torch.where(virt, C.EXC_ECALL_VS,
                                                      C.EXC_ECALL_S)))
    fault = merge_fault(fault, mk_fault(is_ecall, ecall_cause))
    fault = merge_fault(fault, mk_fault(is_ebreak, C.EXC_BREAK, pc))

    # WFI: TW/VTW trapping
    tw = (mstatus & C.MSTATUS_TW) != 0
    vtw = (hstatus & C.HSTATUS_VTW) != 0
    wfi_illegal = is_wfi & ((tw & (priv < 3)) | user & ~virt)
    wfi_vinst = is_wfi & ~wfi_illegal & virt & (vtw | user)
    wfi_ok = is_wfi & ~wfi_illegal & ~wfi_vinst
    pend_any = (csrs[:, C.R_MIP] & csrs[:, C.R_MIE]) != 0
    halt = wfi_ok & ~pend_any
    fault = merge_fault(fault, mk_fault(wfi_illegal, C.EXC_ILLEGAL, instr))
    fault = merge_fault(fault, mk_fault(wfi_vinst,
                                        C.EXC_VIRTUAL_INSTRUCTION, instr))

    # SRET
    tsr = (mstatus & C.MSTATUS_TSR) != 0
    vtsr = (hstatus & C.HSTATUS_VTSR) != 0
    sret_illegal = is_sret & (user | (tsr & (priv == 1) & ~virt))
    sret_vinst = is_sret & ~sret_illegal & virt & (vtsr | user)
    sret_ok = is_sret & ~sret_illegal & ~sret_vinst
    fault = merge_fault(fault, mk_fault(sret_illegal, C.EXC_ILLEGAL, instr))
    fault = merge_fault(fault, mk_fault(sret_vinst,
                                        C.EXC_VIRTUAL_INSTRUCTION, instr))
    # sret from HS: V ← hstatus.SPV, priv ← sstatus.SPP
    spp = ((mstatus & C.MSTATUS_SPP) != 0).long()
    mst_sret = torch.where((mstatus & C.MSTATUS_SPIE) != 0,
                           mstatus | C.MSTATUS_SIE, mstatus & ~C.MSTATUS_SIE)
    mst_sret = (mst_sret | C.MSTATUS_SPIE) & ~C.MSTATUS_SPP
    spv = (hstatus & C.HSTATUS_SPV) != 0
    hst_sret = hstatus & ~C.HSTATUS_SPV
    # sret from VS (virt): uses vsstatus
    vsstatus = csrs[:, C.R_VSSTATUS]
    vspp = ((vsstatus & C.MSTATUS_SPP) != 0).long()
    vst_sret = torch.where((vsstatus & C.MSTATUS_SPIE) != 0,
                           vsstatus | C.MSTATUS_SIE,
                           vsstatus & ~C.MSTATUS_SIE)
    vst_sret = (vst_sret | C.MSTATUS_SPIE) & ~C.MSTATUS_SPP

    # MRET
    mret_illegal = is_mret & (priv != 3)
    mret_ok = is_mret & ~mret_illegal
    fault = merge_fault(fault, mk_fault(mret_illegal, C.EXC_ILLEGAL, instr))
    mpp = (mstatus & C.MSTATUS_MPP) >> 11
    mpv = (mstatus & C.MSTATUS_MPV) != 0
    mst_mret = torch.where((mstatus & C.MSTATUS_MPIE) != 0,
                           mstatus | C.MSTATUS_MIE, mstatus & ~C.MSTATUS_MIE)
    mst_mret = (mst_mret | C.MSTATUS_MPIE) & ~C.MSTATUS_MPP & \
        ~C.MSTATUS_MPV

    # fences (paper hfence_tests: hfence touches only guest TLB entries).
    # sfence.vma from VS flushes the guest's own (guest-tagged) entries;
    # hfence.{vvma,gvma} from VS raises virtual-instruction; from U illegal.
    is_hf = is_hfence_v | is_hfence_g
    fault = merge_fault(fault, mk_fault((is_hf & virt) |
                                        (is_sfence & virt & user),
                                        C.EXC_VIRTUAL_INSTRUCTION, instr))
    fault = merge_fault(fault, mk_fault((is_hf | is_sfence) & ~virt & user,
                                        C.EXC_ILLEGAL, instr))
    s_up = priv >= 1
    do_hf_v = is_hfence_v & ~virt & s_up
    do_hf_g = is_hfence_g & ~virt & s_up
    do_sf_native = is_sfence & ~virt & s_up
    do_sf_guest = is_sfence & virt & s_up     # guest flushing itself
    # rs1≠x0 narrows sfence.vma / hfence.vvma to the one VA page in rs1;
    # hfence.gvma stays a conservative full flush; ASID/VMID are ignored.
    rs1_nz = uop.rs1 != 0
    guest_fence = do_hf_v | do_sf_guest

    # ---------------- merge -----------------------------------------------
    new_csrs = torch.where(csr_commit[:, None], csrs_w, csrs)
    new_csrs = torch.where(
        (sret_ok & ~virt)[:, None],
        _with_cols(csrs, (C.R_MSTATUS, C.R_HSTATUS), [mst_sret, hst_sret]),
        torch.where((sret_ok & virt)[:, None],
                    _with_cols(csrs, (C.R_VSSTATUS,), [vst_sret]),
                    new_csrs))
    new_csrs = torch.where(mret_ok[:, None],
                           _with_cols(csrs, (C.R_MSTATUS,), [mst_mret]),
                           new_csrs)
    pv_set = sret_ok | mret_ok
    return SysOut(
        fault=fault, wb=old, do_wb=is_csr & csr_ok,
        csrs=new_csrs, csrs_set=csr_commit | pv_set,
        pc=torch.where(sret_ok, torch.where(virt, csrs[:, C.R_VSEPC],
                                            csrs[:, C.R_SEPC]),
                       csrs[:, C.R_MEPC]),
        pc_set=pv_set,
        priv=torch.where(sret_ok, torch.where(virt, vspp, spp), mpp),
        virt=torch.where(sret_ok, virt | spv, (mpp != 3) & mpv),
        pv_set=pv_set, halt=halt,
        flush_guest=atp_write | do_hf_g | (guest_fence & ~rs1_nz),
        flush_native=atp_write | (do_sf_native & ~rs1_nz),
        flush_guest_addr=guest_fence & rs1_nz,
        flush_native_addr=do_sf_native & rs1_nz,
        flush_va=rv1)


# ---------------------------------------------------------------------------
# the executor: opclass contributors → one ExecOut delta record
# ---------------------------------------------------------------------------

class ExecOut(NamedTuple):
    """Per-instruction effect deltas, applied by ``machine.retire`` under
    the batch commit masks; the store is a single conditional scatter
    (``mem_idx``/``mem_word``/``mem_commit``)."""

    fault: Fault
    retired: torch.Tensor
    new_pc: torch.Tensor
    rd: torch.Tensor
    wb: torch.Tensor
    do_wb: torch.Tensor
    csrs: torch.Tensor        # full post-exec CSR bank
    tlb: dict                 # full post-exec TLB (data fill + flushes)
    priv: torch.Tensor
    virt: torch.Tensor
    halt: torch.Tensor
    mem_idx: torch.Tensor     # store target word index
    mem_word: torch.Tensor    # merged word to write
    mem_commit: torch.Tensor
    console_inc: torch.Tensor
    done_set: torch.Tensor
    exit_code: torch.Tensor
    ctxsw_inc: torch.Tensor


def _pick(sel, cands):
    """cands[sel] per hart: sel (B,) in [0, len(cands))."""
    return torch.stack(cands, 1).gather(1, sel[:, None])[:, 0]


def _alu_result(uop: D.MicroOp, rv1, rv2):
    """OP / OP-IMM (+W forms, M extension) → (result, hit)."""
    f3, f7 = uop.f3, uop.f7
    is_alu = uop.cls == D.CLS_ALU
    is_alu32 = uop.cls == D.CLS_ALU32
    is_op = is_alu & ~uop.alu_imm
    is_opi = is_alu & uop.alu_imm
    is_op32 = is_alu32 & ~uop.alu_imm
    alu_b = torch.where(uop.alu_imm, uop.imm, rv2)
    m_ext = (is_op | is_op32) & (f7 == 1)

    sh6 = alu_b & 0x3F
    sh5 = alu_b & 0x1F
    # OP-IMM-64 srai carries shamt[5] in instr bit 25, so its funct7 is
    # 0x20 OR 0x21 — decode the arithmetic bit from funct6 there
    sr_arith = torch.where(is_opi, (f7 & 0x7E) == 0x20, f7 == 0x20)
    addsub = torch.where(is_op & (f7 == 0x20), rv1 - alu_b, rv1 + alu_b)
    r64 = _pick(f3, [addsub, rv1 << sh6, (rv1 < alu_b).long(),
                     ult(rv1, alu_b).long(), rv1 ^ alu_b,
                     torch.where(sr_arith, rv1 >> sh6, lsr(rv1, sh6)),
                     rv1 | alu_b, rv1 & alu_b])
    # M extension 64
    hu = mulhu(rv1, alu_b)
    h_a = torch.where(rv1 < 0, alu_b, 0)
    q_s, r_s = _divrem_s(rv1, alu_b)
    q_u, r_u = _divrem_uz(rv1, alu_b)
    m64 = _pick(f3, [rv1 * alu_b, hu - h_a - torch.where(alu_b < 0, rv1, 0),
                     hu - h_a, hu, q_s, q_u, r_s, r_u])
    r64 = torch.where(m_ext & is_op, m64, r64)
    # 32-bit W forms
    a32 = sext(rv1, 32)
    b32 = sext(alu_b, 32)
    sub32 = is_op32 & (f7 == 0x20)
    addsub32 = sext(torch.where(sub32, a32 - b32, a32 + b32), 32)
    sll32 = sext(a32 << sh5, 32)
    sr32 = torch.where(sr_arith, a32 >> sh5, (a32 & _M32) >> sh5)
    r32 = torch.where(f3 == 1, sll32,
                      torch.where(f3 == 5, sext(sr32, 32),
                                  torch.where(f3 == 0, addsub32,
                                              sext(a32 + b32, 32))))
    # divw truncates THEN sign-extends from bit 31: the overflow quotient
    # INT32_MIN / -1 = +2^31 reads back as sign-extended INT32_MIN
    q32, r32s = _divrem_s(a32, b32)
    ua32, ub32 = rv1 & _M32, alu_b & _M32
    bz32 = ub32 == 0
    ub32p = torch.clamp(ub32, min=1)
    divu32 = torch.where(bz32, -1, sext(ua32 // ub32p, 32))
    remu32 = torch.where(bz32, a32, sext(ua32 % ub32p, 32))
    m32 = _pick(f3, [sext(a32 * b32, 32), remu32, remu32, remu32,
                     sext(q32, 32), divu32, r32s, remu32])
    r32 = torch.where(m_ext & is_op32, m32, r32)
    return torch.where(is_alu, r64, r32), is_alu | is_alu32


def execute_uop(state, uop: D.MicroOp, rv1, rv2, q: MemQuery,
                xr: X.XResult, walked, sys: SysOut,
                data_fill=True) -> ExecOut:
    """Merge all opclass contributors for a decoded micro-op batch.

    ``xr``/``walked`` is the (possibly TLB-short-circuited) data
    translation for ``q.addr``; ``sys`` the (possibly batch-gated) SYSTEM
    contribution.  ``data_fill`` says whether the data walk ran for any
    hart in the batch (``machine.execute`` passes its gate): a Python bool
    (``False``: no hart that commits can fill the TLB, so the fill is
    skipped) or a 0-d device bool that masks the fill, so no host read is
    needed."""
    s = state
    csrs = s["csrs"]
    pc = s["pc"]
    virt = s["virt"]
    cls = uop.cls
    instr = uop.instr
    mem = s["mem"]

    pc4 = pc + 4

    # ---------------- ALU -------------------------------------------------
    alu_res, alu_hit = _alu_result(uop, rv1, rv2)

    # ---------------- LUI / AUIPC / JAL / JALR / branches -----------------
    is_lui = cls == D.CLS_LUI
    is_auipc = cls == D.CLS_AUIPC
    is_jal = cls == D.CLS_JAL
    is_jalr = cls == D.CLS_JALR
    wb = torch.where(alu_hit, alu_res, 0)
    wb = torch.where(is_lui, uop.imm, wb)
    wb = torch.where(is_auipc, pc + uop.imm, wb)
    wb = torch.where(is_jal | is_jalr, pc4, wb)
    do_wb = alu_hit | is_lui | is_auipc | is_jal | is_jalr

    beq = rv1 == rv2
    blt = rv1 < rv2
    bltu = ult(rv1, rv2)
    brt = _pick(uop.f3, [beq, ~beq, ~bltu, ~bltu, blt, ~blt, bltu, ~bltu])
    new_pc = torch.where(is_jal | ((cls == D.CLS_BRANCH) & brt),
                         pc + uop.imm, pc4)
    new_pc = torch.where(is_jalr, (rv1 + uop.imm) & ~1, new_pc)

    # ---------------- loads / stores (incl. hlv/hsv) ----------------------
    addr, size, uns = q.addr, q.size, q.uns
    any_load, any_store = q.any_load, q.any_store
    mem_op = q.mem_op
    # MMIO check (physical): every device register decodes as a whole
    # 8-byte region, so a sub-word access never aliases into RAM
    pa_word = xr.pa & ~7
    is_console = pa_word == MMIO_CONSOLE
    is_done_io = pa_word == MMIO_DONE
    is_ctxsw_io = pa_word == MMIO_CTXSW
    is_mtimecmp_io = pa_word == MMIO_MTIMECMP
    is_mtime_io = pa_word == MMIO_MTIME
    mmio_readable = is_mtimecmp_io | is_mtime_io
    is_mmio = is_console | is_done_io | is_ctxsw_io | mmio_readable
    # final-PA bounds: neither RAM nor a decoded MMIO register is an
    # access fault; loads from the write-only registers are too
    pa_oob = (~is_mmio & uge(xr.pa, mem.shape[1] * 8)) | \
        (any_load & is_mmio & ~mmio_readable)

    mem_idx = word_index(xr.pa, mem.shape[1])
    word0 = mem.gather(1, mem_idx[:, None])[:, 0]
    # CLINT reads: mtime / mtimecmp come from the timer registers
    src_word = torch.where(is_mtime_io, csrs[:, C.R_MTIME],
                           torch.where(is_mtimecmp_io,
                                       csrs[:, C.R_MTIMECMP], word0))
    ld_val = word_extract(src_word, xr.pa, size, uns)
    st_word = word_deposit(word0, xr.pa, rv2, size)

    ok_align = mem_op & ~q.misaligned
    mem_fault_page = ok_align & xr.fault
    mem_fault_oob = ok_align & ~xr.fault & pa_oob

    # tinst for guest page faults: pseudoinstruction for implicit PTE-walk
    # faults, rs1-cleared transform for explicit accesses
    is_gpf = (xr.cause == C.EXC_LGUEST_PAGE_FAULT) | \
             (xr.cause == C.EXC_SGUEST_PAGE_FAULT)
    pseudo = torch.where(any_store, 0x2020, 0x2000)
    tinst = torch.where(xr.implicit, pseudo, instr & ~0xF8000)
    tinst = torch.where(is_gpf, tinst, 0)

    gva_acc = virt | q.force_virt
    f_mem = Fault(mem_fault_page, xr.cause, xr.tval, xr.tval2,
                  xr.gva | (q.force_virt & xr.fault), tinst)
    f_align = Fault(mem_op & q.misaligned,
                    torch.where(any_store, C.EXC_SADDR_MISALIGNED,
                                C.EXC_LADDR_MISALIGNED), addr, 0, gva_acc, 0)
    f_oob = Fault(mem_fault_oob,
                  torch.where(any_store, C.EXC_SACCESS, C.EXC_LACCESS),
                  addr, 0, gva_acc, 0)
    fault = merge_fault(merge_fault(merge_fault(f_align, f_mem), f_oob),
                        no_fault(pc))

    mem_ok = ok_align & ~xr.fault & ~pa_oob
    load_ok = any_load & mem_ok
    store_ok = any_store & mem_ok
    wb = torch.where(load_ok, ld_val, wb)
    do_wb = do_wb | load_ok
    # CLINT writes: size-aware merges into the timer registers
    new_csrs = _with_cols(csrs, (C.R_MTIMECMP, C.R_MTIME), [
        torch.where(store_ok & is_mtimecmp_io,
                    word_deposit(csrs[:, C.R_MTIMECMP], xr.pa, rv2, size),
                    csrs[:, C.R_MTIMECMP]),
        torch.where(store_ok & is_mtime_io,
                    word_deposit(csrs[:, C.R_MTIME], xr.pa, rv2, size),
                    csrs[:, C.R_MTIME])])
    new_tlb = s["tlb"]
    if data_fill is not False:
        with tracing.span("hext.data_walk"):
            fill = mem_ok & walked
            if isinstance(data_fill, torch.Tensor):
                fill = fill & data_fill
            new_tlb = TLB.select(
                fill, tlb_fill(s, addr, xr, force_virt=q.force_virt),
                new_tlb)
    fault = merge_fault(fault, mk_fault(q.hx_vinst,
                                        C.EXC_VIRTUAL_INSTRUCTION, instr))
    fault = merge_fault(fault, mk_fault(q.hx_illegal, C.EXC_ILLEGAL, instr))

    # ---------------- SYSTEM contribution (possibly batch-gated) ----------
    fault = merge_fault(fault, sys.fault)
    wb = torch.where(sys.do_wb, sys.wb, wb)
    do_wb = do_wb | sys.do_wb
    new_csrs = torch.where(sys.csrs_set[:, None], sys.csrs, new_csrs)
    new_pc = torch.where(sys.pc_set, sys.pc, new_pc)
    new_priv = torch.where(sys.pv_set, sys.priv, s["priv"])
    new_virt = torch.where(sys.pv_set, sys.virt, virt)
    new_tlb = TLB.flush_where(new_tlb, sys.flush_guest, sys.flush_native,
                              sys.flush_guest_addr, sys.flush_native_addr,
                              sys.flush_va)

    # ---------------- illegal opcode --------------------------------------
    fault = merge_fault(fault, mk_fault(cls == D.CLS_ILLEGAL,
                                        C.EXC_ILLEGAL, instr))
    return ExecOut(fault=fault, retired=~fault.fault, new_pc=new_pc,
                   rd=uop.rd, wb=wb, do_wb=do_wb, csrs=new_csrs, tlb=new_tlb,
                   priv=new_priv, virt=new_virt, halt=sys.halt,
                   mem_idx=mem_idx, mem_word=st_word,
                   mem_commit=store_ok & ~is_mmio,
                   console_inc=store_ok & is_console,
                   done_set=store_ok & is_done_io, exit_code=rv2,
                   ctxsw_inc=store_ok & is_ctxsw_io)
