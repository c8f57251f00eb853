"""The benchmark's reference: a pure-Python architectural model of the
hext machine, frozen from the port's oracle (``repro_torch.core.hext.
oracle``) with the constants it needs copied into :mod:`.consts`.  It
imports nothing of ``repro_torch``, of the JAX package or of JAX, and
needs neither torch nor numpy.

Both sides boot the same memory image from reset (built by the frozen
assembler, :mod:`.programs`); ``portbench.check`` steps this model over
each job and compares its state with what the port produced.

Scope (what the model predicts, and the check compares):
  pc, x1..x31, priv, virt, halted, the full CSR file, memory, done /
  exit_code / console, the counters instret / instret_virt /
  exc_by_level / int_by_level / pagefaults / ticks / timer_irqs /
  ctx_switches / walks, and the software TLB.

The model carries the machine's software TLB (guest/native tagging,
priv/SUM/MXR context tags, per-level VPN masks, round-robin replacement,
scoped invalidation), so ``walks`` and the architectural side effects of
stale cached translations are compared exactly.  It mirrors the
machine's documented semantics including its WARL masks, aliasing and
decode quirks (unknown SYSTEM f3=0 encodings retire as no-ops).
``st["events"]`` (trap/fence/atp-write signatures) is bookkeeping only
and never compared.
"""
from __future__ import annotations

from typing import Dict, List

from portbench.reference import consts as C

X = _isa = C

M64 = (1 << 64) - 1

# convenient local names ------------------------------------------------------
ACC_R, ACC_W, ACC_X = X.ACC_R, X.ACC_W, X.ACC_X
PTE_V, PTE_R, PTE_W, PTE_X = X.PTE_V, X.PTE_R, X.PTE_W, X.PTE_X
PTE_U, PTE_A, PTE_D = X.PTE_U, X.PTE_A, X.PTE_D
ALL_PERM_PTE = X.ALL_PERM_PTE

MMIO_CONSOLE = _isa.MMIO_CONSOLE
MMIO_DONE = _isa.MMIO_DONE
MMIO_CTXSW = _isa.MMIO_CTXSW
MMIO_MTIMECMP = _isa.MMIO_MTIMECMP
MMIO_MTIME = _isa.MMIO_MTIME


def u64(x: int) -> int:
    return x & M64


def sext(x: int, bits: int) -> int:
    """Sign-extend the low `bits` of x into a uint64 (two's complement)."""
    x &= (1 << bits) - 1
    m = 1 << (bits - 1)
    return u64((x ^ m) - m)


def s64(x: int) -> int:
    """uint64 → signed python int."""
    x &= M64
    return x - (1 << 64) if x >= (1 << 63) else x


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

N_TLB = 16
PERM_R, PERM_W, PERM_X = 1, 2, 4


def init_tlb() -> Dict:
    """Empty software-TLB model (mirror of ``tlb.init_tlb``)."""
    return {
        "vpn": [0] * N_TLB,
        "ppn": [0] * N_TLB,
        "level": [0] * N_TLB,
        "perm": [0] * N_TLB,
        "guest": [False] * N_TLB,
        "priv": [0] * N_TLB,
        "sum": [False] * N_TLB,
        "mxr": [False] * N_TLB,
        "valid": [False] * N_TLB,
        "ptr": 0,
    }


def reset_state(image) -> Dict:
    """Power-on state with a memory image loaded (pc=0, M mode)."""
    return {
        "pc": 0,
        "regs": [0] * 32,
        "csrs": init_csrs(),
        "priv": 3,
        "virt": False,
        "mem": [int(w) for w in image],
        "tlb": init_tlb(),
        "halted": False,
        "done": False,
        "exit_code": 0,
        "console": 0,
        "instret": 0,
        "instret_virt": 0,
        "exc_by_level": [0, 0, 0],
        "int_by_level": [0, 0, 0],
        "pagefaults": 0,
        "walks": 0,
        "ticks": 0,
        "timer_irqs": 0,
        "ctx_switches": 0,
        "events": set(),
    }


def resume_state(snap: Dict) -> Dict:
    """Oracle state adopted from a host-side machine snapshot (the
    ``OracleEngine`` adapter path, and the restore side of a gem5-style
    checkpoint): same keys as :func:`reset_state`, but every field comes
    from the snapshot instead of power-on values, so the oracle can take
    over a run mid-flight.  Values are re-masked to uint64 defensively,
    and the fixed-size fields (regs, csrs, the by-level counters) are
    length-checked so a truncated snapshot fails loudly here rather than
    as an IndexError mid-run (``mem`` is legitimately variable-size)."""
    if len(snap["regs"]) != 32:
        raise ValueError(f"regs must have 32 entries, "
                         f"got {len(snap['regs'])}")
    if len(snap["csrs"]) != C.N_CSR:
        raise ValueError(f"csrs must have {C.N_CSR} entries, "
                         f"got {len(snap['csrs'])}")
    for k in ("exc_by_level", "int_by_level"):
        if len(snap[k]) != 3:
            raise ValueError(f"{k} must have 3 entries (M/HS/VS), "
                             f"got {len(snap[k])}")
    tlb_in = snap.get("tlb")
    if tlb_in is None:
        tlb = init_tlb()                  # pre-TLB snapshot: cold TLB
    else:
        if len(tlb_in["valid"]) != N_TLB:
            raise ValueError(f"tlb must have {N_TLB} entries, "
                             f"got {len(tlb_in['valid'])}")
        tlb = {
            "vpn": [u64(int(x)) for x in tlb_in["vpn"]],
            "ppn": [u64(int(x)) for x in tlb_in["ppn"]],
            "level": [int(x) for x in tlb_in["level"]],
            "perm": [int(x) for x in tlb_in["perm"]],
            "guest": [bool(x) for x in tlb_in["guest"]],
            "priv": [int(x) for x in tlb_in["priv"]],
            "sum": [bool(x) for x in tlb_in["sum"]],
            "mxr": [bool(x) for x in tlb_in["mxr"]],
            "valid": [bool(x) for x in tlb_in["valid"]],
            "ptr": int(tlb_in["ptr"]),
        }
    return {
        "pc": u64(int(snap["pc"])),
        "regs": [u64(int(x)) for x in snap["regs"]],
        "csrs": [u64(int(x)) for x in snap["csrs"]],
        "priv": int(snap["priv"]),
        "virt": bool(snap["virt"]),
        "mem": [u64(int(w)) for w in snap["mem"]],
        "tlb": tlb,
        "halted": bool(snap["halted"]),
        "done": bool(snap["done"]),
        "exit_code": u64(int(snap["exit_code"])),
        "console": int(snap["console"]),
        "instret": int(snap["instret"]),
        "instret_virt": int(snap["instret_virt"]),
        "exc_by_level": [int(x) for x in snap["exc_by_level"]],
        "int_by_level": [int(x) for x in snap["int_by_level"]],
        "pagefaults": int(snap["pagefaults"]),
        "walks": int(snap.get("walks", 0)),
        "ticks": int(snap["ticks"]),
        "timer_irqs": int(snap["timer_irqs"]),
        "ctx_switches": int(snap["ctx_switches"]),
        "events": set(),
    }


def init_csrs() -> List[int]:
    c = [0] * C.N_CSR
    c[C.R_MISA] = u64((2 << 62) | (1 << 7) | (1 << 8) | (1 << 12) |
                      (1 << 18) | (1 << 20))
    c[C.R_MIDELEG] = C.MIDELEG_FORCED
    for r in (C.R_MTIMECMP, C.R_STIMECMP, C.R_VSTIMECMP):
        c[r] = C.TIMER_DISARMED
    return c


# ---------------------------------------------------------------------------
# CSR file (port of csr.csr_read / csr.csr_write)
# ---------------------------------------------------------------------------

_SWAP_READ = {0x100: C.R_VSSTATUS, 0x105: C.R_VSTVEC, 0x140: C.R_VSSCRATCH,
              0x141: C.R_VSEPC, 0x142: C.R_VSCAUSE, 0x143: C.R_VSTVAL,
              0x180: C.R_VSATP}


def _csr_priv_vinst(csrs, a, priv, virt):
    minp = (a >> 8) & 3
    is_h = minp == 2
    req = 1 if is_h else minp
    vinst = virt and is_h and priv < 3
    vtvm = (csrs[C.R_HSTATUS] & C.HSTATUS_VTVM) != 0
    vinst = vinst or (virt and a == 0x180 and vtvm and priv < 3)
    return req, vinst


def csr_read(csrs, a, priv, virt):
    """→ (value, ok, vinst)."""
    mstatus = csrs[C.R_MSTATUS]
    mip, mie = csrs[C.R_MIP], csrs[C.R_MIE]
    mideleg, hideleg = csrs[C.R_MIDELEG], csrs[C.R_HIDELEG]

    val, known = 0, False
    if a == 0x100:
        val = (csrs[C.R_VSSTATUS] if virt else mstatus) & C.SSTATUS_MASK
        known = True
    elif a == 0x104:
        val = ((mie & hideleg & C.VS_INTERRUPTS) >> 1) if virt else \
            (mie & mideleg & C.S_INTERRUPTS)
        known = True
    elif a == 0x144:
        val = ((mip & hideleg & C.VS_INTERRUPTS) >> 1) if virt else \
            (mip & mideleg & C.S_INTERRUPTS)
        known = True
    elif a == 0x604:
        val, known = mie & C.HS_INTERRUPTS, True
    elif a == 0x644:
        val, known = mip & C.HS_INTERRUPTS, True
    elif a == 0x645:
        val, known = mip & C.VS_INTERRUPTS, True
    elif a == 0x204:
        val, known = (mie & hideleg & C.VS_INTERRUPTS) >> 1, True
    elif a == 0x244:
        val, known = (mip & hideleg & C.VS_INTERRUPTS) >> 1, True
    elif a == 0xC01:
        val = u64(csrs[C.R_MTIME] + csrs[C.R_HTIMEDELTA]) if virt else \
            csrs[C.R_MTIME]
        known = True
    elif a == 0x14D:
        val = csrs[C.R_VSTIMECMP] if virt else csrs[C.R_STIMECMP]
        known = True
    elif a in C.CSR_ADDR and C.CSR_ADDR[a] is not None:
        idx = C.CSR_ADDR[a]
        if virt and a in _SWAP_READ:
            idx = _SWAP_READ[a]
        val, known = csrs[idx], True

    req, vinst = _csr_priv_vinst(csrs, a, priv, virt)
    # time (0xC01) counter-enable gating
    tm_m = (csrs[C.R_MCOUNTEREN] & C.COUNTEREN_TM) != 0
    tm_h = (csrs[C.R_HCOUNTEREN] & C.COUNTEREN_TM) != 0
    tm_s = (csrs[C.R_SCOUNTEREN] & C.COUNTEREN_TM) != 0
    is_time = a == 0xC01
    time_ill = is_time and priv < 3 and (
        not tm_m or (not virt and priv == 0 and not tm_s))
    time_vinst = is_time and virt and tm_m and (
        not tm_h or (priv == 0 and not tm_s))
    vinst = vinst or time_vinst
    ok = known and priv >= req and not vinst and not time_ill
    return val, ok, vinst and known


def _wr(csrs, idx, val, mask):
    csrs[idx] = u64((csrs[idx] & ~mask) | (val & mask))


def csr_write(csrs, a, v, priv, virt):
    """→ (new_csrs(list), ok, vinst). Pure: returns a fresh list."""
    new = list(csrs)
    hideleg = csrs[C.R_HIDELEG]
    known = True
    full = M64

    if a == 0x300:
        _wr(new, C.R_MSTATUS, v, C.MSTATUS_WMASK)
    elif a == 0x100:
        _wr(new, C.R_VSSTATUS if virt else C.R_MSTATUS, v, C.SSTATUS_MASK)
    elif a == 0x200:
        _wr(new, C.R_VSSTATUS, v, C.SSTATUS_MASK)
    elif a == 0x104:
        if virt:
            _wr(new, C.R_MIE, (v << 1) & hideleg & C.VS_INTERRUPTS,
                C.VS_INTERRUPTS)
        else:
            _wr(new, C.R_MIE, v, C.S_INTERRUPTS)
    elif a == 0x204:
        _wr(new, C.R_MIE, (v << 1) & hideleg & C.VS_INTERRUPTS,
            C.VS_INTERRUPTS)
    elif a == 0x304:
        _wr(new, C.R_MIE, v, C.MIE_WMASK)
    elif a == 0x604:
        _wr(new, C.R_MIE, v, C.HS_INTERRUPTS)
    elif a == 0x144:
        if virt:
            _wr(new, C.R_MIP, (v << 1) & hideleg & C.IP_VSSIP, C.IP_VSSIP)
        else:
            _wr(new, C.R_MIP, v, C.IP_SSIP)
    elif a == 0x244:
        _wr(new, C.R_MIP, (v << 1) & hideleg & C.IP_VSSIP, C.IP_VSSIP)
    elif a == 0x344:
        _wr(new, C.R_MIP, v, C.MIP_WMASK)
    elif a == 0x645:
        _wr(new, C.R_MIP, v, C.HVIP_WMASK)
    elif a == 0x644:
        _wr(new, C.R_MIP, v, C.IP_VSSIP)
    elif a == 0x302:
        _wr(new, C.R_MEDELEG, v, C.MEDELEG_WMASK)
    elif a == 0x303:
        _wr(new, C.R_MIDELEG, v, C.MIDELEG_WMASK)
    elif a == 0x602:
        _wr(new, C.R_HEDELEG, v, C.HEDELEG_WMASK)
    elif a == 0x603:
        _wr(new, C.R_HIDELEG, v, C.HIDELEG_WMASK)
    elif a in _PLAIN_W:
        idx, mask = _PLAIN_W[a]
        _wr(new, idx, v, mask)
    elif a in _SWAP_W:
        sidx, vidx = _SWAP_W[a]
        mask = ~1 & M64 if a == 0x141 else full
        _wr(new, vidx if virt else sidx, v, mask)
    elif a in (0xE12, 0x301, 0xC01):
        pass                       # read-only / write-ignored
    else:
        known = False

    req, vinst = _csr_priv_vinst(csrs, a, priv, virt)
    read_only = (a >> 10) == 3
    ok = known and priv >= req and not vinst and not read_only
    return new, ok, vinst and known


_PLAIN_W = {0x305: (C.R_MTVEC, M64), 0x306: (C.R_MCOUNTEREN, M64),
            0x340: (C.R_MSCRATCH, M64), 0x341: (C.R_MEPC, ~1 & M64),
            0x342: (C.R_MCAUSE, M64), 0x343: (C.R_MTVAL, M64),
            0x34B: (C.R_MTVAL2, M64), 0x34A: (C.R_MTINST, M64),
            0x106: (C.R_SCOUNTEREN, M64),
            0x600: (C.R_HSTATUS, C.HSTATUS_WMASK),
            0x605: (C.R_HTIMEDELTA, M64), 0x606: (C.R_HCOUNTEREN, M64),
            0x607: (C.R_HGEIE, M64), 0x643: (C.R_HTVAL, M64),
            0x64A: (C.R_HTINST, M64), 0x680: (C.R_HGATP, M64),
            0x205: (C.R_VSTVEC, M64), 0x240: (C.R_VSSCRATCH, M64),
            0x241: (C.R_VSEPC, ~1 & M64), 0x242: (C.R_VSCAUSE, M64),
            0x243: (C.R_VSTVAL, M64), 0x280: (C.R_VSATP, M64),
            0x24D: (C.R_VSTIMECMP, M64)}
_SWAP_W = {0x105: (C.R_STVEC, C.R_VSTVEC), 0x140: (C.R_SSCRATCH,
           C.R_VSSCRATCH), 0x141: (C.R_SEPC, C.R_VSEPC),
           0x142: (C.R_SCAUSE, C.R_VSCAUSE), 0x143: (C.R_STVAL, C.R_VSTVAL),
           0x180: (C.R_SATP, C.R_VSATP),
           0x14D: (C.R_STIMECMP, C.R_VSTIMECMP)}


# ---------------------------------------------------------------------------
# translation (port of translate._walk / g_translate / translate)
# ---------------------------------------------------------------------------

def _acc_cause(acc):
    return (C.EXC_LACCESS if acc == ACC_R else
            C.EXC_SACCESS if acc == ACC_W else C.EXC_IACCESS)


def _pf_cause(acc, guest):
    if guest:
        return (C.EXC_LGUEST_PAGE_FAULT if acc == ACC_R else
                C.EXC_SGUEST_PAGE_FAULT if acc == ACC_W else
                C.EXC_IGUEST_PAGE_FAULT)
    return (C.EXC_LPAGE_FAULT if acc == ACC_R else
            C.EXC_SPAGE_FAULT if acc == ACC_W else C.EXC_IPAGE_FAULT)


def _leaf_ok(pte, acc, priv, sum_bit, mxr, require_u):
    r = (pte & PTE_R) != 0
    w = (pte & PTE_W) != 0
    x = (pte & PTE_X) != 0
    u = (pte & PTE_U) != 0
    a_ = (pte & PTE_A) != 0
    d = (pte & PTE_D) != 0
    r_eff = r or (mxr and x)
    perm = r_eff if acc == ACC_R else (w and r) if acc == ACC_W else x
    if require_u:
        u_ok = u
    elif priv == 0:
        u_ok = u
    else:
        u_ok = (not u) or (sum_bit and acc != ACC_X)
    ad_ok = a_ and (d if acc == ACC_W else True)
    return perm and u_ok and ad_ok


def _xres(pa=0, fault=False, cause=0, tval2=0, implicit=False,
          leaf=0, level=0):
    return {"pa": pa, "fault": fault, "cause": cause, "tval2": tval2,
            "implicit": implicit, "leaf": leaf, "level": level}


def _walk(mem, root, vpn2_bits, va, acc, priv, sum_bit, mxr, require_u,
          guest, pte_xlate=None, cause_acc=None):
    """Sequential Sv39(x4) walk; returns an _xres dict."""
    cause_acc = acc if cause_acc is None else cause_acc
    nbytes = len(mem) * 8
    base = root & M64
    for level in (2, 1, 0):
        shift = X.PAGE_SHIFT + 9 * level
        nbits = vpn2_bits if level == 2 else 9
        vpn = (va >> shift) & ((1 << nbits) - 1)
        pte_addr = u64(base + (vpn << 3))
        if pte_xlate is not None:
            g = pte_xlate(pte_addr)
            if g["fault"]:
                return _xres(fault=True, cause=g["cause"],
                             tval2=g["tval2"], implicit=True)
            pte_pa = g["pa"]
        else:
            pte_pa = pte_addr
        if pte_pa >= nbytes:
            return _xres(fault=True, cause=_acc_cause(cause_acc))
        pte = mem[pte_pa >> 3]
        valid = (pte & PTE_V) != 0
        reserved = (pte & PTE_W) != 0 and (pte & PTE_R) == 0
        if not valid or reserved:
            return _xres(fault=True, cause=_pf_cause(cause_acc, guest))
        if (pte & (PTE_R | PTE_X)) != 0:          # leaf
            ppn = (pte >> 10) & ((1 << 44) - 1)
            align_ok = level == 0 or (ppn & ((1 << (9 * level)) - 1)) == 0
            perm_ok = _leaf_ok(pte, acc, priv, sum_bit, mxr, require_u)
            if not align_ok or not perm_ok:
                return _xres(fault=True, cause=_pf_cause(cause_acc, guest))
            mask_low = (1 << shift) - 1
            pa = u64(((ppn << X.PAGE_SHIFT) & ~mask_low) | (va & mask_low))
            return _xres(pa=pa, leaf=pte, level=level)
        base = u64((pte >> 10 & ((1 << 44) - 1)) << X.PAGE_SHIFT)
    return _xres(fault=True, cause=_pf_cause(cause_acc, guest))


def g_translate(mem, hgatp, gpa, acc, mxr, cause_acc=None):
    """G-stage only (guest-physical → host-physical); _xres + tval2."""
    mode = (hgatp >> C.ATP_MODE_SHIFT) & 0xF
    if mode == 0:
        return _xres(pa=u64(gpa), leaf=ALL_PERM_PTE,
                     tval2=u64(gpa) >> 2) | {"g_leaf": ALL_PERM_PTE}
    root = (hgatp & C.ATP_PPN_MASK) << X.PAGE_SHIFT
    r = _walk(mem, root, 11, u64(gpa), acc, 0, False, mxr, True, True,
              cause_acc=cause_acc)
    r["tval2"] = u64(gpa) >> 2
    r["g_leaf"] = r["leaf"]
    return r


def translate(st, va, acc, force_virt=False, hlvx=False):
    """Full two-stage translation; returns a dict mirroring XResult."""
    csrs = st["csrs"]
    priv, virt = st["priv"], st["virt"]
    mem = st["mem"]
    va = u64(va)
    virt_eff = virt or force_virt
    status = csrs[C.R_VSSTATUS] if virt_eff else csrs[C.R_MSTATUS]
    sum_bit = (status & C.MSTATUS_SUM) != 0
    mxr = (status & C.MSTATUS_MXR) != 0
    acc_eff = ACC_X if hlvx else acc

    hgatp_eff = csrs[C.R_HGATP] if virt_eff else 0
    atp = csrs[C.R_VSATP] if virt_eff else csrs[C.R_SATP]
    mode = (atp >> C.ATP_MODE_SHIFT) & 0xF
    no_paging = mode == 0 or (priv >= 3 and not virt_eff)

    if no_paging:
        gpa_out, stage1 = va, None
        stage1_fault = False
    else:
        root = (atp & C.ATP_PPN_MASK) << X.PAGE_SHIFT
        stage1 = _walk(
            mem, root, 9, va, acc_eff, priv, sum_bit, mxr, False, False,
            pte_xlate=lambda p: g_translate(mem, hgatp_eff, p, ACC_R, mxr,
                                            cause_acc=acc))
        stage1_fault = stage1["fault"]
        gpa_out = stage1["pa"]

    if stage1_fault:
        return {"pa": 0, "fault": True, "cause": stage1["cause"],
                "tval": va, "tval2": stage1["tval2"],
                "gva": virt_eff, "implicit": stage1["implicit"],
                "leaf": 0, "g_leaf": 0, "level": 0}
    g = g_translate(mem, hgatp_eff, gpa_out, acc_eff, mxr, cause_acc=acc)
    if g["fault"]:
        return {"pa": 0, "fault": True, "cause": g["cause"], "tval": va,
                "tval2": g["tval2"], "gva": virt_eff, "implicit": False,
                "leaf": 0, "g_leaf": 0, "level": 0}
    # leaf PTEs + level feed the TLB fill (mirror of XResult.leaf_pte /
    # g_leaf_pte / level: a pseudo all-permission PTE stands in for a
    # disabled stage)
    return {"pa": g["pa"], "fault": False, "cause": 0, "tval": va,
            "tval2": 0, "gva": False, "implicit": False,
            "leaf": ALL_PERM_PTE if no_paging else stage1["leaf"],
            "g_leaf": g["g_leaf"],
            "level": 0 if no_paging else stage1["level"]}


# ---------------------------------------------------------------------------
# software-TLB model (port of tlb.lookup / insert / compose_perms /
# flush_where + isa.tlb_fill) — bit-exact so `walks` diffs clean
# ---------------------------------------------------------------------------

def _eff_ctx(csrs, virt_eff):
    """Effective (SUM, MXR) — vsstatus when virtualized, else mstatus."""
    status = csrs[C.R_VSSTATUS] if virt_eff else csrs[C.R_MSTATUS]
    return (status & C.MSTATUS_SUM) != 0, (status & C.MSTATUS_MXR) != 0


def _lvl_mask(level):
    """VPN bits that must match for an entry of this level (uint64)."""
    return ~((1 << (9 * level)) - 1) & M64


def tlb_lookup(tlb, va, virt, acc, priv, sum_bit, mxr):
    """→ (hit, pa, perm_ok); first-match-by-index like the machine's
    argmax.  ``pa``/``perm_ok`` are only meaningful when ``hit``."""
    vpn = u64(va) >> 12
    for i in range(N_TLB):
        lm = _lvl_mask(tlb["level"][i])
        if tlb["valid"][i] and tlb["guest"][i] == virt and \
                tlb["priv"][i] == priv and tlb["sum"][i] == sum_bit and \
                tlb["mxr"][i] == mxr and \
                (vpn & lm) == (tlb["vpn"][i] & lm):
            level = tlb["level"][i]
            low = (1 << (12 + 9 * level)) - 1
            pa = ((tlb["ppn"][i] << 12) & ~low & M64) | (u64(va) & low)
            want = PERM_R if acc == ACC_R else \
                PERM_W if acc == ACC_W else PERM_X
            return True, pa, (tlb["perm"][i] & want) != 0
    return False, 0, False


def _compose_perms(vs_pte, g_pte, priv, sum_bit, mxr):
    bits = 0
    for acc, bit in ((ACC_R, PERM_R), (ACC_W, PERM_W), (ACC_X, PERM_X)):
        if _leaf_ok(vs_pte, acc, priv, sum_bit, mxr, False) and \
                _leaf_ok(g_pte, acc, 0, False, mxr, True):
            bits |= bit
    return bits


def tlb_fill(st, va, xr, force_virt=False):
    """Insert the composed translation of a successful walk (mirror of
    ``isa.tlb_fill``): guest entries insert at 4K granularity, native
    entries keep their superpage level; context tags come from the
    access's effective (priv, SUM, MXR)."""
    tlb = st["tlb"]
    virt_eff = st["virt"] or force_virt
    sum_bit, mxr = _eff_ctx(st["csrs"], virt_eff)
    i = tlb["ptr"] % N_TLB
    tlb["vpn"][i] = u64(va) >> 12
    tlb["ppn"][i] = u64(xr["pa"]) >> 12
    tlb["level"][i] = 0 if virt_eff else xr["level"]
    tlb["perm"][i] = _compose_perms(xr["leaf"], xr["g_leaf"], st["priv"],
                                    sum_bit, mxr)
    tlb["guest"][i] = virt_eff
    tlb["priv"][i] = st["priv"]
    tlb["sum"][i] = sum_bit
    tlb["mxr"][i] = mxr
    tlb["valid"][i] = True
    tlb["ptr"] += 1


def tlb_flush(tlb, guest=False, native=False, va=None):
    """Invalidate entries: full-scope per tag class, or — with ``va`` —
    only the entries of that class whose cached translation covers the
    VA page (the rs1≠x0 scoped fence forms)."""
    for i in range(N_TLB):
        if not tlb["valid"][i]:
            continue
        in_class = guest if tlb["guest"][i] else native
        if not in_class:
            continue
        if va is not None:
            lm = _lvl_mask(tlb["level"][i])
            if ((u64(va) >> 12) & lm) != (tlb["vpn"][i] & lm):
                continue
        tlb["valid"][i] = False


def _event(st, tag):
    """Record an architectural-event signature for coverage bucketing
    (never part of the differential compare)."""
    ev = st.get("events")
    if ev is not None:
        ev.add(tag)


# ---------------------------------------------------------------------------
# trap routing (port of trap.route / take_trap / pending_interrupt)
# ---------------------------------------------------------------------------

def route(csrs, priv, virt, cause, is_int):
    bit = 1 << (cause & 63)
    mdeleg = csrs[C.R_MIDELEG] if is_int else csrs[C.R_MEDELEG]
    hdeleg = csrs[C.R_HIDELEG] if is_int else csrs[C.R_HEDELEG]
    to_hs_or_vs = (mdeleg & bit) != 0 and priv < 3
    to_vs = to_hs_or_vs and (hdeleg & bit) != 0 and virt
    return (1 if to_hs_or_vs else 3), to_vs


def take_trap(st, pc, cause, is_int, tval, tval2, gva, tinst):
    """Apply the trap in place; returns handled level (0 M, 1 HS, 2 VS)."""
    csrs = st["csrs"]
    priv, virt = st["priv"], st["virt"]
    tgt_priv, to_vs = route(csrs, priv, virt, cause, is_int)
    scause = u64(cause | C.INT_BIT) if is_int else u64(cause)

    if tgt_priv == 3:
        mst = csrs[C.R_MSTATUS]
        mst = (mst & ~C.MSTATUS_MPP) | ((priv << 11) & C.MSTATUS_MPP)
        if mst & C.MSTATUS_MIE:
            mst |= C.MSTATUS_MPIE
        else:
            mst &= ~C.MSTATUS_MPIE
        mst &= ~C.MSTATUS_MIE
        mst = mst | C.MSTATUS_MPV if virt else mst & ~C.MSTATUS_MPV
        mst = mst | C.MSTATUS_GVA if gva else mst & ~C.MSTATUS_GVA
        csrs[C.R_MSTATUS] = u64(mst)
        csrs[C.R_MEPC] = u64(pc)
        csrs[C.R_MCAUSE] = scause
        csrs[C.R_MTVAL] = u64(tval)
        csrs[C.R_MTVAL2] = u64(tval2)
        csrs[C.R_MTINST] = u64(tinst)
        st["pc"] = csrs[C.R_MTVEC] & ~3 & M64
        st["priv"], st["virt"] = 3, False
        return 0
    if to_vs:
        vst = csrs[C.R_VSSTATUS]
        vst = vst | C.MSTATUS_SPP if priv >= 1 else vst & ~C.MSTATUS_SPP
        if vst & C.MSTATUS_SIE:
            vst |= C.MSTATUS_SPIE
        else:
            vst &= ~C.MSTATUS_SPIE
        vst &= ~C.MSTATUS_SIE
        vs_cause = scause
        if is_int and 2 <= cause <= 10:
            vs_cause = u64(scause - 1)
        csrs[C.R_VSSTATUS] = u64(vst)
        csrs[C.R_VSEPC] = u64(pc)
        csrs[C.R_VSCAUSE] = vs_cause
        csrs[C.R_VSTVAL] = u64(tval)
        st["pc"] = csrs[C.R_VSTVEC] & ~3 & M64
        st["priv"], st["virt"] = 1, True
        return 2
    # to HS
    sst = csrs[C.R_MSTATUS]
    sst = sst | C.MSTATUS_SPP if priv >= 1 else sst & ~C.MSTATUS_SPP
    if sst & C.MSTATUS_SIE:
        sst |= C.MSTATUS_SPIE
    else:
        sst &= ~C.MSTATUS_SPIE
    sst &= ~C.MSTATUS_SIE
    hst = csrs[C.R_HSTATUS]
    hst = hst | C.HSTATUS_SPV if virt else hst & ~C.HSTATUS_SPV
    if virt:                           # SPVP only updates when V was 1
        hst = hst | C.HSTATUS_SPVP if priv >= 1 else hst & ~C.HSTATUS_SPVP
    hst = hst | C.HSTATUS_GVA if gva else hst & ~C.HSTATUS_GVA
    csrs[C.R_MSTATUS] = u64(sst)
    csrs[C.R_HSTATUS] = u64(hst)
    csrs[C.R_SEPC] = u64(pc)
    csrs[C.R_SCAUSE] = scause
    csrs[C.R_STVAL] = u64(tval)
    csrs[C.R_HTVAL] = u64(tval2)
    csrs[C.R_HTINST] = u64(tinst)
    st["pc"] = csrs[C.R_STVEC] & ~3 & M64
    st["priv"], st["virt"] = 1, False
    return 1


_PRIORITY = (11, 3, 7, 9, 1, 5, 12, 10, 2, 6)


def pending_interrupt(csrs, priv, virt):
    mip, mie = csrs[C.R_MIP], csrs[C.R_MIE]
    mideleg, hideleg = csrs[C.R_MIDELEG], csrs[C.R_HIDELEG]
    mstatus, vsstatus = csrs[C.R_MSTATUS], csrs[C.R_VSSTATUS]
    pend = mip & mie
    m_en = priv < 3 or (mstatus & C.MSTATUS_MIE) != 0
    s_en = priv < 1 or (priv == 1 and not virt and
                        (mstatus & C.MSTATUS_SIE) != 0)
    vs_en = (virt and priv < 1) or (virt and priv == 1 and
                                    (vsstatus & C.MSTATUS_SIE) != 0)
    for code in _PRIORITY:
        bit = 1 << code
        if not pend & bit:
            continue
        deleg_hs = (mideleg & bit) != 0
        deleg_vs = deleg_hs and (hideleg & bit) != 0
        if not deleg_hs:
            en = m_en
        elif deleg_vs:
            en = vs_en and virt
        else:
            en = s_en or (virt and priv <= 1)
        if en:
            return True, code
    return False, 0


# ---------------------------------------------------------------------------
# execute (port of isa.execute) — mutates st in place, returns fault dict
# ---------------------------------------------------------------------------

def _fault(cause, tval=0, tval2=0, gva=False, tinst=0):
    return {"cause": cause, "tval": u64(tval), "tval2": u64(tval2),
            "gva": bool(gva), "tinst": u64(tinst)}


def _mulhu(a, b):
    return ((a & M64) * (b & M64)) >> 64


def _divs(a, b):
    sa, sb = s64(a), s64(b)
    if sb == 0:
        return M64
    if sa == -(1 << 63) and sb == -1:
        return 1 << 63
    q = abs(sa) // abs(sb)
    return u64(-q if (sa < 0) != (sb < 0) else q)


def _rems(a, b):
    sa, sb = s64(a), s64(b)
    if sb == 0:
        return u64(a)
    if sa == -(1 << 63) and sb == -1:
        return 0
    r = abs(sa) % abs(sb)
    return u64(-r if sa < 0 else r)


def _word_extract(word, pa, size, uns):
    off = (pa & 7) * 8
    nbits = 8 << size
    v = (word >> off) & ((1 << nbits) - 1) if nbits < 64 else \
        u64(word >> off)
    return v if uns else sext(v, min(nbits, 64))


def _word_deposit(word, pa, val, size):
    off = (pa & 7) * 8
    nbits = 8 << size
    mask = M64 if nbits >= 64 else (1 << nbits) - 1
    return u64((word & ~(mask << off)) | ((val & mask) << off))


def decode_fields(word: int) -> Dict:
    """Independent instruction decoder: direct opcode tests and bit
    slicing, no lookup tables.  Returns the micro-op record shape of
    ``decode.decode_word`` with ``cls`` as a class *name* — the
    decode-table sweep tests (tests/hext/test_isa_props.py) diff the two
    decoders over random words, so a mis-built table entry and a wrong
    immediate mux both show up as a named mismatch."""
    word &= 0xFFFFFFFF
    op = word & 0x7F
    if op in (0x33, 0x13):
        cls, fmt = "alu", ("none" if op == 0x33 else "i")
    elif op in (0x3B, 0x1B):
        cls, fmt = "alu32", ("none" if op == 0x3B else "i")
    elif op == 0x37:
        cls, fmt = "lui", "u"
    elif op == 0x17:
        cls, fmt = "auipc", "u"
    elif op == 0x6F:
        cls, fmt = "jal", "j"
    elif op == 0x67:
        cls, fmt = "jalr", "i"
    elif op == 0x63:
        cls, fmt = "branch", "b"
    elif op == 0x03:
        cls, fmt = "load", "i"
    elif op == 0x23:
        cls, fmt = "store", "s"
    elif op == 0x73:
        cls, fmt = "system", "none"
    elif op == 0x0F:
        cls, fmt = "fence", "none"
    else:
        cls, fmt = "illegal", "none"
    if fmt == "i":
        imm = sext(word >> 20, 12)
    elif fmt == "s":
        imm = sext(((word >> 25) << 5) | ((word >> 7) & 0x1F), 12)
    elif fmt == "b":
        imm = sext((((word >> 31) & 1) << 12) | (((word >> 7) & 1) << 11) |
                   (((word >> 25) & 0x3F) << 5) |
                   (((word >> 8) & 0xF) << 1), 13)
    elif fmt == "u":
        imm = sext(word & 0xFFFFF000, 32)
    else:                                  # "j" or "none"
        imm = 0 if fmt == "none" else \
            sext((((word >> 31) & 1) << 20) |
                 (((word >> 12) & 0xFF) << 12) |
                 (((word >> 20) & 1) << 11) |
                 (((word >> 21) & 0x3FF) << 1), 21)
    return {
        "cls": cls,
        "rd": (word >> 7) & 31,
        "rs1": (word >> 15) & 31,
        "rs2": (word >> 20) & 31,
        "f3": (word >> 12) & 7,
        "f7": (word >> 25) & 0x7F,
        "imm": imm,
        "alu_imm": op in (0x13, 0x1B),
        "instr": word,
    }


def execute(st, instr):
    """One instruction on the oracle state. Returns (fault_or_None,
    retired).  On fault, st is left with only the machine's non-reverted
    side effects (console/done/exit_code accumulate pre-fault like the
    branchless core, which gates regs/pc/csrs/mem on `retired`)."""
    csrs = st["csrs"]
    regs = st["regs"]
    priv, virt = st["priv"], st["virt"]
    pc = st["pc"]
    mem = st["mem"]
    nbytes = len(mem) * 8

    op = instr & 0x7F
    rd = (instr >> 7) & 31
    f3 = (instr >> 12) & 7
    rs1 = (instr >> 15) & 31
    rs2i = (instr >> 20) & 31
    f7 = (instr >> 25) & 0x7F
    rv1, rv2 = regs[rs1], regs[rs2i]

    imm_i = sext(instr >> 20, 12)
    imm_s = sext(((instr >> 20) & ~0x1F) | ((instr >> 7) & 0x1F), 12)
    imm_b = sext((((instr >> 31) & 1) << 12) | (((instr >> 7) & 1) << 11) |
                 (((instr >> 25) & 0x3F) << 5) | (((instr >> 8) & 0xF) << 1),
                 13)
    imm_u = sext(instr & 0xFFFFF000, 32)
    imm_j = sext((((instr >> 31) & 1) << 20) | (((instr >> 12) & 0xFF) << 12)
                 | (((instr >> 20) & 1) << 11) |
                 (((instr >> 21) & 0x3FF) << 1), 21)

    new_pc = u64(pc + 4)
    wb = None                 # None → no writeback

    is_op, is_opi = op == 0x33, op == 0x13
    is_op32, is_opi32 = op == 0x3B, op == 0x1B

    # ---------------- ALU --------------------------------------------------
    if is_op or is_opi or is_op32 or is_opi32:
        alu_b = rv2 if (is_op or is_op32) else imm_i
        m_ext = (is_op or is_op32) and f7 == 1
        sh6, sh5 = alu_b & 0x3F, alu_b & 0x1F
        if is_op or is_opi:
            if m_ext:                       # M extension (is_op only)
                r = (u64(rv1 * alu_b) if f3 == 0 else
                     u64(_mulhu(rv1, alu_b)
                         - (alu_b if s64(rv1) < 0 else 0)
                         - (rv1 if s64(alu_b) < 0 else 0)) if f3 == 1 else
                     u64(_mulhu(rv1, alu_b)
                         - (alu_b if s64(rv1) < 0 else 0)) if f3 == 2 else
                     _mulhu(rv1, alu_b) if f3 == 3 else
                     _divs(rv1, alu_b) if f3 == 4 else
                     (M64 if alu_b == 0 else rv1 // alu_b) if f3 == 5 else
                     _rems(rv1, alu_b) if f3 == 6 else
                     (rv1 if alu_b == 0 else rv1 % alu_b))
            else:
                arith_sub = is_op and f7 == 0x20
                # OP-IMM srai: shamt[5] lives in f7 bit 0 → funct6 decode
                sr_arith = (f7 & 0x7E) == 0x20 if is_opi else f7 == 0x20
                r = (u64(rv1 - alu_b if arith_sub else rv1 + alu_b)
                     if f3 == 0 else
                     u64(rv1 << sh6) if f3 == 1 else
                     (1 if s64(rv1) < s64(alu_b) else 0) if f3 == 2 else
                     (1 if rv1 < alu_b else 0) if f3 == 3 else
                     rv1 ^ alu_b if f3 == 4 else
                     (u64(s64(rv1) >> sh6) if sr_arith else rv1 >> sh6)
                     if f3 == 5 else
                     rv1 | alu_b if f3 == 6 else rv1 & alu_b)
        else:                               # W forms
            a32, b32 = sext(rv1, 32), sext(alu_b, 32)
            if m_ext:                       # is_op32 only
                r = (sext(s64(a32) * s64(b32), 32) if f3 == 0 else
                     sext(_divs(sext(rv1, 32), sext(alu_b, 32)), 32)
                     if f3 == 4 else
                     (M64 if alu_b & 0xFFFFFFFF == 0 else
                      sext((rv1 & 0xFFFFFFFF) // (alu_b & 0xFFFFFFFF), 32))
                     if f3 == 5 else
                     sext(_rems(sext(rv1, 32), sext(alu_b, 32)), 64)
                     if f3 == 6 else
                     (sext(rv1, 32) if alu_b & 0xFFFFFFFF == 0 else
                      sext((rv1 & 0xFFFFFFFF) % (alu_b & 0xFFFFFFFF), 32)))
            else:
                sr_arith = f7 == 0x20
                if f3 == 0:
                    sub32 = is_op32 and f7 == 0x20
                    r = sext(s64(a32) - s64(b32) if sub32 else
                             s64(a32) + s64(b32), 32)
                elif f3 == 1:
                    r = sext(a32 << sh5, 32)
                elif f3 == 5:
                    r = (sext(u64(s64(sext(rv1, 32)) >> sh5), 32)
                         if sr_arith else
                         sext((a32 & 0xFFFFFFFF) >> sh5, 32))
                else:
                    r = sext(s64(a32) + s64(b32), 32)
        wb = u64(r)

    # ---------------- LUI/AUIPC/JAL/JALR/branches --------------------------
    elif op == 0x37:
        wb = imm_u
    elif op == 0x17:
        wb = u64(pc + imm_u)
    elif op == 0x6F:
        wb = u64(pc + 4)
        new_pc = u64(pc + imm_j)
    elif op == 0x67:
        wb = u64(pc + 4)
        new_pc = u64(rv1 + imm_i) & ~1
    elif op == 0x63:
        taken = (rv1 == rv2 if f3 == 0 else
                 rv1 != rv2 if f3 == 1 else
                 s64(rv1) < s64(rv2) if f3 == 4 else
                 s64(rv1) >= s64(rv2) if f3 == 5 else
                 rv1 < rv2 if f3 == 6 else rv1 >= rv2)
        if taken:
            new_pc = u64(pc + imm_b)

    # ---------------- loads / stores (incl. hlv/hsv) -----------------------
    elif op == 0x03 or op == 0x23 or (op == 0x73 and f3 == 4):
        is_sysx = op == 0x73
        is_hlv = is_sysx and (f7 & 1) == 0
        is_hsv = is_sysx and (f7 & 1) == 1
        is_store = op == 0x23 or is_hsv
        if is_sysx:
            hu = (csrs[C.R_HSTATUS] & C.HSTATUS_HU) != 0
            hx_legal = priv == 3 or (priv == 1 and not virt) or \
                (priv == 0 and not virt and hu)
            if virt:
                return _fault(C.EXC_VIRTUAL_INSTRUCTION, instr), False
            if not hx_legal:
                return _fault(C.EXC_ILLEGAL, instr), False
            addr = rv1
            size = (f7 >> 1) & 3
            uns = (rs2i & 1) == 1
            hlvx = is_hlv and rs2i == 3
            force_virt = True
        else:
            addr = u64(rv1 + (imm_s if is_store else imm_i))
            size = f3 & 3
            uns = (f3 & 4) != 0
            hlvx, force_virt = False, False

        if addr & ((1 << size) - 1):
            cause = C.EXC_SADDR_MISALIGNED if is_store else \
                C.EXC_LADDR_MISALIGNED
            return _fault(cause, addr, gva=virt or force_virt), False
        acc = ACC_W if is_store else ACC_R
        # TLB fast path (mirror of machine.execute): a usable hit skips
        # the walk and uses the CACHED composed pa — stale entries after
        # an unfenced PTE rewrite are architecturally visible, exactly
        # like the machine.  HLVX never uses a hit (cached perms carry no
        # execute-for-read override).
        virt_d = virt or force_virt
        sum_d, mxr_d = _eff_ctx(csrs, virt_d)
        hit, tpa, perm_ok = tlb_lookup(st["tlb"], addr, virt_d, acc, priv,
                                       sum_d, mxr_d)
        use_d = hit and perm_ok and not hlvx
        if use_d:
            xr = {"pa": tpa, "fault": False, "cause": 0, "tval": addr,
                  "tval2": 0, "gva": False, "implicit": False}
        else:
            xr = translate(st, addr, acc, force_virt=force_virt, hlvx=hlvx)
        if xr["fault"]:
            is_gpf = xr["cause"] in (C.EXC_LGUEST_PAGE_FAULT,
                                     C.EXC_SGUEST_PAGE_FAULT)
            tinst = 0
            if is_gpf:
                tinst = (0x2020 if is_store else 0x2000) if xr["implicit"] \
                    else instr & ~0xF8000
            return _fault(xr["cause"], xr["tval"], xr["tval2"],
                          xr["gva"] or force_virt, tinst), False
        pa = xr["pa"]
        pa_word = pa & ~7
        is_console = pa_word == MMIO_CONSOLE
        is_done_io = pa_word == MMIO_DONE
        is_ctxsw_io = pa_word == MMIO_CTXSW
        is_mtimecmp_io = pa_word == MMIO_MTIMECMP
        is_mtime_io = pa_word == MMIO_MTIME
        is_mmio = (is_console or is_done_io or is_ctxsw_io or
                   is_mtimecmp_io or is_mtime_io)
        mmio_readable = is_mtimecmp_io or is_mtime_io
        if (not is_mmio and pa >= nbytes) or \
                (not is_store and is_mmio and not mmio_readable):
            cause = C.EXC_SACCESS if is_store else C.EXC_LACCESS
            return _fault(cause, addr, gva=virt or force_virt), False
        # the access will retire → commit the data-side fill when we
        # walked (machine: mem_ok & walked; MMIO PAs insert too)
        if not use_d:
            tlb_fill(st, addr, xr, force_virt=force_virt)
        if is_store:
            if is_mtimecmp_io:
                csrs[C.R_MTIMECMP] = _word_deposit(
                    csrs[C.R_MTIMECMP], pa, rv2, size)
            elif is_mtime_io:
                csrs[C.R_MTIME] = _word_deposit(
                    csrs[C.R_MTIME], pa, rv2, size)
            elif is_console:
                st["console"] += 1
            elif is_done_io:
                st["done"] = True
                st["exit_code"] = rv2
            elif is_ctxsw_io:
                st["ctx_switches"] += 1
            else:
                w = pa >> 3
                mem[w] = _word_deposit(mem[w], pa, rv2, size)
        else:
            if is_mtime_io:
                wb = _word_extract(csrs[C.R_MTIME], pa, size, uns)
            elif is_mtimecmp_io:
                wb = _word_extract(csrs[C.R_MTIMECMP], pa, size, uns)
            else:
                wb = _word_extract(mem[pa >> 3], pa, size, uns)

    # ---------------- SYSTEM: CSR / priv ops -------------------------------
    elif op == 0x73 and f3 != 0:
        csr_addr = (instr >> 20) & 0xFFF
        csr_wdata = rs1 if f3 >= 5 else rv1
        old, r_ok, r_vinst = csr_read(csrs, csr_addr, priv, virt)
        wval = (csr_wdata if (f3 & 3) == 1 else
                old | csr_wdata if (f3 & 3) == 2 else old & ~csr_wdata & M64)
        do_write = (f3 & 3) == 1 or rs1 != 0
        csrs_w, w_ok, w_vinst = csr_write(csrs, csr_addr, wval, priv, virt)
        csr_ok = r_ok and (w_ok if do_write else True)
        if r_vinst or (do_write and w_vinst):
            return _fault(C.EXC_VIRTUAL_INSTRUCTION, instr), False
        if not csr_ok:
            return _fault(C.EXC_ILLEGAL, instr), False
        if do_write:
            st["csrs"] = csrs_w
            # satp/vsatp/hgatp writes invalidate every cached translation
            if csr_addr in (0x180, 0x280, 0x680):
                tlb_flush(st["tlb"], guest=True, native=True)
                _event(st, ("atp", csr_addr, virt, priv))
        wb = old

    elif op == 0x73:                       # f3 == 0: priv ops
        mstatus = csrs[C.R_MSTATUS]
        hstatus = csrs[C.R_HSTATUS]
        if instr == 0x00000073:            # ecall
            cause = (C.EXC_ECALL_M if priv == 3 else
                     C.EXC_ECALL_U if priv == 0 else
                     C.EXC_ECALL_VS if virt else C.EXC_ECALL_S)
            return _fault(cause), False
        elif instr == 0x00100073:          # ebreak
            return _fault(C.EXC_BREAK, pc), False
        elif instr == 0x10200073:          # sret
            tsr = (mstatus & C.MSTATUS_TSR) != 0
            vtsr = (hstatus & C.HSTATUS_VTSR) != 0
            if priv == 0 or (tsr and priv == 1 and not virt):
                return _fault(C.EXC_ILLEGAL, instr), False
            if virt and (vtsr or priv == 0):
                return _fault(C.EXC_VIRTUAL_INSTRUCTION, instr), False
            if virt:
                vst = csrs[C.R_VSSTATUS]
                vspp = 1 if vst & C.MSTATUS_SPP else 0
                if vst & C.MSTATUS_SPIE:
                    vst |= C.MSTATUS_SIE
                else:
                    vst &= ~C.MSTATUS_SIE
                vst = (vst | C.MSTATUS_SPIE) & ~C.MSTATUS_SPP
                csrs[C.R_VSSTATUS] = u64(vst)
                st["priv"] = vspp
                new_pc = csrs[C.R_VSEPC]
            else:
                spp = 1 if mstatus & C.MSTATUS_SPP else 0
                mst = mstatus
                if mst & C.MSTATUS_SPIE:
                    mst |= C.MSTATUS_SIE
                else:
                    mst &= ~C.MSTATUS_SIE
                mst = (mst | C.MSTATUS_SPIE) & ~C.MSTATUS_SPP
                csrs[C.R_MSTATUS] = u64(mst)
                csrs[C.R_HSTATUS] = u64(hstatus & ~C.HSTATUS_SPV)
                st["priv"] = spp
                st["virt"] = (hstatus & C.HSTATUS_SPV) != 0
                new_pc = csrs[C.R_SEPC]
        elif instr == 0x30200073:          # mret
            if priv != 3:
                return _fault(C.EXC_ILLEGAL, instr), False
            mpp = (mstatus >> 11) & 3
            mpv = (mstatus & C.MSTATUS_MPV) != 0
            mst = mstatus
            if mst & C.MSTATUS_MPIE:
                mst |= C.MSTATUS_MIE
            else:
                mst &= ~C.MSTATUS_MIE
            mst = (mst | C.MSTATUS_MPIE) & ~C.MSTATUS_MPP & ~C.MSTATUS_MPV
            csrs[C.R_MSTATUS] = u64(mst)
            st["priv"] = mpp
            st["virt"] = mpp != 3 and mpv
            new_pc = csrs[C.R_MEPC]
        elif instr == 0x10500073:          # wfi
            tw = (mstatus & C.MSTATUS_TW) != 0
            vtw = (hstatus & C.HSTATUS_VTW) != 0
            if (tw and priv < 3) or (priv == 0 and not virt):
                return _fault(C.EXC_ILLEGAL, instr), False
            if virt and (vtw or priv == 0):
                return _fault(C.EXC_VIRTUAL_INSTRUCTION, instr), False
            if not csrs[C.R_MIP] & csrs[C.R_MIE]:
                st["halted"] = True
                _event(st, ("wfi", virt, priv))
        elif f7 in (0x11, 0x31):           # hfence.vvma / hfence.gvma
            if virt:
                return _fault(C.EXC_VIRTUAL_INSTRUCTION, instr), False
            if priv == 0:
                return _fault(C.EXC_ILLEGAL, instr), False
            if f7 == 0x31:
                # gvma's rs1 is a guest-physical address; entries are
                # VA-tagged, so it is a conservative full guest flush
                tlb_flush(st["tlb"], guest=True)
                _event(st, ("fence", "gvma", False, virt, priv))
            else:
                tlb_flush(st["tlb"], guest=True,
                          va=rv1 if rs1 != 0 else None)
                _event(st, ("fence", "vvma", rs1 != 0, virt, priv))
        elif f7 == 0x09:                   # sfence.vma
            if virt and priv == 0:
                return _fault(C.EXC_VIRTUAL_INSTRUCTION, instr), False
            if not virt and priv == 0:
                return _fault(C.EXC_ILLEGAL, instr), False
            # VS-mode sfence flushes the guest's own (guest-tagged)
            # entries; HS/M-mode flushes native ones.  rs1≠x0 scopes the
            # invalidation to the one VA page in rs1.
            tlb_flush(st["tlb"], guest=virt, native=not virt,
                      va=rv1 if rs1 != 0 else None)
            _event(st, ("fence", "sfence", rs1 != 0, virt, priv))
        # any other f3==0 encoding retires as a no-op (machine quirk)

    elif op == 0x0F:
        pass                               # FENCE / FENCE.I: no-op
    else:
        return _fault(C.EXC_ILLEGAL, instr), False

    if wb is not None and rd != 0:
        regs[rd] = u64(wb)
    st["pc"] = new_pc
    return None, True


# ---------------------------------------------------------------------------
# step (port of machine.step) and the run loop
# ---------------------------------------------------------------------------

def _advance_timers(csrs):
    mtime = u64(csrs[C.R_MTIME] + 1)
    csrs[C.R_MTIME] = mtime
    mip = csrs[C.R_MIP]
    vs_time = u64(mtime + csrs[C.R_HTIMEDELTA])
    for cmp_idx, bit, now in ((C.R_MTIMECMP, C.IP_MTIP, mtime),
                              (C.R_STIMECMP, C.IP_STIP, mtime),
                              (C.R_VSTIMECMP, C.IP_VSTIP, vs_time)):
        cmpv = csrs[cmp_idx]
        if cmpv != C.TIMER_DISARMED:
            mip = mip | bit if now >= cmpv else mip & ~bit
    csrs[C.R_MIP] = mip


def _count_trap(st, cause, is_int, level):
    key = "int_by_level" if is_int else "exc_by_level"
    st[key][level] += 1
    if is_int:
        if cause in (5, 6, 7):
            st["timer_irqs"] += 1
    elif cause in (C.EXC_IPAGE_FAULT, C.EXC_LPAGE_FAULT, C.EXC_SPAGE_FAULT,
                   C.EXC_IGUEST_PAGE_FAULT, C.EXC_LGUEST_PAGE_FAULT,
                   C.EXC_SGUEST_PAGE_FAULT):
        st["pagefaults"] += 1


def step(st):
    """One tick: timers → CheckInterrupts → fetch → execute → fault."""
    if st["done"]:
        return
    st["ticks"] += 1
    _advance_timers(st["csrs"])
    csrs = st["csrs"]

    take, cause = pending_interrupt(csrs, st["priv"], st["virt"])
    if take:
        virt_b, priv_b = st["virt"], st["priv"]
        lvl = take_trap(st, st["pc"], cause, True, 0, 0, False, 0)
        st["halted"] = False
        _count_trap(st, cause, True, lvl)
        _event(st, ("int", cause, lvl, virt_b, priv_b))
        return

    if st["halted"]:
        if not csrs[C.R_MIP] & csrs[C.R_MIE]:
            return                       # stay idle (timers advanced)
        st["halted"] = False             # WFI wake: resume executing

    # fetch: TLB fast path first (mirror of machine.fetch).  A miss — or
    # a hit whose cached perms deny execute — walks and counts in
    # `walks`; a successful walk fills unless the fetch faults/OOBs.
    pc = st["pc"]
    virt_b, priv_b = st["virt"], st["priv"]
    sum_f, mxr_f = _eff_ctx(csrs, virt_b)
    hit, tpa, perm_ok = tlb_lookup(st["tlb"], pc, virt_b, ACC_X, priv_b,
                                   sum_f, mxr_f)
    use_f = hit and perm_ok
    if use_f:
        xr = {"pa": tpa, "fault": False, "cause": 0, "tval": pc,
              "tval2": 0, "gva": False, "implicit": False}
    else:
        st["walks"] += 1
        xr = translate(st, pc, ACC_X)
    nbytes = len(st["mem"]) * 8
    if xr["fault"] or xr["pa"] >= nbytes:
        if xr["fault"]:
            f = _fault(xr["cause"], xr["tval"], xr["tval2"], xr["gva"])
        else:
            f = _fault(C.EXC_IACCESS, pc, gva=st["virt"])
        lvl = take_trap(st, pc, f["cause"], False, f["tval"], f["tval2"],
                        f["gva"], f["tinst"])
        st["halted"] = False
        _count_trap(st, f["cause"], False, lvl)
        _event(st, ("exc", f["cause"], lvl, virt_b, priv_b))
        return
    if not use_f:
        tlb_fill(st, pc, xr)             # fetch-side fill commits even
    word = st["mem"][xr["pa"] >> 3]      # if execute faults below
    instr = (word >> 32) if xr["pa"] & 4 else word & 0xFFFFFFFF

    virt_before = st["virt"]          # instret_virt counts the mode the
    fault, retired = execute(st, instr)   # instruction *entered* in
    if retired:
        st["instret"] += 1
        if virt_before:
            st["instret_virt"] += 1
    if fault is not None:
        lvl = take_trap(st, pc, fault["cause"], False, fault["tval"],
                        fault["tval2"], fault["gva"], fault["tinst"])
        st["halted"] = False
        _count_trap(st, fault["cause"], False, lvl)
        _event(st, ("exc", fault["cause"], lvl, virt_b, priv_b))


def run(image, max_ticks: int) -> Dict:
    """Boot `image` and run until done or `max_ticks` ticks elapse."""
    st = reset_state(image)
    for _ in range(max_ticks):
        step(st)
        if st["done"]:
            break
    return st
