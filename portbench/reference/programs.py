"""RV64 assembler, boot firmware, xvisor-lite hypervisor, and MiBench-like
guest workloads (paper §4).

The benchmark's frozen copy of the port's assembler
(``repro_torch.core.hext.programs``, numpy only).  Every cell's images
are built here, in set-up, and handed to both the port and the
reference oracle, so no change to the port can change what a cell runs.
``portbench/tests/test_portbench_rehearsal.py`` holds the images equal to
the port's.

Two system images per workload:

* **native** — M firmware → S kernel (Sv39, demand-paged data) → workload.
  Exceptions: data-page faults handled at S (medeleg), final ecall to M.
* **guest**  — M firmware → HS "xvisor-lite" (builds hgatp/hedeleg/hideleg,
  enters VS via sret+SPV) → VS kernel (vsatp Sv39, demand-paged) → same
  workload. Exceptions: VS-stage faults handled *by the guest* at VS
  (hedeleg), G-stage guest-page-faults handled by the hypervisor at HS
  (on-demand G-stage mapping), final guest ecall (cause 10) → HS shutdown.

Both run the *identical* workload code — the executed-instruction and
exception-count deltas are exactly the paper's Figures 5–7.

A third image family (``build_image_nguest``) boots N guests per hart
under a preemptive HS scheduler (time-sliced round-robin with per-guest
G-stage tables, 64 KiB windows, and htimedelta-virtualized clocks) — the
paper's cloud-consolidation scenario; see ``sched_layout`` / DESIGN.md
§2c.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# ---------------------------------------------------------------------------
# register names
# ---------------------------------------------------------------------------
REG = {f"x{i}": i for i in range(32)}
REG.update(zero=0, ra=1, sp=2, gp=3, tp=4, t0=5, t1=6, t2=7, s0=8, fp=8,
           s1=9, a0=10, a1=11, a2=12, a3=13, a4=14, a5=15, a6=16, a7=17,
           s2=18, s3=19, s4=20, s5=21, s6=22, s7=23, s8=24, s9=25, s10=26,
           s11=27, t3=28, t4=29, t5=30, t6=31)


def _r(x):
    return REG[x] if isinstance(x, str) else int(x)


def _fit(v, bits):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return lo <= v <= hi


class Asm:
    """Tiny two-pass RV64 assembler (32-bit encodings only)."""

    def __init__(self, base: int):
        self.base = base
        self.words: list = []          # 32-bit ints or (label, encoder) fixups
        self.labels: dict = {}

    # -- infrastructure -----------------------------------------------------
    @property
    def pc(self) -> int:
        return self.base + 4 * len(self.words)

    def label(self, name: str):
        assert name not in self.labels, f"duplicate label {name!r}"
        self.labels[name] = self.pc
        return self

    def emit(self, w):
        self.words.append(w)

    def pad_to(self, addr: int):
        """NOP-pad up to `addr` (section alignment for handlers/bodies);
        asserts the current code has not already overrun it."""
        assert self.pc <= addr, hex(self.pc)
        while self.pc < addr:
            self.nop()
        return self

    def assemble(self) -> np.ndarray:
        out = []
        for i, w in enumerate(self.words):
            if isinstance(w, tuple):
                lab, enc = w
                target = self.labels[lab]
                out.append(enc(target, self.base + 4 * i))
            else:
                out.append(w)
        return np.array(out, dtype=np.uint32)

    # -- encoders -----------------------------------------------------------
    def _rtype(self, f7, rs2, rs1, f3, rd, op):
        self.emit((f7 << 25) | (_r(rs2) << 20) | (_r(rs1) << 15) |
                  (f3 << 12) | (_r(rd) << 7) | op)

    def _itype(self, imm, rs1, f3, rd, op):
        assert _fit(imm, 12), f"imm {imm} !fit12"
        self.emit(((imm & 0xFFF) << 20) | (_r(rs1) << 15) | (f3 << 12) |
                  (_r(rd) << 7) | op)

    def _stype(self, imm, rs2, rs1, f3, op):
        assert _fit(imm, 12)
        self.emit((((imm >> 5) & 0x7F) << 25) | (_r(rs2) << 20) |
                  (_r(rs1) << 15) | (f3 << 12) | ((imm & 0x1F) << 7) | op)

    def _utype(self, imm20, rd, op):
        self.emit(((imm20 & 0xFFFFF) << 12) | (_r(rd) << 7) | op)

    @staticmethod
    def _enc_b(imm, rs2, rs1, f3):
        return ((((imm >> 12) & 1) << 31) | (((imm >> 5) & 0x3F) << 25) |
                (_r(rs2) << 20) | (_r(rs1) << 15) | (f3 << 12) |
                (((imm >> 1) & 0xF) << 8) | (((imm >> 11) & 1) << 7) | 0x63)

    @staticmethod
    def _enc_j(imm, rd):
        return ((((imm >> 20) & 1) << 31) | (((imm >> 1) & 0x3FF) << 21) |
                (((imm >> 11) & 1) << 20) | (((imm >> 12) & 0xFF) << 12) |
                (_r(rd) << 7) | 0x6F)

    # -- ALU ----------------------------------------------------------------
    def addi(self, rd, rs1, imm): self._itype(imm, rs1, 0, rd, 0x13)
    def slti(self, rd, rs1, imm): self._itype(imm, rs1, 2, rd, 0x13)
    def sltiu(self, rd, rs1, imm): self._itype(imm, rs1, 3, rd, 0x13)
    def xori(self, rd, rs1, imm): self._itype(imm, rs1, 4, rd, 0x13)
    def ori(self, rd, rs1, imm): self._itype(imm, rs1, 6, rd, 0x13)
    def andi(self, rd, rs1, imm): self._itype(imm, rs1, 7, rd, 0x13)
    def slli(self, rd, rs1, sh): self._itype(sh, rs1, 1, rd, 0x13)
    def srli(self, rd, rs1, sh): self._itype(sh, rs1, 5, rd, 0x13)
    def srai(self, rd, rs1, sh): self._itype(sh | 0x400, rs1, 5, rd, 0x13)
    def addiw(self, rd, rs1, imm): self._itype(imm, rs1, 0, rd, 0x1B)
    def add(self, rd, rs1, rs2): self._rtype(0, rs2, rs1, 0, rd, 0x33)
    def sub(self, rd, rs1, rs2): self._rtype(0x20, rs2, rs1, 0, rd, 0x33)
    def sll(self, rd, rs1, rs2): self._rtype(0, rs2, rs1, 1, rd, 0x33)
    def slt(self, rd, rs1, rs2): self._rtype(0, rs2, rs1, 2, rd, 0x33)
    def sltu(self, rd, rs1, rs2): self._rtype(0, rs2, rs1, 3, rd, 0x33)
    def xor(self, rd, rs1, rs2): self._rtype(0, rs2, rs1, 4, rd, 0x33)
    def srl(self, rd, rs1, rs2): self._rtype(0, rs2, rs1, 5, rd, 0x33)
    def sra(self, rd, rs1, rs2): self._rtype(0x20, rs2, rs1, 5, rd, 0x33)
    def or_(self, rd, rs1, rs2): self._rtype(0, rs2, rs1, 6, rd, 0x33)
    def and_(self, rd, rs1, rs2): self._rtype(0, rs2, rs1, 7, rd, 0x33)
    def addw(self, rd, rs1, rs2): self._rtype(0, rs2, rs1, 0, rd, 0x3B)
    def subw(self, rd, rs1, rs2): self._rtype(0x20, rs2, rs1, 0, rd, 0x3B)
    def mul(self, rd, rs1, rs2): self._rtype(1, rs2, rs1, 0, rd, 0x33)
    def mulhu(self, rd, rs1, rs2): self._rtype(1, rs2, rs1, 3, rd, 0x33)
    def div(self, rd, rs1, rs2): self._rtype(1, rs2, rs1, 4, rd, 0x33)
    def divu(self, rd, rs1, rs2): self._rtype(1, rs2, rs1, 5, rd, 0x33)
    def rem(self, rd, rs1, rs2): self._rtype(1, rs2, rs1, 6, rd, 0x33)
    def remu(self, rd, rs1, rs2): self._rtype(1, rs2, rs1, 7, rd, 0x33)

    # -- memory ---------------------------------------------------------------
    def lb(self, rd, off, rs1): self._itype(off, rs1, 0, rd, 0x03)
    def lh(self, rd, off, rs1): self._itype(off, rs1, 1, rd, 0x03)
    def lw(self, rd, off, rs1): self._itype(off, rs1, 2, rd, 0x03)
    def ld(self, rd, off, rs1): self._itype(off, rs1, 3, rd, 0x03)
    def lbu(self, rd, off, rs1): self._itype(off, rs1, 4, rd, 0x03)
    def lhu(self, rd, off, rs1): self._itype(off, rs1, 5, rd, 0x03)
    def lwu(self, rd, off, rs1): self._itype(off, rs1, 6, rd, 0x03)
    def sb(self, rs2, off, rs1): self._stype(off, rs2, rs1, 0, 0x23)
    def sh(self, rs2, off, rs1): self._stype(off, rs2, rs1, 1, 0x23)
    def sw(self, rs2, off, rs1): self._stype(off, rs2, rs1, 2, 0x23)
    def sd(self, rs2, off, rs1): self._stype(off, rs2, rs1, 3, 0x23)

    # -- control --------------------------------------------------------------
    def lui(self, rd, imm20): self._utype(imm20, rd, 0x37)
    def auipc(self, rd, imm20): self._utype(imm20, rd, 0x17)

    def _branch(self, lab, rs1, rs2, f3):
        self.emit((lab, lambda t, pc, rs1=rs1, rs2=rs2, f3=f3:
                   Asm._enc_b(t - pc, rs2, rs1, f3)))

    def beq(self, rs1, rs2, lab): self._branch(lab, rs1, rs2, 0)
    def bne(self, rs1, rs2, lab): self._branch(lab, rs1, rs2, 1)
    def blt(self, rs1, rs2, lab): self._branch(lab, rs1, rs2, 4)
    def bge(self, rs1, rs2, lab): self._branch(lab, rs1, rs2, 5)
    def bltu(self, rs1, rs2, lab): self._branch(lab, rs1, rs2, 6)
    def bgeu(self, rs1, rs2, lab): self._branch(lab, rs1, rs2, 7)
    def beqz(self, rs1, lab): self.beq(rs1, "zero", lab)
    def bnez(self, rs1, lab): self.bne(rs1, "zero", lab)

    def jal(self, rd, lab):
        self.emit((lab, lambda t, pc, rd=rd: Asm._enc_j(t - pc, rd)))

    def j(self, lab): self.jal("zero", lab)
    def call(self, lab): self.jal("ra", lab)

    def jalr(self, rd, off, rs1): self._itype(off, rs1, 0, rd, 0x67)
    def ret(self): self.jalr("zero", 0, "ra")
    def nop(self): self.addi("zero", "zero", 0)
    def mv(self, rd, rs): self.addi(rd, rs, 0)

    # -- system ---------------------------------------------------------------
    def csrrw(self, rd, csr, rs1): self._itype_csr(csr, rs1, 1, rd)
    def csrrs(self, rd, csr, rs1): self._itype_csr(csr, rs1, 2, rd)
    def csrrc(self, rd, csr, rs1): self._itype_csr(csr, rs1, 3, rd)
    def csrrwi(self, rd, csr, z): self._itype_csr(csr, z, 5, rd, zimm=True)
    def csrrsi(self, rd, csr, z): self._itype_csr(csr, z, 6, rd, zimm=True)
    def csrrci(self, rd, csr, z): self._itype_csr(csr, z, 7, rd, zimm=True)

    def _itype_csr(self, csr, rs1, f3, rd, zimm=False):
        v = rs1 if zimm else _r(rs1)
        self.emit(((csr & 0xFFF) << 20) | (v << 15) | (f3 << 12) |
                  (_r(rd) << 7) | 0x73)

    def csrw(self, csr, rs1): self.csrrw("zero", csr, rs1)
    def csrr(self, rd, csr): self.csrrs(rd, csr, "zero")

    def ecall(self): self.emit(0x00000073)
    def ebreak(self): self.emit(0x00100073)
    def sret(self): self.emit(0x10200073)
    def mret(self): self.emit(0x30200073)
    def wfi(self): self.emit(0x10500073)
    # fences: rs1≠x0 requests an address-scoped invalidation (the VA —
    # or GPA>>2 for gvma — in rs1); rs1=x0 is the full-scope form
    def sfence_vma(self, rs1=0, rs2=0):
        self._rtype(0x09, rs2, rs1, 0, 0, 0x73)

    def hfence_vvma(self, rs1=0, rs2=0):
        self._rtype(0x11, rs2, rs1, 0, 0, 0x73)

    def hfence_gvma(self, rs1=0, rs2=0):
        self._rtype(0x31, rs2, rs1, 0, 0, 0x73)

    # hypervisor loads/stores
    def hlv_b(self, rd, rs1): self._rtype(0x30, 0, rs1, 4, rd, 0x73)
    def hlv_bu(self, rd, rs1): self._rtype(0x30, 1, rs1, 4, rd, 0x73)
    def hlv_h(self, rd, rs1): self._rtype(0x32, 0, rs1, 4, rd, 0x73)
    def hlv_hu(self, rd, rs1): self._rtype(0x32, 1, rs1, 4, rd, 0x73)
    def hlvx_hu(self, rd, rs1): self._rtype(0x32, 3, rs1, 4, rd, 0x73)
    def hlv_w(self, rd, rs1): self._rtype(0x34, 0, rs1, 4, rd, 0x73)
    def hlv_wu(self, rd, rs1): self._rtype(0x34, 1, rs1, 4, rd, 0x73)
    def hlvx_wu(self, rd, rs1): self._rtype(0x34, 3, rs1, 4, rd, 0x73)
    def hlv_d(self, rd, rs1): self._rtype(0x36, 0, rs1, 4, rd, 0x73)
    def hsv_b(self, rs2, rs1): self._rtype(0x31, rs2, rs1, 4, 0, 0x73)
    def hsv_h(self, rs2, rs1): self._rtype(0x33, rs2, rs1, 4, 0, 0x73)
    def hsv_w(self, rs2, rs1): self._rtype(0x35, rs2, rs1, 4, 0, 0x73)
    def hsv_d(self, rs2, rs1): self._rtype(0x37, rs2, rs1, 4, 0, 0x73)

    # -- pseudo: li (x31/t6 is assembler scratch for 64-bit) ------------------
    def li(self, rd, imm):
        imm = int(imm)
        if _fit(imm, 12):
            self.addi(rd, "zero", imm)
            return
        if -(1 << 31) <= imm < (1 << 31):
            self._li32(rd, imm)
            return
        lo = imm & 0xFFFFFFFF
        lo_s = lo - (1 << 32) if lo >= (1 << 31) else lo
        hi = ((imm - lo_s) >> 32) & 0xFFFFFFFF
        hi_s = hi - (1 << 32) if hi >= (1 << 31) else hi
        self._li32(rd, hi_s)
        self.slli(rd, rd, 32)
        if lo_s != 0:
            self._li32("t6", lo_s)
            self.add(rd, rd, "t6")

    def _li32(self, rd, v):
        if _fit(v, 12):
            self.addi(rd, "zero", v)
            return
        upper = (v + 0x800) >> 12
        lower = v - (upper << 12)
        self.lui(rd, upper & 0xFFFFF)
        if lower:
            self.addiw(rd, rd, lower)


# ---------------------------------------------------------------------------
# memory image builder + page tables
# ---------------------------------------------------------------------------

PTE_V, PTE_R, PTE_W, PTE_X, PTE_U, PTE_A, PTE_D = 1, 2, 4, 8, 16, 64, 128
P_KERN = PTE_V | PTE_R | PTE_W | PTE_X | PTE_A | PTE_D            # 0xCF
P_GUEST = P_KERN | PTE_U                                          # 0xDF


class Image:
    def __init__(self, mem_words: int):
        self.mem = np.zeros((mem_words,), dtype=np.uint64)

    def place_code(self, base: int, words32: np.ndarray):
        assert base % 8 == 0
        n = len(words32)
        pad = words32 if n % 2 == 0 else np.append(words32, np.uint32(0x13))
        pairs = pad.reshape(-1, 2).astype(np.uint64)
        w64 = pairs[:, 0] | (pairs[:, 1] << np.uint64(32))
        self.mem[base // 8: base // 8 + len(w64)] = w64

    def store64(self, addr: int, val: int):
        assert addr % 8 == 0
        self.mem[addr // 8] = np.uint64(val & 0xFFFFFFFFFFFFFFFF)

    def store_bytes(self, addr: int, data: bytes):
        for i, b in enumerate(data):
            a = addr + i
            w = self.mem[a // 8]
            sh = np.uint64((a % 8) * 8)
            w = (w & ~(np.uint64(0xFF) << sh)) | (np.uint64(b) << sh)
            self.mem[a // 8] = w

    def pte(self, pa: int, perms: int) -> int:
        return ((pa >> 12) << 10) | perms

    def map_page(self, l0_base: int, va: int, pa: int, perms: int):
        vpn0 = (va >> 12) & 0x1FF
        self.store64(l0_base + vpn0 * 8, self.pte(pa, perms))

    def link(self, table_base: int, idx: int, child_pa: int):
        self.store64(table_base + idx * 8, self.pte(child_pa, PTE_V))


# ---------------------------------------------------------------------------
# memory map (byte addresses; identity VA=PA=GPA throughout)
# ---------------------------------------------------------------------------
M_BOOT = 0x0000
M_HANDLER = 0x0200
HS_ENTRY = 0x0400
HS_HANDLER = 0x0800
KERN_ENTRY = 0x1000        # S (native) or VS (guest) kernel
KERN_HANDLER = 0x1400
WORKLOAD = 0x1800          # workload code (pages 1 & 2: 0x1000-0x2FFF)
SAVE_S = 0x2F00            # register save area for S/VS handler
SAVE_HS = 0x2F40
RESULT = 0x2F80            # checksum mailbox (mapped code page → no fault)
DATA = 0x3000              # demand-paged data: pages 0x3000..0x7FFF
STACK_TOP = 0x7F00
# native / VS-stage page tables
S_L2, S_L1, S_L0 = 0x8000, 0x9000, 0xA000
# G-stage tables (root 16K-aligned, 4 pages wide: Sv39x4)
G_L2, G_L1, G_L0 = 0x10000, 0x14000, 0x15000
MEM_WORDS = 1 << 15        # 256 KiB

MMIO_DONE = 0x10000008
MMIO_CTXSW = 0x10000010

SATP_SV39 = 8 << 60

# ---------------------------------------------------------------------------
# preemptive N-guest layout (paper §3.2 cloud scenario: time-sliced VMs).
# The M/HS region keeps the single-guest map; each guest gets a private
# 64 KiB host-physical window and a private G-stage table set, and the
# HS scheduler round-robins between them on timer interrupts.  Everything
# below SCHED_CUR is code; the 0x2000..0x4000 region holds scheduler state
# (computed per N by `sched_layout`), then the per-guest G-stage table
# blocks, then the guest windows.
# ---------------------------------------------------------------------------
HS2_HANDLER = 0x0800       # scheduler trap handler (code may run past 0x1000)
SCHED_CUR = 0x2000         # current guest index
SCHED_CURCTX = 0x2008      # &ctx[cur]
SCHED_CURGI = 0x2010       # &ginfo[cur]
SCHED_N = 0x2018           # guest count
GINFO0 = 0x2040            # per-guest {hgatp, g_l0, window, done} blocks
GINFO_SIZE = 0x40
GUEST_RES = 0x2100         # per-guest checksum mailboxes (N=2 layout)
CTX0 = 0x2200              # per-guest saved context (N=2 layout)
CTX_SIZE = 0x200
CTX_PC = 0x100             # byte offset of the sepc slot inside a context
GTAB0 = 0x4000             # first per-guest G-stage table block
GTAB_STRIDE = 0x8000       # 16K root + L1 + L0 pages (+ slack), 16K-aligned
G2_L2 = (0x4000, 0xC000)   # legacy N=2 table addresses (== sched_layout(2))
G2_L1 = (0x8000, 0x10000)
G2_L0 = (0x9000, 0x11000)
GUEST_WIN = 0x10000        # 64 KiB of guest-physical space per guest
PB = (0x20000, 0x30000)    # legacy N=2 window bases (== sched_layout(2))
DEFAULT_TIMESLICE = 1000   # ticks between preemptions
MAX_GUESTS = 8             # HS boot code must fit below HS2_HANDLER

# saved per guest at CTX_PC + 8*i: sepc (guest pc) then the VS CSR bank
# (vstimecmp included — an armed guest timer must not leak to its sibling)
_VS_CTX_CSRS = (0x141, 0x200, 0x205, 0x240, 0x241, 0x242, 0x243, 0x280,
                0x24D)
# one more slot: the guest's frozen virtual time (mtime + htimedelta at
# deschedule); on resume the scheduler rebuilds htimedelta from it
CTX_VTIME = CTX_PC + 8 * len(_VS_CTX_CSRS)


class SchedLayout(NamedTuple):
    """Computed memory map for an N-guests-per-hart scheduler image.

    For n == 2 every field equals the legacy module-level constants, so the
    committed 2-guest benchmark golden stays reproducible."""
    n: int
    ginfo0: int            # per-guest info blocks (GINFO_SIZE each)
    guest_res: int         # per-guest checksum mailboxes (8 bytes each)
    ctx0: int              # per-guest context save slots (CTX_SIZE each)
    g_l2: tuple            # per-guest Sv39x4 roots (16 KiB, 16K-aligned)
    g_l1: tuple
    g_l0: tuple
    win: tuple             # per-guest host-physical window bases
    mem_words: int         # total image size in 64-bit words


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def sched_layout(n: int) -> SchedLayout:
    """Memory map for an N-guest scheduler image (1 ≤ n ≤ MAX_GUESTS)."""
    if not 1 <= n <= MAX_GUESTS:
        raise ValueError(f"guests_per_hart must be in 1..{MAX_GUESTS}, "
                         f"got {n}")
    ginfo_end = GINFO0 + n * GINFO_SIZE
    guest_res = max(GUEST_RES, _align(ginfo_end, 0x40))
    ctx0 = max(CTX0, _align(guest_res + 8 * n, 0x100))
    assert ctx0 + n * CTX_SIZE <= GTAB0, "context area overruns G tables"
    g_l2 = tuple(GTAB0 + i * GTAB_STRIDE for i in range(n))
    g_l1 = tuple(b + 0x4000 for b in g_l2)
    g_l0 = tuple(b + 0x5000 for b in g_l2)
    win0 = max(0x20000, _align(GTAB0 + n * GTAB_STRIDE, GUEST_WIN))
    win = tuple(win0 + i * GUEST_WIN for i in range(n))
    return SchedLayout(n=n, ginfo0=GINFO0, guest_res=guest_res, ctx0=ctx0,
                       g_l2=g_l2, g_l1=g_l1, g_l0=g_l0, win=win,
                       mem_words=(win0 + n * GUEST_WIN) // 8)


def guest_regions(lay: SchedLayout, g: int):
    """Byte ``(start, length)`` regions holding guest `g`'s entire
    migratable state in an N-guest scheduler image: saved context slot,
    G-stage table block, host-physical window, result mailbox, and the
    scheduler's per-guest info block.  ``Fleet.migrate_guest`` copies
    exactly these regions between harts — the addresses are identical on
    any hart with the same layout, and window-offset G-stage leaves stay
    valid because ``lay.win[g]`` is layout-determined, not hart-local."""
    if not 0 <= g < lay.n:
        raise ValueError(f"guest {g} out of range for N={lay.n}")
    return ((lay.ctx0 + g * CTX_SIZE, CTX_SIZE),
            (lay.g_l2[g], GTAB_STRIDE),
            (lay.win[g], GUEST_WIN),
            (lay.guest_res + 8 * g, 8),
            (lay.ginfo0 + g * GINFO_SIZE, GINFO_SIZE))


def _build_kernel_pts(img: Image, perms: int):
    """Identity map of kernel/code/PT pages; data pages left invalid
    (demand-paged). Used for both the native satp tables and the guest's
    VS-stage tables (same layout, same GPAs)."""
    img.link(S_L2, 0, S_L1)
    img.link(S_L1, 0, S_L0)
    # code pages 0x0000-0x2FFF + PT pages + result area
    for page in range(0x0, 0x3000, 0x1000):
        img.map_page(S_L0, page, page, perms)
    for page in (S_L2, S_L1, S_L0):
        img.map_page(S_L0, page, page, perms)


def _build_gstage_pts(img: Image):
    """G-stage: fully demand-paged — only the non-leaf table links exist.
    EVERY first guest touch of a page (fetch, data, even the guest's own
    VS-stage page-table reads → implicit faults with pseudo-tinst) exits to
    the hypervisor, which maps the leaf on demand. This is the xvisor-style
    lazy stage-2 population that drives the paper's Fig 6/7 exception
    profile."""
    img.link(G_L2, 0, G_L1)
    img.link(G_L1, 0, G_L0)


# ---------------------------------------------------------------------------
# firmware / kernels / hypervisor
# ---------------------------------------------------------------------------

def _m_firmware(native: bool, counteren: bool = False) -> Asm:
    a = Asm(M_BOOT)
    a.li("t0", M_HANDLER)
    a.csrw(0x305, "t0")                       # mtvec
    if counteren:
        # open the counters (time/cycle/instret) to HS and below — the
        # scheduler hypervisor reads `time` to arm its slice timer.  The
        # single-guest firmware leaves mcounteren at its reset value (0) so
        # those images stay bit-identical to the pre-counteren goldens.
        a.li("t0", 7)
        a.csrw(0x306, "t0")                   # mcounteren: CY|TM|IR
    if native:
        # delegate S-level page faults + illegal etc to S; keep ecall-S at M
        a.li("t0", (1 << 12) | (1 << 13) | (1 << 15) | (1 << 8))
        a.csrw(0x302, "t0")                   # medeleg
    else:
        # delegate everything the hypervisor needs: page faults, guest page
        # faults, virtual instruction, ecall-U, ecall-VS → HS
        a.li("t0", (1 << 12) | (1 << 13) | (1 << 15) | (1 << 8) |
             (1 << 20) | (1 << 21) | (1 << 23) | (1 << 22) | (1 << 10))
        a.csrw(0x302, "t0")
        a.li("t0", 0x222)
        a.csrw(0x303, "t0")                   # mideleg (S bits; VS forced)
    # mstatus.MPP=S
    a.li("t0", 1 << 11)
    a.csrrs(0, 0x300, "t0")
    a.li("t0", KERN_ENTRY if native else HS_ENTRY)
    a.csrw(0x341, "t0")                       # mepc
    a.mret()
    # M trap handler: ecall-from-S(9) → DONE(a0); anything else → DONE(cause)
    a.pad_to(M_HANDLER)
    a.label("m_handler")
    a.csrr("t0", 0x342)                       # mcause
    a.li("t1", 9)
    a.beq("t0", "t1", "m_done_ok")
    a.li("t1", MMIO_DONE)
    a.sd("t0", 0, "t1")                       # exit with cause (error)
    a.label("m_spin")
    a.j("m_spin")
    a.label("m_done_ok")
    a.li("t1", MMIO_DONE)
    a.sd("a0", 0, "t1")
    a.label("m_spin2")
    a.j("m_spin2")
    return a


def _hypervisor() -> Asm:
    """xvisor-lite: HS-mode type-1 hypervisor (guest setup + exit handling)."""
    a = Asm(HS_ENTRY)
    a.li("sp", SAVE_HS + 0x30)
    a.li("t0", HS_HANDLER)
    a.csrw(0x105, "t0")                       # stvec (HS)
    # hgatp: Sv39x4 root
    a.li("t0", SATP_SV39 | (G_L2 >> 12))
    a.csrw(0x680, "t0")
    a.hfence_gvma()
    # hedeleg: let the guest handle its own VS-stage page faults + ecall-U
    a.li("t0", (1 << 12) | (1 << 13) | (1 << 15) | (1 << 8))
    a.csrw(0x602, "t0")
    # hideleg: delegate VS interrupts to the guest
    a.li("t0", 0x444)
    a.csrw(0x603, "t0")
    # hstatus: SPV=1 | SPVP=1 (return into VS S-mode)
    a.li("t0", (1 << 7) | (1 << 8))
    a.csrw(0x600, "t0")
    # sstatus.SPP=1
    a.li("t0", 1 << 8)
    a.csrrs(0, 0x100, "t0")
    a.li("t0", KERN_ENTRY)
    a.csrw(0x141, "t0")                       # sepc → guest entry
    a.sret()                                  # enter VS

    a.pad_to(HS_HANDLER)
    # ---- HS trap handler ---------------------------------------------------
    a.label("hs_handler")
    # save (t6 first — it is the li-scratch and must survive nested traps)
    a.csrw(0x140, "t6")                       # sscratch ← t6
    a.li("t6", SAVE_HS)
    a.sd("t0", 0, "t6")
    a.sd("t1", 8, "t6")
    a.sd("t2", 16, "t6")
    a.csrr("t0", 0x142)                       # scause
    a.li("t1", 10)
    a.beq("t0", "t1", "hs_shutdown")          # ecall from VS → done
    # guest page fault? (20/21/23)
    a.li("t1", 21)
    a.beq("t0", "t1", "hs_map")
    a.li("t1", 23)
    a.beq("t0", "t1", "hs_map")
    a.li("t1", 20)
    a.beq("t0", "t1", "hs_map")
    # unexpected → shutdown with cause
    a.li("t1", MMIO_DONE)
    a.sd("t0", 0, "t1")
    a.label("hs_spin")
    a.j("hs_spin")
    a.label("hs_map")                         # on-demand G-stage mapping
    # xvisor-lite accounting: per-exit bookkeeping (scheduler credit decay)
    a.li("t2", 12)
    a.label("hs_acct")
    a.addi("t2", "t2", -1)
    a.bnez("t2", "hs_acct")
    a.csrr("t0", 0x643)                       # htval = GPA >> 2
    a.slli("t0", "t0", 2)                     # GPA
    a.srli("t1", "t0", 12)
    a.andi("t1", "t1", 0x1FF)                 # vpn0
    a.slli("t1", "t1", 3)
    a.li("t2", G_L0)
    a.add("t1", "t1", "t2")
    a.srli("t2", "t0", 12)
    a.slli("t2", "t2", 10)
    a.ori("t2", "t2", P_GUEST)
    a.sd("t2", 0, "t1")                       # write G-stage PTE
    a.hfence_gvma()
    # restore + retry faulting instruction
    a.li("t6", SAVE_HS)
    a.ld("t0", 0, "t6")
    a.ld("t1", 8, "t6")
    a.ld("t2", 16, "t6")
    a.csrr("t6", 0x140)                       # t6 ← sscratch
    a.sret()
    a.label("hs_shutdown")
    a.li("t1", MMIO_DONE)
    a.sd("a0", 0, "t1")                       # checksum from guest a0
    a.label("hs_spin2")
    a.j("hs_spin2")
    return a


def _scheduler_hypervisor(timeslice: int, n: int = 2, live=None) -> Asm:
    """xvisor-lite with a preemptive round-robin scheduler: N guests per
    hart, time-sliced on the HS timer (stimecmp/STI), VSTI-style injection
    left to the guests' own vstimecmp.  Each guest owns a host-physical
    window and a private G-stage table set; on-demand G-stage mapping adds
    the window offset so every guest sees the same guest-physical map.

    Round-robin is the generalized ``next = (cur + 1) % N`` with finished
    guests skipped; when no *other* guest is live the timer only re-arms.
    Each guest also gets a virtualized time base: on deschedule the
    scheduler records the guest's virtual time (``mtime + htimedelta``) in
    its context, and on resume rebuilds ``htimedelta`` so guest time
    excludes the ticks it spent descheduled.

    ``live`` (default: all slots) marks which slots boot with a guest.  A
    dead slot's ginfo.done flag is initialized to 1, so the round-robin
    skips it exactly like a finished guest — until the control plane parks
    a checkpointed guest into the slot and clears the flag, at which point
    the next timer tick schedules it.  The emitted code is bit-identical
    to the pre-``live`` scheduler when every slot is live."""
    lay = sched_layout(n)
    if live is None:
        live = (True,) * n
    live = tuple(bool(x) for x in live)
    if len(live) != n:
        raise ValueError(f"live mask has {len(live)} entries for n={n}")
    if not any(live):
        raise ValueError("at least one scheduler slot must boot live")
    entry = live.index(True)
    a = Asm(HS_ENTRY)
    a.li("t0", HS2_HANDLER)
    a.csrw(0x105, "t0")                       # stvec (HS)
    # per-guest info blocks: {hgatp, G-stage L0, window base, done}
    for i in range(n):
        a.li("t0", lay.ginfo0 + i * GINFO_SIZE)
        a.li("t1", SATP_SV39 | (lay.g_l2[i] >> 12))
        a.sd("t1", 0, "t0")
        a.li("t1", lay.g_l0[i])
        a.sd("t1", 8, "t0")
        a.li("t1", lay.win[i])
        a.sd("t1", 16, "t0")
        if live[i]:
            a.sd("zero", 24, "t0")
        else:
            a.li("t1", 1)                     # dead slot: born finished
            a.sd("t1", 24, "t0")
    # scheduler state: the first live guest is current
    a.li("t0", SCHED_CUR)
    if entry == 0:
        a.sd("zero", 0, "t0")
    else:
        a.li("t1", entry)
        a.sd("t1", 0, "t0")
    a.li("t1", lay.ctx0 + entry * CTX_SIZE)
    a.sd("t1", 8, "t0")                       # SCHED_CURCTX
    a.li("t1", lay.ginfo0 + entry * GINFO_SIZE)
    a.sd("t1", 16, "t0")                      # SCHED_CURGI
    a.li("t1", n)
    a.sd("t1", 24, "t0")                      # SCHED_N
    # live non-entry guests first activate at the kernel entry (ctx
    # GPRs/CSRs and the virtual-time slot stay zero: their clocks start at
    # ~0 on resume); the saved vstimecmp must start DISARMED, not 0
    for i in range(n):
        if i == entry or not live[i]:
            continue
        a.li("t0", lay.ctx0 + i * CTX_SIZE)
        a.li("t1", KERN_ENTRY)
        a.sd("t1", CTX_PC, "t0")
        a.li("t1", -1)
        a.sd("t1", CTX_PC + 8 * _VS_CTX_CSRS.index(0x24D), "t0")
    # hedeleg: guests handle their own VS-stage page faults + ecall-U
    a.li("t0", (1 << 12) | (1 << 13) | (1 << 15) | (1 << 8))
    a.csrw(0x602, "t0")
    a.li("t0", 0x444)
    a.csrw(0x603, "t0")                       # hideleg: VS interrupts → VS
    a.li("t0", 7)
    a.csrw(0x606, "t0")                       # hcounteren: guests read time
    a.li("t0", SATP_SV39 | (lay.g_l2[entry] >> 12))
    a.csrw(0x680, "t0")                       # hgatp ← entry guest
    a.hfence_gvma()
    # arm the scheduler timer: sie.STIE, stimecmp = time + slice (STI stays
    # at HS — hideleg cannot delegate it — and preempts VS regardless of the
    # guest's own interrupt enables)
    a.li("t0", 1 << 5)
    a.csrrs(0, 0x104, "t0")                   # sie.STIE
    a.csrr("t0", 0xC01)                       # time
    a.li("t1", timeslice)
    a.add("t0", "t0", "t1")
    a.csrw(0x14D, "t0")                       # stimecmp
    # guest 0's clock starts at 0: htimedelta = -time
    a.csrr("t0", 0xC01)
    a.sub("t0", "zero", "t0")
    a.csrw(0x605, "t0")                       # htimedelta
    # enter guest 0
    a.li("t0", (1 << 7) | (1 << 8))           # hstatus.SPV|SPVP
    a.csrw(0x600, "t0")
    a.li("t0", 1 << 8)
    a.csrrs(0, 0x100, "t0")                   # sstatus.SPP
    a.li("t0", KERN_ENTRY)
    a.csrw(0x141, "t0")                       # sepc
    a.sret()

    a.pad_to(HS2_HANDLER)
    # ---- scheduler trap handler --------------------------------------------
    a.label("h2_handler")
    a.csrw(0x140, "t6")                       # sscratch ← t6 (li scratch)
    a.li("t6", SCHED_CURCTX)
    a.ld("t6", 0, "t6")                       # t6 = current guest's ctx
    a.sd("t0", 8 * 5, "t6")                   # park t0-t3 in their ctx slots
    a.sd("t1", 8 * 6, "t6")
    a.sd("t2", 8 * 7, "t6")
    a.sd("t3", 8 * 28, "t6")
    a.csrr("t0", 0x142)                       # scause
    a.blt("t0", "zero", "h2_timer")           # interrupt → only STI enabled
    a.li("t1", 10)
    a.beq("t0", "t1", "h2_exit")              # ecall from VS → guest done
    a.li("t1", 21)
    a.beq("t0", "t1", "h2_map")
    a.li("t1", 23)
    a.beq("t0", "t1", "h2_map")
    a.li("t1", 20)
    a.beq("t0", "t1", "h2_map")
    a.li("t1", MMIO_DONE)                     # unexpected → die loudly
    a.sd("t0", 0, "t1")
    a.label("h2_spin")
    a.j("h2_spin")

    # ---- on-demand G-stage mapping (window-offset xvisor-lite page-in) ----
    a.label("h2_map")
    a.csrr("t0", 0x643)                       # htval = GPA >> 2
    a.slli("t0", "t0", 2)                     # GPA
    # isolation: a GPA outside the guest's 64 KiB window must never be
    # mapped (it would land in a sibling guest's window or wrap into HS
    # memory) — kill the machine with the offending GPA as exit code
    a.li("t1", GUEST_WIN)
    a.bltu("t0", "t1", "h2_map_ok")
    a.li("t1", MMIO_DONE)
    a.sd("t0", 0, "t1")
    a.j("h2_spin")
    a.label("h2_map_ok")
    a.srli("t1", "t0", 12)
    a.andi("t1", "t1", 0x1FF)                 # vpn0
    a.slli("t1", "t1", 3)
    a.li("t2", SCHED_CURGI)
    a.ld("t2", 0, "t2")
    a.ld("t2", 8, "t2")                       # current guest's G-stage L0
    a.add("t1", "t1", "t2")                   # &PTE
    a.li("t2", SCHED_CURGI)
    a.ld("t2", 0, "t2")
    a.ld("t2", 16, "t2")                      # window base
    a.add("t0", "t0", "t2")                   # HPA = GPA + window
    a.srli("t0", "t0", 12)
    a.slli("t0", "t0", 10)
    a.ori("t0", "t0", P_GUEST)
    a.sd("t0", 0, "t1")                       # write G-stage leaf
    a.hfence_gvma()
    a.label("h2_ret")                         # restore t0-t3/t6 → guest
    a.li("t6", SCHED_CURCTX)
    a.ld("t6", 0, "t6")
    a.ld("t0", 8 * 5, "t6")
    a.ld("t1", 8 * 6, "t6")
    a.ld("t2", 8 * 7, "t6")
    a.ld("t3", 8 * 28, "t6")
    a.csrr("t6", 0x140)
    a.sret()

    # ---- timer tick: round-robin preemption --------------------------------
    # scan (cur+1) % n, (cur+2) % n, … for the first live guest; coming
    # back around to cur means nobody else runs → re-arm and resume cur.
    a.label("h2_timer")
    a.li("t6", SCHED_CUR)
    a.ld("t0", 0, "t6")                       # cur
    a.ld("t1", 24, "t6")                      # n
    a.mv("t2", "t0")                          # cand ← cur
    a.label("h2_scan")
    a.addi("t2", "t2", 1)
    a.blt("t2", "t1", "h2_scan_ck")
    a.li("t2", 0)                             # wrap: next = (cand+1) % n
    a.label("h2_scan_ck")
    a.beq("t2", "t0", "h2_rearm")             # full circle → only cur lives
    a.slli("t3", "t2", 6)                     # × GINFO_SIZE
    a.li("t6", lay.ginfo0)
    a.add("t3", "t3", "t6")
    a.ld("t3", 24, "t3")                      # ginfo[cand].done
    a.bnez("t3", "h2_scan")
    a.j("h2_save_switch")                     # t2 = next live guest

    a.label("h2_rearm")
    a.csrr("t0", 0xC01)
    a.li("t1", timeslice)
    a.add("t0", "t0", "t1")
    a.csrw(0x14D, "t0")
    a.j("h2_ret")

    a.label("h2_save_switch")                 # save the full guest context
    a.li("t6", SCHED_CURCTX)
    a.ld("t6", 0, "t6")
    for r in range(1, 31):
        if r in (5, 6, 7, 28):                # t0-t3 already parked
            continue
        a.sd(f"x{r}", 8 * r, "t6")
    a.csrr("t0", 0x140)                       # original t6
    a.sd("t0", 8 * 31, "t6")
    for i, csr in enumerate(_VS_CTX_CSRS):    # sepc + VS CSR bank
        a.csrr("t0", csr)
        a.sd("t0", CTX_PC + 8 * i, "t6")
    a.csrr("t0", 0xC01)                       # freeze the guest's clock:
    a.csrr("t3", 0x605)                       # vtime = mtime + htimedelta
    a.add("t0", "t0", "t3")
    a.sd("t0", CTX_VTIME, "t6")
    # fall through: t2 = target guest index

    a.label("h2_switch_to")                   # (also the exit-handoff path)
    a.li("t0", SCHED_CUR)
    a.sd("t2", 0, "t0")                       # cur ← target
    a.slli("t1", "t2", 9)                     # × CTX_SIZE
    a.li("t3", lay.ctx0)
    a.add("t1", "t1", "t3")
    a.sd("t1", 8, "t0")                       # SCHED_CURCTX
    a.slli("t3", "t2", 6)                     # × GINFO_SIZE
    a.li("t4", lay.ginfo0)
    a.add("t3", "t3", "t4")
    a.sd("t3", 16, "t0")                      # SCHED_CURGI
    a.ld("t4", 0, "t3")
    a.csrw(0x680, "t4")                       # hgatp ← target's root
    a.hfence_gvma()
    a.mv("t6", "t1")                          # t6 = target's ctx
    for i, csr in enumerate(_VS_CTX_CSRS):
        a.ld("t0", CTX_PC + 8 * i, "t6")
        a.csrw(csr, "t0")
    a.ld("t0", CTX_VTIME, "t6")               # resume the guest's clock:
    a.csrr("t3", 0xC01)                       # htimedelta = vtime - mtime
    a.sub("t0", "t0", "t3")
    a.csrw(0x605, "t0")
    a.csrw(0x645, "zero")                     # drop stale VS pending bits
    a.li("t0", MMIO_CTXSW)                    # count the context switch
    a.sd("zero", 0, "t0")
    a.csrr("t0", 0xC01)                       # re-arm the slice
    a.li("t1", timeslice)
    a.add("t0", "t0", "t1")
    a.csrw(0x14D, "t0")
    a.li("t0", (1 << 7) | (1 << 8))
    a.csrrs(0, 0x600, "t0")                   # hstatus.SPV|SPVP
    a.li("t0", 1 << 8)
    a.csrrs(0, 0x100, "t0")                   # sstatus.SPP
    for r in range(1, 31):
        a.ld(f"x{r}", 8 * r, "t6")
    a.ld("x31", 8 * 31, "t6")                 # ctx base restored last
    a.sret()

    # ---- guest exit: record checksum, hand off or shut down ---------------
    a.label("h2_exit")
    a.li("t0", SCHED_CUR)
    a.ld("t1", 0, "t0")                       # cur
    a.slli("t2", "t1", 3)
    a.li("t0", lay.guest_res)
    a.add("t2", "t2", "t0")
    a.sd("a0", 0, "t2")                       # mailbox[cur] ← checksum
    a.slli("t2", "t1", 6)
    a.li("t0", lay.ginfo0)
    a.add("t2", "t2", "t0")
    a.li("t0", 1)
    a.sd("t0", 24, "t2")                      # ginfo[cur].done = 1
    # scan for the next live guest (same round-robin order as the timer)
    a.li("t6", SCHED_CUR)
    a.ld("t0", 0, "t6")                       # cur
    a.ld("t1", 24, "t6")                      # n
    a.mv("t2", "t0")
    a.label("h2_exit_scan")
    a.addi("t2", "t2", 1)
    a.blt("t2", "t1", "h2_exit_ck")
    a.li("t2", 0)
    a.label("h2_exit_ck")
    a.beq("t2", "t0", "h2_all_done")          # full circle → fleet done
    a.slli("t3", "t2", 6)
    a.li("t6", lay.ginfo0)
    a.add("t3", "t3", "t6")
    a.ld("t3", 24, "t3")
    a.bnez("t3", "h2_exit_scan")
    a.j("h2_switch_to")                       # hand off (no save: cur done)

    a.label("h2_all_done")                    # combined checksum → DONE
    a.li("t0", lay.guest_res)
    a.li("t1", n)
    a.li("t2", 0)                             # acc
    a.li("t3", 0)                             # i
    a.label("h2_sum")
    a.slli("t4", "t3", 3)
    a.add("t4", "t4", "t0")
    a.ld("t4", 0, "t4")
    a.add("t2", "t2", "t4")
    a.addi("t3", "t3", 1)
    a.blt("t3", "t1", "h2_sum")
    a.li("t0", MMIO_DONE)
    a.sd("t2", 0, "t0")
    a.label("h2_spin2")
    a.j("h2_spin2")
    assert a.pc <= SCHED_CUR, hex(a.pc)
    return a


def _kernel(native: bool) -> Asm:
    """S-mode kernel (native) == VS-mode guest kernel (identical code):
    set stvec, enable paging, run the workload, ecall with checksum."""
    a = Asm(KERN_ENTRY)
    a.li("t0", KERN_HANDLER)
    a.csrw(0x105, "t0")                       # stvec (or vstvec via swap)
    a.li("t0", SATP_SV39 | (S_L2 >> 12))
    a.csrw(0x180, "t0")                       # satp (or vsatp via swap)
    a.sfence_vma()
    a.li("sp", STACK_TOP)
    a.call("workload_entry")
    # a0 = checksum
    a.li("t0", RESULT)
    a.sd("a0", 0, "t0")
    a.ecall()                                 # native → M; guest → HS
    a.label("k_spin")
    a.j("k_spin")

    a.pad_to(KERN_HANDLER)
    # ---- S/VS page-fault handler: demand-map 4K identity page -------------
    a.label("k_handler")
    a.csrw(0x140, "t6")                       # sscratch (vsscratch when V=1)
    a.li("t6", SAVE_S)
    a.sd("t0", 0, "t6")
    a.sd("t1", 8, "t6")
    a.sd("t2", 16, "t6")
    a.csrr("t0", 0x142)                       # scause (vscause via swap)
    a.li("t1", 13)
    a.beq("t0", "t1", "k_map")
    a.li("t1", 15)
    a.beq("t0", "t1", "k_map")
    a.li("t1", 12)
    a.beq("t0", "t1", "k_map")
    # unexpected: die loudly — write cause then stall
    a.li("t1", RESULT)
    a.sd("t0", 0, "t1")
    a.label("k_spin2")
    a.j("k_spin2")
    a.label("k_map")
    a.csrr("t0", 0x143)                       # stval (vstval)
    a.srli("t1", "t0", 12)
    a.andi("t1", "t1", 0x1FF)
    a.slli("t1", "t1", 3)
    a.li("t2", S_L0)
    a.add("t1", "t1", "t2")
    a.srli("t2", "t0", 12)
    a.slli("t2", "t2", 10)
    a.ori("t2", "t2", P_KERN)
    a.sd("t2", 0, "t1")
    a.sfence_vma()
    a.li("t6", SAVE_S)
    a.ld("t0", 0, "t6")
    a.ld("t1", 8, "t6")
    a.ld("t2", 16, "t6")
    a.csrr("t6", 0x140)
    a.sret()
    return a


# ---------------------------------------------------------------------------
# MiBench-like workloads. Each defines asm(a) and golden() → checksum.
# Code must start at label "workload_entry" and return checksum in a0.
# ---------------------------------------------------------------------------

def _lcg(seed):
    return (seed * 6364136223846793005 + 1442695040888963407) % (1 << 64)


class Workload:
    name = "base"
    data: dict = {}

    def asm(self, a: Asm):
        raise NotImplementedError

    def golden(self) -> int:
        raise NotImplementedError

    def write_data(self, img: Image):
        pass


class BitCount(Workload):
    """MiBench automotive/bitcount: Kernighan popcount over an LCG stream."""
    name = "bitcount"
    N = 96

    def asm(self, a):
        a.label("workload_entry")
        a.li("a0", 0)                  # acc
        a.li("t0", 0)                  # i
        a.li("t1", self.N)
        a.li("t2", 0x9E3779B97F4A7C15)  # golden-ratio stride
        a.li("t3", 0)                  # x state
        a.label("bc_loop")
        a.add("t3", "t3", "t2")
        a.mv("t4", "t3")
        a.label("bc_pop")
        a.beqz("t4", "bc_done")
        a.addi("t5", "t4", -1)
        a.and_("t4", "t4", "t5")
        a.addi("a0", "a0", 1)
        a.j("bc_pop")
        a.label("bc_done")
        a.addi("t0", "t0", 1)
        a.blt("t0", "t1", "bc_loop")
        a.ret()

    def golden(self):
        acc, x = 0, 0
        for _ in range(self.N):
            x = (x + 0x9E3779B97F4A7C15) % (1 << 64)
            acc += bin(x).count("1")
        return acc


class BasicMath(Workload):
    """MiBench automotive/basicmath: isqrt (Newton) + gcd over a range."""
    name = "basicmath"
    N = 28

    def asm(self, a):
        a.label("workload_entry")
        a.li("a0", 0)
        a.li("s0", 1)                  # i
        a.li("s1", self.N)
        a.label("bm_loop")
        # isqrt(i*2655 + 17) by integer Newton (8 iters)
        a.li("t0", 2655)
        a.mul("t0", "s0", "t0")
        a.addi("t0", "t0", 17)         # v
        a.mv("t1", "t0")               # x = v
        a.li("t2", 8)                  # iters
        a.label("bm_newton")
        a.beqz("t1", "bm_nzero")
        a.divu("t3", "t0", "t1")       # v/x
        a.add("t1", "t1", "t3")
        a.srli("t1", "t1", 1)          # x = (x + v/x)/2
        a.label("bm_nzero")
        a.addi("t2", "t2", -1)
        a.bnez("t2", "bm_newton")
        a.add("a0", "a0", "t1")
        # gcd(i*7919, i+1000)
        a.li("t0", 7919)
        a.mul("t0", "s0", "t0")
        a.addi("t1", "s0", 1000)
        a.label("bm_gcd")
        a.beqz("t1", "bm_gcd_done")
        a.remu("t2", "t0", "t1")
        a.mv("t0", "t1")
        a.mv("t1", "t2")
        a.j("bm_gcd")
        a.label("bm_gcd_done")
        a.add("a0", "a0", "t0")
        a.addi("s0", "s0", 1)
        a.bge("s1", "s0", "bm_loop")
        a.ret()

    def golden(self):
        import math
        acc = 0
        for i in range(1, self.N + 1):
            v = i * 2655 + 17
            x = v
            for _ in range(8):
                if x:
                    x = (x + v // x) // 2
            acc += x
            acc += math.gcd(i * 7919, i + 1000)
        return acc


class QSort(Workload):
    """MiBench automotive/qsort: insertion sort of LCG values (ld/sd heavy)."""
    name = "qsort"
    N = 40
    BASE = DATA

    def asm(self, a):
        a.label("workload_entry")
        a.li("s0", self.BASE)
        # generate
        a.li("t0", 0)
        a.li("t1", self.N)
        a.li("t2", 12345)
        a.li("t3", 6364136223846793005)
        a.li("t4", 1442695040888963407)
        a.label("qs_gen")
        a.mul("t2", "t2", "t3")
        a.add("t2", "t2", "t4")
        a.srli("t5", "t2", 16)         # positive-ish value
        a.slli("s2", "t0", 3)
        a.add("s2", "s2", "s0")
        a.sd("t5", 0, "s2")
        a.addi("t0", "t0", 1)
        a.blt("t0", "t1", "qs_gen")
        # insertion sort
        a.li("s1", 1)                  # i
        a.label("qs_outer")
        a.bge("s1", "t1", "qs_done")
        a.slli("s2", "s1", 3)
        a.add("s2", "s2", "s0")
        a.ld("s3", 0, "s2")            # key
        a.mv("s4", "s1")               # j
        a.label("qs_inner")
        a.beqz("s4", "qs_insert")
        a.addi("s5", "s4", -1)
        a.slli("s6", "s5", 3)
        a.add("s6", "s6", "s0")
        a.ld("s7", 0, "s6")
        a.bgeu("s3", "s7", "qs_insert")
        a.slli("s8", "s4", 3)
        a.add("s8", "s8", "s0")
        a.sd("s7", 0, "s8")
        a.mv("s4", "s5")
        a.j("qs_inner")
        a.label("qs_insert")
        a.slli("s8", "s4", 3)
        a.add("s8", "s8", "s0")
        a.sd("s3", 0, "s8")
        a.addi("s1", "s1", 1)
        a.j("qs_outer")
        a.label("qs_done")
        # checksum: sum of arr[i]*i
        a.li("a0", 0)
        a.li("t0", 0)
        a.label("qs_ck")
        a.slli("s2", "t0", 3)
        a.add("s2", "s2", "s0")
        a.ld("s3", 0, "s2")
        a.mul("s3", "s3", "t0")
        a.add("a0", "a0", "s3")
        a.addi("t0", "t0", 1)
        a.blt("t0", "t1", "qs_ck")
        a.ret()

    def golden(self):
        vals = []
        x = 12345
        for _ in range(self.N):
            x = _lcg(x)
            vals.append(x >> 16)
        vals.sort()
        return sum((v * i) % (1 << 64) for i, v in enumerate(vals)) % (1 << 64)


class Susan(Workload):
    """MiBench automotive/susan: 3×3 brightness stencil over a byte image."""
    name = "susan"
    W, H = 20, 12
    BASE = DATA + 0x800

    def write_data(self, img: Image):
        rng = np.random.RandomState(7)
        self.pix = rng.randint(0, 256, size=(self.H, self.W)).astype(np.uint8)
        img.store_bytes(self.BASE, self.pix.tobytes())

    def asm(self, a):
        W, H = self.W, self.H
        a.label("workload_entry")
        a.li("a0", 0)
        a.li("s0", self.BASE)
        a.li("s1", 1)                  # y
        a.label("su_y")
        a.li("t0", H - 1)
        a.bge("s1", "t0", "su_done")
        a.li("s2", 1)                  # x
        a.label("su_x")
        a.li("t0", W - 1)
        a.bge("s2", "t0", "su_next_y")
        # sum 3x3 neighbourhood
        a.li("s3", 0)                  # acc3x3
        a.li("s4", -1)                 # dy
        a.label("su_dy")
        a.li("t0", 2)
        a.bge("s4", "t0", "su_have")
        a.li("s5", -1)                 # dx
        a.label("su_dx")
        a.li("t0", 2)
        a.bge("s5", "t0", "su_next_dy")
        a.add("t1", "s1", "s4")        # y+dy
        a.li("t2", W)
        a.mul("t1", "t1", "t2")
        a.add("t1", "t1", "s2")
        a.add("t1", "t1", "s5")        # idx
        a.add("t1", "t1", "s0")
        a.lbu("t2", 0, "t1")
        a.add("s3", "s3", "t2")
        a.addi("s5", "s5", 1)
        a.j("su_dx")
        a.label("su_next_dy")
        a.addi("s4", "s4", 1)
        a.j("su_dy")
        a.label("su_have")
        a.add("a0", "a0", "s3")
        a.addi("s2", "s2", 1)
        a.j("su_x")
        a.label("su_next_y")
        a.addi("s1", "s1", 1)
        a.j("su_y")
        a.label("su_done")
        a.ret()

    def golden(self):
        acc = 0
        p = self.pix.astype(np.int64)
        for y in range(1, self.H - 1):
            for x in range(1, self.W - 1):
                acc += int(p[y - 1:y + 2, x - 1:x + 2].sum())
        return acc % (1 << 64)


class SHA(Workload):
    """MiBench security/sha: rotate/xor/add mixing rounds."""
    name = "sha"
    N = 160

    def asm(self, a):
        a.label("workload_entry")
        a.li("a0", 0x67452301)
        a.li("t0", 0)
        a.li("t1", self.N)
        a.li("t2", 0x5A827999)
        a.label("sh_loop")
        # a0 = rotl(a0,5) ^ (a0 + t2 + i)
        a.slli("t3", "a0", 5)
        a.srli("t4", "a0", 59)
        a.or_("t3", "t3", "t4")
        a.add("t5", "a0", "t2")
        a.add("t5", "t5", "t0")
        a.xor("a0", "t3", "t5")
        a.addi("t0", "t0", 1)
        a.blt("t0", "t1", "sh_loop")
        a.ret()

    def golden(self):
        M = (1 << 64) - 1
        h = 0x67452301
        for i in range(self.N):
            rot = ((h << 5) | (h >> 59)) & M
            h = rot ^ ((h + 0x5A827999 + i) & M)
        return h


class CRC32(Workload):
    """MiBench telecomm/crc32: bitwise CRC over bytes."""
    name = "crc32"
    N = 48
    BASE = DATA + 0x1000

    def write_data(self, img: Image):
        rng = np.random.RandomState(11)
        self.buf = rng.randint(0, 256, size=self.N).astype(np.uint8)
        img.store_bytes(self.BASE, self.buf.tobytes())

    def asm(self, a):
        a.label("workload_entry")
        a.li("a0", 0xFFFFFFFF)
        a.li("s0", self.BASE)
        a.li("t0", 0)
        a.li("t1", self.N)
        a.li("s1", 0xEDB88320)
        a.label("cr_byte")
        a.add("t2", "s0", "t0")
        a.lbu("t3", 0, "t2")
        a.xor("a0", "a0", "t3")
        a.li("t4", 8)
        a.label("cr_bit")
        a.andi("t5", "a0", 1)
        a.srli("a0", "a0", 1)
        a.beqz("t5", "cr_nox")
        a.xor("a0", "a0", "s1")
        a.label("cr_nox")
        a.addi("t4", "t4", -1)
        a.bnez("t4", "cr_bit")
        a.addi("t0", "t0", 1)
        a.blt("t0", "t1", "cr_byte")
        a.ret()

    def golden(self):
        crc = 0xFFFFFFFF
        for b in self.buf:
            crc ^= int(b)
            for _ in range(8):
                lsb = crc & 1
                crc >>= 1
                if lsb:
                    crc ^= 0xEDB88320
        return crc


class Dijkstra(Workload):
    """MiBench network/dijkstra: dense relaxation over a K×K matrix."""
    name = "dijkstra"
    K = 10
    BASE = DATA + 0x1800

    def write_data(self, img: Image):
        rng = np.random.RandomState(3)
        self.adj = rng.randint(1, 100, size=(self.K, self.K)).astype(np.int64)
        np.fill_diagonal(self.adj, 0)
        for i in range(self.K):
            for j in range(self.K):
                img.store64(self.BASE + (i * self.K + j) * 8,
                            int(self.adj[i, j]))

    def asm(self, a):
        K = self.K
        a.label("workload_entry")
        a.li("s0", self.BASE)
        # Floyd-Warshall-style triple loop (bounded Dijkstra analogue)
        a.li("s1", 0)                  # k
        a.label("dj_k")
        a.li("t0", K)
        a.bge("s1", "t0", "dj_done")
        a.li("s2", 0)                  # i
        a.label("dj_i")
        a.li("t0", K)
        a.bge("s2", "t0", "dj_next_k")
        a.li("s3", 0)                  # j
        a.label("dj_j")
        a.li("t0", K)
        a.bge("s3", "t0", "dj_next_i")
        # d[i][j] = min(d[i][j], d[i][k]+d[k][j])
        a.li("t0", K)
        a.mul("t1", "s2", "t0")
        a.add("t1", "t1", "s3")
        a.slli("t1", "t1", 3)
        a.add("t1", "t1", "s0")        # &d[i][j]
        a.ld("t2", 0, "t1")
        a.mul("t3", "s2", "t0")
        a.add("t3", "t3", "s1")
        a.slli("t3", "t3", 3)
        a.add("t3", "t3", "s0")
        a.ld("t3", 0, "t3")            # d[i][k]
        a.mul("t4", "s1", "t0")
        a.add("t4", "t4", "s3")
        a.slli("t4", "t4", 3)
        a.add("t4", "t4", "s0")
        a.ld("t4", 0, "t4")            # d[k][j]
        a.add("t3", "t3", "t4")
        a.bge("t3", "t2", "dj_skip")
        a.sd("t3", 0, "t1")
        a.label("dj_skip")
        a.addi("s3", "s3", 1)
        a.j("dj_j")
        a.label("dj_next_i")
        a.addi("s2", "s2", 1)
        a.j("dj_i")
        a.label("dj_next_k")
        a.addi("s1", "s1", 1)
        a.j("dj_k")
        a.label("dj_done")
        # checksum = sum d[i][j]
        a.li("a0", 0)
        a.li("s1", 0)
        a.li("t0", K * K)
        a.label("dj_ck")
        a.slli("t1", "s1", 3)
        a.add("t1", "t1", "s0")
        a.ld("t1", 0, "t1")
        a.add("a0", "a0", "t1")
        a.addi("s1", "s1", 1)
        a.blt("s1", "t0", "dj_ck")
        a.ret()

    def golden(self):
        d = self.adj.copy()
        K = self.K
        for k in range(K):
            for i in range(K):
                for j in range(K):
                    if d[i, k] + d[k, j] < d[i, j]:
                        d[i, j] = d[i, k] + d[k, j]
        return int(d.sum()) % (1 << 64)


class StringSearch(Workload):
    """MiBench office/stringsearch: naive pattern scan."""
    name = "stringsearch"
    TEXT = (b"the quick brown fox jumps over the lazy dog and then the fox "
            b"runs away to the forest where the other foxes live happily ")
    PAT = b"fox"
    BASE = DATA + 0x2000

    def write_data(self, img: Image):
        img.store_bytes(self.BASE, self.TEXT)
        img.store_bytes(self.BASE + 0x400, self.PAT)

    def asm(self, a):
        n, m = len(self.TEXT), len(self.PAT)
        a.label("workload_entry")
        a.li("a0", 0)                  # match count
        a.li("s0", self.BASE)
        a.li("s1", self.BASE + 0x400)
        a.li("t0", 0)                  # i
        a.li("t1", n - m + 1)
        a.label("ss_outer")
        a.bge("t0", "t1", "ss_done")
        a.li("t2", 0)                  # j
        a.label("ss_inner")
        a.li("t3", m)
        a.bge("t2", "t3", "ss_match")
        a.add("t4", "s0", "t0")
        a.add("t4", "t4", "t2")
        a.lbu("t5", 0, "t4")
        a.add("t4", "s1", "t2")
        a.lbu("t6", 0, "t4")           # (t6 is scratch but safe here: no li)
        a.bne("t5", "t6", "ss_next")
        a.addi("t2", "t2", 1)
        a.j("ss_inner")
        a.label("ss_match")
        a.addi("a0", "a0", 1)
        a.label("ss_next")
        a.addi("t0", "t0", 1)
        a.j("ss_outer")
        a.label("ss_done")
        a.ret()

    def golden(self):
        return self.TEXT.count(self.PAT)


class FFT(Workload):
    """MiBench telecomm/fft: fixed-point butterfly-style mixing."""
    name = "fft"
    N = 64
    BASE = DATA + 0x2800

    def write_data(self, img: Image):
        rng = np.random.RandomState(5)
        self.re = rng.randint(-1000, 1000, size=self.N).astype(np.int64)
        self.im = rng.randint(-1000, 1000, size=self.N).astype(np.int64)
        for i in range(self.N):
            img.store64(self.BASE + i * 8, int(self.re[i]) & ((1 << 64) - 1))
            img.store64(self.BASE + (self.N + i) * 8,
                        int(self.im[i]) & ((1 << 64) - 1))

    def asm(self, a):
        N = self.N
        a.label("workload_entry")
        a.li("s0", self.BASE)
        a.li("s1", self.BASE + N * 8)
        # butterfly pass: (re,im)[i] ⊗ twiddle(i) accumulated
        a.li("a0", 0)
        a.li("t0", 0)
        a.li("t1", N)
        a.li("s2", 987)                # tw_re
        a.li("s3", -654)               # tw_im
        a.label("ff_loop")
        a.slli("t2", "t0", 3)
        a.add("t3", "t2", "s0")
        a.ld("t4", 0, "t3")            # re
        a.add("t3", "t2", "s1")
        a.ld("t5", 0, "t3")            # im
        # out_re = (re*tw_re - im*tw_im) >> 10
        a.mul("s4", "t4", "s2")
        a.mul("s5", "t5", "s3")
        a.sub("s4", "s4", "s5")
        a.srai("s4", "s4", 10)
        # out_im = (re*tw_im + im*tw_re) >> 10
        a.mul("s6", "t4", "s3")
        a.mul("s7", "t5", "s2")
        a.add("s6", "s6", "s7")
        a.srai("s6", "s6", 10)
        a.xor("s8", "s4", "s6")
        a.add("a0", "a0", "s8")
        a.addi("t0", "t0", 1)
        a.blt("t0", "t1", "ff_loop")
        a.ret()

    def golden(self):
        M = (1 << 64) - 1
        acc = 0
        for i in range(self.N):
            re, im = int(self.re[i]), int(self.im[i])
            out_re = (re * 987 - im * (-654)) >> 10
            out_im = (re * (-654) + im * 987) >> 10
            acc = (acc + (out_re ^ out_im)) & M
        return acc


class Patricia(Workload):
    """MiBench network/patricia (analogue): bit-trie insert/search mix."""
    name = "patricia"
    N = 48

    def asm(self, a):
        a.label("workload_entry")
        a.li("a0", 0)
        a.li("t0", 0)
        a.li("t1", self.N)
        a.li("t2", 0xDEADBEEF12345678)
        a.label("pa_loop")
        # key = lcg step; walk 16 bits, accumulate path parity
        a.li("t3", 6364136223846793005)
        a.mul("t2", "t2", "t3")
        a.li("t3", 1442695040888963407)
        a.add("t2", "t2", "t3")
        a.mv("t4", "t2")
        a.li("t5", 16)
        a.label("pa_bits")
        a.andi("t3", "t4", 1)
        a.add("a0", "a0", "t3")
        a.srli("t4", "t4", 1)
        a.addi("t5", "t5", -1)
        a.bnez("t5", "pa_bits")
        a.addi("t0", "t0", 1)
        a.blt("t0", "t1", "pa_loop")
        a.ret()

    def golden(self):
        acc, x = 0, 0xDEADBEEF12345678
        for _ in range(self.N):
            x = _lcg(x)
            acc += bin(x & 0xFFFF).count("1")
        return acc


class Idle(Workload):
    """Balloon guest for the control plane: a finite busy-loop with
    checksum 0.  `FleetService` boots one as the host tenant of a
    resume-only hart when parked guests have no live hart to land on —
    the scheduler needs at least one live slot to boot, and the balloon
    keeps the round-robin alive for a few timeslices while checkpointed
    guests are spliced into the reserved (`None`) slots."""
    name = "idle"
    N = 6000

    def asm(self, a):
        a.label("workload_entry")
        a.li("a0", 0)
        a.li("t0", self.N)
        a.label("id_loop")
        a.addi("t0", "t0", -1)
        a.bnez("t0", "id_loop")
        a.ret()

    def golden(self):
        return 0


WORKLOADS = [BitCount(), BasicMath(), QSort(), Susan(), SHA(), CRC32(),
             Dijkstra(), StringSearch(), FFT()]
WORKLOADS_EXTRA = [Patricia(), Idle()]


# ---------------------------------------------------------------------------
# image builders
# ---------------------------------------------------------------------------

def build_image(workload: Workload, guest: bool) -> np.ndarray:
    """Full bootable memory image (native or guest/VM run)."""
    img = Image(MEM_WORDS)
    fw = _m_firmware(native=not guest)
    img.place_code(M_BOOT, fw.assemble())
    if guest:
        hv = _hypervisor()
        img.place_code(HS_ENTRY, hv.assemble())
    kern = _kernel(native=not guest)
    wl = Asm(WORKLOAD)
    workload.asm(wl)
    kern.labels["workload_entry"] = WORKLOAD
    img.place_code(KERN_ENTRY, kern.assemble())
    img.place_code(WORKLOAD, wl.assemble())
    workload.write_data(img)
    _build_kernel_pts(img, P_KERN)
    if guest:
        _build_gstage_pts(img)
    return img.mem


class _GuestWindow:
    """Image view that places guest-physical content at a host-physical
    window: writes are offset by the window base, while PTE contents keep
    guest-physical ppns (the G-stage adds the offset at run time)."""

    def __init__(self, img: Image, base: int):
        self.img, self.base = img, base

    def store64(self, addr: int, val: int):
        self.img.store64(self.base + addr, val)

    def store_bytes(self, addr: int, data: bytes):
        self.img.store_bytes(self.base + addr, data)

    def place_code(self, base: int, words32: np.ndarray):
        self.img.place_code(self.base + base, words32)

    def pte(self, pa: int, perms: int) -> int:
        return self.img.pte(pa, perms)            # GPA ppn, no offset

    def map_page(self, l0_base: int, va: int, pa: int, perms: int):
        vpn0 = (va >> 12) & 0x1FF
        self.store64(l0_base + vpn0 * 8, self.pte(pa, perms))

    def link(self, table_base: int, idx: int, child_pa: int):
        self.store64(table_base + idx * 8, self.pte(child_pa, PTE_V))


def build_image_nguest(workloads, timeslice: int = DEFAULT_TIMESLICE
                       ) -> np.ndarray:
    """Bootable image running N guest VMs per hart under the preemptive
    scheduler: M firmware → HS scheduler-hypervisor → N VS guests
    round-robin on timer interrupts.  Each guest gets the standard guest
    system image (kernel + workload + VS-stage tables) inside its own
    host-physical window, and a private demand-populated G-stage set.  The
    image size grows with N (`sched_layout(n).mem_words`).

    Entries may be ``None``: such a slot boots parked (ginfo.done = 1, no
    window content, no G-stage links) — a reservation the control plane
    can later fill with a checkpointed guest via ``Fleet.resume_guest``."""
    wls = list(workloads)
    live = tuple(wl is not None for wl in wls)
    lay = sched_layout(len(wls))
    img = Image(lay.mem_words)
    img.place_code(M_BOOT, _m_firmware(native=False,
                                       counteren=True).assemble())
    img.place_code(HS_ENTRY,
                   _scheduler_hypervisor(timeslice, n=len(wls),
                                         live=live).assemble())
    for i, wl in enumerate(wls):
        if wl is None:
            continue
        win = _GuestWindow(img, lay.win[i])
        kern = _kernel(native=False)
        w = Asm(WORKLOAD)
        wl.asm(w)
        kern.labels["workload_entry"] = WORKLOAD
        win.place_code(KERN_ENTRY, kern.assemble())
        win.place_code(WORKLOAD, w.assemble())
        wl.write_data(win)
        _build_kernel_pts(win, P_KERN)
        # G-stage skeleton: non-leaf links only — every leaf is mapped on
        # demand by the scheduler, with the window offset applied
        img.link(lay.g_l2[i], 0, lay.g_l1[i])
        img.link(lay.g_l1[i], 0, lay.g_l0[i])
    return img.mem


def build_image_2guest(wl_a: Workload, wl_b: Workload,
                       timeslice: int = DEFAULT_TIMESLICE) -> np.ndarray:
    """Legacy 2-guest entry point — thin wrapper over the N-guest builder."""
    return build_image_nguest((wl_a, wl_b), timeslice=timeslice)

