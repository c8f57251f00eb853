"""Coverage-guided differential conformance harness (DESIGN.md §5) — the
port's copy of ``repro.core.hext.torture``: the same generator (a seed
gives byte-identical images and equal configs), with the port's engine as
the machine leg and its :class:`~repro_torch.core.hext.engine.OracleEngine`
as the reference leg.

RiescueC-style torture testing, v2: a seeded generator composes each
scenario from **action blocks** — straight-line fuzz runs, fuel-bounded
backward loops, PTE-rewrite-then-fence sequences, and trap trampolines
that bounce M→HS→VS→VU and back — over randomized Sv39/Sv39x4 page-table
shapes, privilege entry points, delegation masks, and timer arming.  A
sched family composes seeded fuzz bodies with the preemptive N-guest
scheduler (``build_image_nguest``).

Every scenario is self-terminating by construction: backward branches
only appear as fuel-counter loops (a dedicated register outside the fuzz
pool counts down to zero), trampoline bounces advance ``sepc`` by 4 each
time, every capture handler either exits through the DONE MMIO or ecalls
its way down to the terminal M handler, and the WARL delegation masks
make ecall-S/ecall-M undelegable.  Pathological leftovers are bounded by
the tick budget — both models run the same budget, so even a
non-terminating scenario is compared exactly.

Coverage feedback: per-scenario architectural-event signatures (trap
cause × priv × V, fence kind × scope, atp writes, WFI) recorded by the
oracle, plus static shape buckets (mode × paging kinds × block kinds),
hash into a bucket map.  Generation is biased toward unseen buckets:
each case samples ``N_CANDIDATES`` candidate configs and keeps the one
adding the most unseen static buckets (deterministic — replayable from
``(seed, case)`` alone).

Both legs start from the same ``Fleet.from_corpus`` boot, one fleet per
family: the machine leg runs on the fleet's engine (the default of its
device: the CUDA graph on the card, the eager loop on the CPU), the
reference leg on the ``OracleEngine`` backend, which models the software
TLB (scoped fences included) and the ``walks`` counter bit-exactly — the
diff exclusion list is empty.

Repro workflow (``--device cpu`` on a host without a card)::

    PYTHONPATH=src python -m repro_torch.core.hext.torture --seed S --count 256
    PYTHONPATH=src python -m repro_torch.core.hext.torture --seed S --case K -v
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.hext import csr as C
from repro_torch.core.hext import oracle
from repro_torch.core.hext import programs
from repro_torch.core.hext.engine import DIFF_COUNTERS as _COUNTERS
from repro_torch.core.hext.programs import (Asm, Image, G_L0, G_L1, G_L2,
                                      S_L0, S_L1, S_L2, SATP_SV39,
                                      PTE_V, PTE_R, PTE_W, PTE_X, PTE_U,
                                      PTE_A, PTE_D, P_KERN, P_GUEST)

# ---------------------------------------------------------------------------
# scenario memory map (identity VA=GPA=PA; 128 KiB per scenario)
# ---------------------------------------------------------------------------
T_MEM_WORDS = 1 << 14          # 128 KiB — one batch shape for the fuzz family
T_MEM_BYTES = T_MEM_WORDS * 8
TM_HANDLER = 0x0400            # M trap handler (capture + DONE exit)
TS_HANDLER = 0x0600            # HS/S handler (bounce or log+ecall)
TVS_HANDLER = 0x0800           # VS handler (bounce or log+ecall)
T_BODY = 0x1000                # randomized body
T_LOG = 0x2000                 # handler fingerprint page (always mapped RW)
T_DATA_PAGES = (0x3000, 0x4000, 0x5000, 0x6000, 0x7000)
MMIO_DONE = 0x10000008

DEFAULT_SEED = 2026
MAX_TICKS = 1536               # 3 × CHUNK — both models run this exact budget
SCHED_MAX_TICKS = 6144         # sched family: boot + slices need more room
CHUNK = 512
SCHED_EVERY = 8                # case k is a sched scenario iff k%8 == 7
N_CANDIDATES = 4               # configs sampled per case; best-scored wins

MODES = ("M", "HS", "S", "U", "VS", "VU")

_REGS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 18, 19, 20,
         28, 29, 30)
FUEL_REG = 21                  # s5 — loop fuel counter, outside the fuzz pool
SENT_REG = 22                  # s6 — trampoline sentinel, outside the pool
TRAMP_MAGIC = 0x7A3F

# CSRs a body may freely read AND write (tvec/atp writes excluded: they can
# redirect traps/translation at a pc the generator cannot see)
_CSR_RW = (0x100, 0x104, 0x106, 0x140, 0x141, 0x142, 0x143, 0x144, 0x14D,
           0x200, 0x204, 0x240, 0x241, 0x242, 0x243, 0x244, 0x24D,
           0x300, 0x302, 0x303, 0x304, 0x306, 0x340, 0x341, 0x342, 0x343,
           0x344, 0x34A, 0x34B, 0x600, 0x602, 0x603, 0x605, 0x606, 0x607,
           0x643, 0x644, 0x645, 0x64A)
# read-only pool (reads are interesting from every mode: priv/vinst/counteren
# checks); includes tvec/atp regs whose *writes* are excluded above
_CSR_RO = (0xC01, 0xE12, 0x301, 0x105, 0x205, 0x305, 0x180, 0x280, 0x680,
           0x604)


def repro_line(seed: int, case: int, device=None) -> str:
    """The one-command repro of a case; ``--device cpu`` is added when the
    run that found it was on the CPU."""
    dev = "" if device is None or str(device).startswith("cuda") \
        else f" --device {device}"
    return (f"PYTHONPATH=src python -m repro_torch.core.hext.torture "
            f"--seed {seed} --case {case}{dev}")


# ---------------------------------------------------------------------------
# scenario generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Scenario:
    seed: int
    case: int
    image: np.ndarray
    cfg: Dict

    @property
    def name(self) -> str:
        return f"s{self.seed}c{self.case}"

    @property
    def family(self) -> str:
        return self.cfg.get("family", "fuzz")

    @property
    def max_ticks(self) -> int:
        return SCHED_MAX_TICKS if self.family == "sched" else MAX_TICKS


def _rand_u64(rng) -> int:
    return int(rng.integers(0, 1 << 64, dtype=np.uint64))


def _bits(rng, pool, p) -> int:
    return sum(1 << b for b in pool if rng.random() < p)


def _sample_blocks(rng, mode: str) -> List[str]:
    """The action-block sequence: the v2 scenario grammar is
    ``body := block+ ; block := straight | fuel | pte | tramp``."""
    blocks = []
    for _ in range(int(rng.integers(2, 6))):
        r = rng.random()
        if r < 0.40:
            blocks.append("straight")
        elif r < 0.60:
            blocks.append("fuel")
        elif r < 0.80:
            # PTE rewrite needs a legal fence; from VU/U it would trap
            # straight out, so bias it toward the privileged modes
            blocks.append("pte" if mode in ("M", "HS", "S", "VS")
                          or rng.random() < 0.2 else "straight")
        else:
            # a trampoline from M exits at the terminal handler instantly
            blocks.append("tramp" if mode != "M" or rng.random() < 0.1
                          else "straight")
    return blocks


def _sample_cfg(rng) -> Dict:
    mode = MODES[int(rng.integers(0, len(MODES)))]
    virt = mode in ("VS", "VU")
    user = mode in ("U", "VU")
    cfg: Dict = {"family": "fuzz", "mode": mode, "virt": virt, "user": user}

    # translation regimes.  "broken" roots / misaligned superpages can make
    # the S/VS handler unfetchable — the delegation masks below keep the
    # resulting fetch faults at M so no trap chain can loop.
    def stage():
        r = rng.random()
        if r < 0.40:
            return {"on": False}
        out = {"on": True, "root_oob": rng.random() < 0.04,
               "superpage": None}
        if rng.random() < 0.12:
            out["superpage"] = "misaligned" if rng.random() < 0.3 \
                else "aligned"
        return out

    cfg["satp"] = stage() if not virt else (
        {"on": False} if rng.random() < 0.5
        else {"on": True, "root_oob": False, "superpage": None})
    # HS is the hypervisor regime: bias the guest stages ON so its
    # HLV/HSV ops walk two stages; plain S is the pure-native supervisor
    # (otherwise the two modes would sample identical distributions)
    vsatp_p = {"HS": 0.8, "S": 0.1}.get(mode, 0.5)
    hgatp_p = {"HS": 0.7, "S": 0.1}.get(mode, 0.4)
    cfg["vsatp"] = stage() if virt else (
        {"on": rng.random() < vsatp_p, "root_oob": False,
         "superpage": None})
    cfg["hgatp"] = stage() if (virt or rng.random() < hgatp_p) \
        else {"on": False}
    # Bias (not eliminate) broken G roots under V=1: a broken root makes
    # the VS handler unfetchable, which is SAFE only because the
    # hedeleg &= ~(1|1<<12) guard below forces the resulting guest
    # handler-fetch faults to HS/M instead of looping at vstvec
    if virt and cfg["hgatp"].get("root_oob"):
        cfg["hgatp"]["root_oob"] = rng.random() < 0.5
    cfg["g_drop_vs_tables"] = virt and rng.random() < 0.08

    s_broken = cfg["satp"]["on"] and (
        cfg["satp"]["root_oob"] or cfg["satp"]["superpage"] is not None)
    vs_broken = cfg["vsatp"]["on"] and (
        cfg["vsatp"].get("root_oob") or cfg["vsatp"].get("superpage"))
    g_broken = cfg["hgatp"]["on"] and (
        cfg["hgatp"].get("root_oob") or
        cfg["hgatp"].get("superpage") == "misaligned" or
        cfg["g_drop_vs_tables"])

    medeleg = _bits(rng, (0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13, 15,
                          20, 21, 22, 23, 10), 0.35)
    if s_broken or (cfg["satp"]["on"] and user):
        # an S-handler fetch fault must exit at M, not re-delegate
        medeleg &= ~((1 << 1) | (1 << 12))
    hedeleg = _bits(rng, (0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13, 15), 0.35)
    if vs_broken or g_broken or (cfg["vsatp"]["on"] and user):
        hedeleg &= ~((1 << 1) | (1 << 12))
    cfg["medeleg"], cfg["hedeleg"] = medeleg, hedeleg
    cfg["mideleg"] = _bits(rng, (1, 5, 9), 0.4)
    cfg["hideleg"] = _bits(rng, (2, 6, 10), 0.4)

    cfg["mcounteren"] = int(rng.integers(0, 8))
    cfg["hcounteren"] = int(rng.integers(0, 8))
    cfg["scounteren"] = int(rng.integers(0, 8))
    cfg["mstatus_set"] = (
        (C.MSTATUS_SIE if rng.random() < 0.5 else 0) |
        (C.MSTATUS_MIE if rng.random() < 0.4 else 0) |
        (C.MSTATUS_SUM if rng.random() < 0.4 else 0) |
        (C.MSTATUS_MXR if rng.random() < 0.3 else 0) |
        (C.MSTATUS_TW if rng.random() < 0.15 else 0) |
        (C.MSTATUS_TSR if rng.random() < 0.15 else 0))
    cfg["hstatus"] = (
        (C.HSTATUS_VTW if rng.random() < 0.15 else 0) |
        (C.HSTATUS_VTSR if rng.random() < 0.15 else 0) |
        (C.HSTATUS_VTVM if rng.random() < 0.15 else 0) |
        (C.HSTATUS_HU if rng.random() < 0.3 else 0))
    cfg["vsstatus"] = (
        (C.MSTATUS_SIE if rng.random() < 0.5 else 0) |
        (C.MSTATUS_SUM if rng.random() < 0.4 else 0) |
        (C.MSTATUS_MXR if rng.random() < 0.3 else 0) |
        (C.MSTATUS_SPP if rng.random() < 0.5 else 0))
    cfg["mie"] = int(rng.integers(0, 1 << 13))
    cfg["hvip"] = _bits(rng, (2, 6, 10), 0.2)
    cfg["vsie"] = int(rng.integers(0, 1 << 11))
    cfg["htimedelta"] = (0 if rng.random() < 0.6 else
                         int(rng.integers(0, 4096)) if rng.random() < 0.75
                         else _rand_u64(rng))
    cfg["stimecmp_delta"] = int(rng.integers(8, 200)) \
        if rng.random() < 0.35 else None
    cfg["vstimecmp_delta"] = int(rng.integers(8, 200)) \
        if rng.random() < 0.35 else None
    cfg["mtimecmp_delta"] = int(rng.integers(8, 200)) \
        if rng.random() < 0.3 else None
    cfg["use_wfi"] = rng.random() < 0.06
    if cfg["use_wfi"]:
        cfg["mtimecmp_delta"] = cfg["mtimecmp_delta"] or \
            int(rng.integers(32, 200))
        cfg["mie"] |= C.IP_MTIP
    # bias the enables toward what was armed/injected, so interrupts
    # actually fire *during* scenarios instead of after their exit
    for delta_key, bit in (("stimecmp_delta", C.IP_STIP),
                           ("vstimecmp_delta", C.IP_VSTIP),
                           ("mtimecmp_delta", C.IP_MTIP)):
        if cfg[delta_key] is not None and rng.random() < 0.7:
            cfg["mie"] |= bit
    for b in (2, 6, 10):
        if cfg["hvip"] & (1 << b) and rng.random() < 0.6:
            cfg["mie"] |= 1 << b
    cfg["seed_regs"] = {int(r): _rand_u64(rng) for r in
                        rng.choice(_REGS, size=6, replace=False)}
    cfg["blocks"] = _sample_blocks(rng, mode)
    # PTE-rewrite blocks only do interesting work when the guest can
    # reach its own tables through the live translation regime
    cfg["map_tables"] = rng.random() < (0.8 if "pte" in cfg["blocks"]
                                        else 0.2)
    return cfg


def _sample_sched_cfg(rng) -> Dict:
    """A multi-guest scenario: N seeded fuzz bodies under the preemptive
    scheduler (``build_image_nguest``), short timeslice."""
    n = 3 if rng.random() < 0.2 else 2
    guests = [{"seed": int(rng.integers(0, 1 << 31)),
               "n_items": int(rng.integers(6, 18)),
               "wfi": bool(rng.random() < 0.3),
               "loops": bool(rng.random() < 0.5)}
              for _ in range(n)]
    return {"family": "sched", "mode": f"SCHED{n}", "n_guests": n,
            "timeslice": int(rng.integers(60, 260)),
            "guests": guests,
            "use_wfi": any(g["wfi"] for g in guests)}


# -- coverage buckets --------------------------------------------------------

def _stage_kind(st: Dict) -> str:
    if not st.get("on"):
        return "off"
    if st.get("root_oob"):
        return "oob"
    sp = st.get("superpage")
    return f"sp-{sp}" if sp else "on"


def _static_buckets(cfg: Dict) -> frozenset:
    """Shape buckets predictable before running the scenario — the
    scoring signal for candidate selection."""
    if cfg.get("family") == "sched":
        b = {("mode", cfg["mode"]),
             ("sched", cfg["n_guests"], cfg["timeslice"] // 64,
              cfg["use_wfi"])}
        for g in cfg["guests"]:
            b.add(("sched-guest", g["wfi"], g["loops"]))
        return frozenset(b)
    b = {("mode", cfg["mode"]),
         ("paging", _stage_kind(cfg["satp"]), _stage_kind(cfg["vsatp"]),
          _stage_kind(cfg["hgatp"]), cfg["g_drop_vs_tables"]),
         ("tables-mapped", cfg["map_tables"]),
         ("timers", cfg["stimecmp_delta"] is not None,
          cfg["vstimecmp_delta"] is not None,
          cfg["mtimecmp_delta"] is not None, cfg["use_wfi"])}
    for k in cfg["blocks"]:
        b.add(("block", cfg["mode"], k))
    return frozenset(b)


def _is_sched_case(case: int) -> bool:
    return case % SCHED_EVERY == SCHED_EVERY - 1


def _case_rng(seed: int, case: int):
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed, case])))


def _choose_cfg(rng, sched: bool, seen: set) -> Dict:
    """Coverage-biased mutation: sample N candidates, keep the one that
    adds the most unseen static buckets (ties → first).  Deterministic
    given ``seen`` — replayable from (seed, case) alone."""
    sampler = _sample_sched_cfg if sched else _sample_cfg
    cands = [sampler(rng) for _ in range(N_CANDIDATES)]
    scores = [len(_static_buckets(c) - seen) for c in cands]
    cfg = cands[int(np.argmax(scores))]
    seen |= set(_static_buckets(cfg))
    return cfg


def _rand_pte(rng, pa: int, want_user: bool, gstage: bool) -> int:
    """A data-page PTE with randomized quirks (the torture surface)."""
    r = rng.random()
    if r < 0.10:
        return 0                                   # invalid (V=0)
    perms = PTE_V | PTE_R | PTE_A | PTE_D
    if rng.random() < 0.75:
        perms |= PTE_W
    if rng.random() < 0.25:
        perms |= PTE_X
    if gstage:
        if rng.random() >= 0.10:                   # 10%: missing U → GPF
            perms |= PTE_U
    elif want_user:
        if rng.random() < 0.75:
            perms |= PTE_U
    elif rng.random() < 0.35:
        perms |= PTE_U
    if rng.random() < 0.10:
        perms &= ~PTE_A
    if rng.random() < 0.12:
        perms &= ~PTE_D
    if rng.random() < 0.06:                        # reserved W=1/R=0
        perms = (perms | PTE_W) & ~PTE_R
    ppn = pa >> 12
    q = rng.random()
    if q < 0.05:                                   # OOB host page
        ppn = (T_MEM_BYTES >> 12) + int(rng.integers(0, 64))
    elif q < 0.08:                                 # alias another data page
        ppn = int(rng.integers(3, 8))
    return (ppn << 10) | perms


def _atp_value(st: Dict, root: int) -> int:
    if not st["on"]:
        return 0
    if st.get("root_oob"):
        root = T_MEM_BYTES + 0x100000
    return SATP_SV39 | (root >> 12)


def _build_s_tables(img: Image, rng, cfg) -> None:
    img.link(S_L2, 0, S_L1)
    sp = cfg["satp"].get("superpage") if not cfg["virt"] else \
        cfg["vsatp"].get("superpage")
    body_perms = P_KERN | (PTE_U if cfg["user"] else 0)
    if sp:
        ppn = 0 if sp == "aligned" else 1          # low bits ≠ 0 → fault
        img.store64(S_L1 + 0 * 8, (ppn << 10) | body_perms)
        return
    img.link(S_L1, 0, S_L0)
    img.map_page(S_L0, 0x0000, 0x0000, P_KERN)     # boot + handlers
    img.map_page(S_L0, T_BODY, T_BODY, body_perms)
    img.map_page(S_L0, T_LOG, T_LOG, P_KERN)
    if cfg.get("map_tables"):
        # guests may rewrite their own page tables (PTE-rewrite blocks)
        for p in (S_L2, S_L1, S_L0, G_L2, G_L1, G_L0):
            img.map_page(S_L0, p, p, P_KERN | (PTE_U if cfg["user"] else 0))
    for p in T_DATA_PAGES:
        pte = _rand_pte(rng, p, cfg["user"], gstage=False)
        img.store64(S_L0 + ((p >> 12) & 0x1FF) * 8, pte)


def _build_g_tables(img: Image, rng, cfg) -> None:
    img.link(G_L2, 0, G_L1)
    sp = cfg["hgatp"].get("superpage")
    if sp:
        ppn = 0 if sp == "aligned" else 1
        img.store64(G_L1 + 0 * 8, (ppn << 10) | P_GUEST)
        return
    img.link(G_L1, 0, G_L0)
    for p in (0x0000, T_BODY, T_LOG):
        img.map_page(G_L0, p, p, P_GUEST)
    if not cfg["g_drop_vs_tables"]:
        for p in (S_L2, S_L1, S_L0):               # VS-stage table GPAs
            img.map_page(G_L0, p, p, P_GUEST)
    if cfg.get("map_tables"):
        for p in (G_L2, G_L1, G_L0):               # G tables as GPAs too
            img.map_page(G_L0, p, p, P_GUEST)
    for p in T_DATA_PAGES:
        pte = _rand_pte(rng, p, cfg["user"], gstage=True)
        img.store64(G_L0 + ((p >> 12) & 0x1FF) * 8, pte)


# -- body emission: action blocks --------------------------------------------

def _rand_addr(rng) -> int:
    r = rng.random()
    if r < 0.55:                                   # aligned data
        sz = 1 << int(rng.integers(0, 4))
        off = int(rng.integers(0, 0x5000 // sz)) * sz
        return 0x3000 + off
    if r < 0.70:                                   # misaligned data
        return 0x3000 + int(rng.integers(0, 0x5000))
    if r < 0.74:                                   # code / log page
        return int(rng.choice([T_BODY + 0x800, T_LOG + 0x80,
                               T_LOG + int(rng.integers(0, 0xF8))]))
    if r < 0.86:                                   # OOB physical
        return T_MEM_BYTES + int(rng.integers(0, 1 << 20))
    return int(rng.choice([0x10000000, 0x10000010, 0x10004000,
                           0x1000BFF8])) + int(rng.integers(0, 2)) * 4


_LOADS = ("lb", "lh", "lw", "ld", "lbu", "lhu", "lwu")
_STORES = ("sb", "sh", "sw", "sd")
_ALU_RR = ("add", "sub", "sll", "slt", "sltu", "xor", "srl", "sra", "or_",
           "and_", "mul", "mulhu", "div", "divu", "rem", "remu", "addw",
           "subw")
_ALU_I = ("addi", "slti", "sltiu", "xori", "ori", "andi", "addiw")
_HLV = ("hlv_b", "hlv_bu", "hlv_h", "hlv_hu", "hlvx_hu", "hlv_w", "hlv_wu",
        "hlvx_wu", "hlv_d")
_HSV = ("hsv_b", "hsv_h", "hsv_w", "hsv_d")


def _emit_fence(a: Asm, rng, rreg) -> None:
    """A fence, address-scoped half the time (rs1 = a random VA page —
    the scoped-invalidation surface the TLB must honor)."""
    kind = rng.random()
    if rng.random() < 0.5:
        ar = rreg()
        a.li(ar, int(rng.choice(T_DATA_PAGES)) + int(rng.integers(0, 2)) * 8)
        if kind < 0.5:
            a.sfence_vma(rs1=ar)
        elif kind < 0.75:
            a.hfence_vvma(rs1=ar)
        else:
            a.hfence_gvma(rs1=ar)
    else:
        if kind < 0.5:
            a.sfence_vma()
        elif kind < 0.75:
            a.hfence_vvma()
        else:
            a.hfence_gvma()


def _emit_item(a: Asm, rng, cfg, case: int, uid: List[int],
               tame: bool = False) -> None:
    """One fuzz item.  ``tame=True`` (loop interiors) drops the items
    that unconditionally leave the body (trap-outs, wild jumps, WFI) so
    fuel loops actually iterate."""
    rreg = lambda: int(rng.choice(_REGS))
    r = rng.random() * (0.90 if tame else 1.0)
    if r < 0.22:                                   # ALU reg-reg
        getattr(a, str(rng.choice(_ALU_RR)))(rreg(), rreg(), rreg())
    elif r < 0.34:                                 # ALU imm / shifts
        if rng.random() < 0.3:
            getattr(a, str(rng.choice(("slli", "srli", "srai"))))(
                rreg(), rreg(), int(rng.integers(0, 64)))
        else:
            getattr(a, str(rng.choice(_ALU_I)))(
                rreg(), rreg(), int(rng.integers(-2048, 2048)))
    elif r < 0.40:
        a.li(rreg(), _rand_u64(rng))
    elif r < 0.52:                                 # load
        ar = rreg()
        a.li(ar, _rand_addr(rng))
        getattr(a, str(rng.choice(_LOADS)))(rreg(), 0, ar)
    elif r < 0.62:                                 # store
        ar = rreg()
        a.li(ar, _rand_addr(rng))
        getattr(a, str(rng.choice(_STORES)))(rreg(), 0, ar)
    elif r < 0.74:                                 # CSR op
        if rng.random() < 0.25:
            a.csrr(rreg(), int(rng.choice(_CSR_RO)))
        else:
            addr = int(rng.choice(_CSR_RW))
            k = rng.random()
            if k < 0.4:
                vr = rreg()
                a.li(vr, _rand_u64(rng) if rng.random() < 0.5
                     else int(rng.integers(0, 1 << 16)))
                getattr(a, str(rng.choice(("csrrw", "csrrs",
                                           "csrrc"))))(rreg(), addr, vr)
            else:
                getattr(a, str(rng.choice(("csrrwi", "csrrsi",
                                           "csrrci"))))(
                    rreg(), addr, int(rng.integers(0, 32)))
    elif r < 0.78:                                 # hlv / hsv
        ar = rreg()
        a.li(ar, _rand_addr(rng))
        if rng.random() < 0.6:
            getattr(a, str(rng.choice(_HLV)))(rreg(), ar)
        else:
            getattr(a, str(rng.choice(_HSV)))(rreg(), ar)
    elif r < 0.84:                                 # forward branch
        lab = f"c{case}u{uid[0]}"
        uid[0] += 1
        getattr(a, str(rng.choice(("beq", "bne", "blt", "bge", "bltu",
                                   "bgeu"))))(rreg(), rreg(), lab)
        for _ in range(int(rng.integers(1, 3))):
            a.addi(rreg(), rreg(), int(rng.integers(-64, 64)))
        a.label(lab)
    elif r < 0.87:                                 # time read
        a.csrr(rreg(), 0xC01)
    elif r < 0.90:
        _emit_fence(a, rng, rreg)
    elif r < 0.92 and cfg["use_wfi"]:
        a.wfi()
    elif r < 0.96:                                 # wild jump
        ar = rreg()
        a.li(ar, int(rng.choice([0x3400, 0x7008, T_MEM_BYTES + 64,
                                 0x100000])))
        a.jalr(int(rng.choice([0, 1])), 0, ar)
    else:                                          # early trap out
        [a.ecall, a.ebreak, a.sret, a.mret][int(rng.integers(0, 4))]()


def _block_straight(a: Asm, rng, cfg, case: int, uid: List[int]) -> None:
    for _ in range(int(rng.integers(3, 11))):
        _emit_item(a, rng, cfg, case, uid)


def _block_fuel(a: Asm, rng, cfg, case: int, uid: List[int]) -> None:
    """A backward branch, guaranteed to terminate: FUEL_REG (outside the
    fuzz register pool, so no item can refill it) counts down to zero."""
    lab = f"c{case}u{uid[0]}"
    uid[0] += 1
    a.li(FUEL_REG, int(rng.integers(2, 7)))
    a.label(lab)
    for _ in range(int(rng.integers(2, 6))):
        _emit_item(a, rng, cfg, case, uid, tame=True)
    a.addi(FUEL_REG, FUEL_REG, -1)
    a.bnez(FUEL_REG, lab)


def _block_pte(a: Asm, rng, cfg, case: int, uid: List[int]) -> None:
    """Rewrite a live data-page PTE mid-run, observe the stale TLB entry,
    fence (scoped or full), observe the fresh walk.  Under paging the
    table pages are only reachable when cfg["map_tables"]; an unreachable
    store simply faults out through the capture handlers."""
    rreg = lambda: int(rng.choice(_REGS))
    page = int(rng.choice(T_DATA_PAGES))
    use_g = cfg.get("hgatp", {}).get("on") and rng.random() < 0.4
    table = G_L0 if use_g else S_L0
    ar, vr, dr = rreg(), rreg(), rreg()
    perms = PTE_V | PTE_R | PTE_A | PTE_D
    if rng.random() < 0.7:
        perms |= PTE_W
    if use_g or rng.random() < 0.5:
        perms |= PTE_U
    if rng.random() < 0.15:
        perms &= ~PTE_V                            # yank the mapping
    ppn = (page >> 12) if rng.random() < 0.6 else int(rng.integers(3, 8))
    a.li(ar, page)
    a.ld(dr, 0, ar)                                # warm the TLB
    a.li(vr, table + ((page >> 12) & 0x1FF) * 8)
    a.li(dr, (ppn << 10) | perms)
    a.sd(dr, 0, vr)                                # rewrite under its feet
    a.ld(dr, 0, ar)                                # stale hit still serves
    if rng.random() < 0.6:                         # scoped: only this page
        if use_g and cfg["mode"] in ("M", "HS", "S"):
            a.hfence_gvma(rs1=ar)
        elif cfg["mode"] in ("M", "HS", "S") and rng.random() < 0.4:
            a.hfence_vvma(rs1=ar)
        else:
            a.sfence_vma(rs1=ar)
    else:
        if use_g and cfg["mode"] in ("M", "HS", "S"):
            a.hfence_gvma()
        else:
            a.sfence_vma()
    a.ld(dr, 0, ar)                                # fresh walk, new PTE


def _block_tramp(a: Asm, rng, cfg, case: int, uid: List[int]) -> None:
    """Trap trampoline: with SENT_REG holding the magic, the HS/VS
    capture handlers *resume* ecalls (epc += 4, sret) instead of
    escalating — bouncing VU→VS→VU / U→S→U / VS→HS→VS.  Each bounce
    advances epc, so progress is guaranteed; clearing the sentinel
    restores the terminal escalation chain."""
    a.li(SENT_REG, TRAMP_MAGIC)
    for _ in range(int(rng.integers(1, 4))):
        a.ecall()
        for _ in range(int(rng.integers(0, 3))):
            _emit_item(a, rng, cfg, case, uid, tame=True)
    a.li(SENT_REG, 0)


_BLOCKS = {"straight": _block_straight, "fuel": _block_fuel,
           "pte": _block_pte, "tramp": _block_tramp}


def _emit_body(a: Asm, rng, cfg, case: int) -> None:
    uid = [0]
    for kind in cfg["blocks"]:
        _BLOCKS[kind](a, rng, cfg, case, uid)
    a.ecall()                                      # terminator


def _emit_boot(a: Asm, rng, cfg) -> None:
    a.li("t0", TM_HANDLER)
    a.csrw(0x305, "t0")
    a.li("t0", TS_HANDLER)
    a.csrw(0x105, "t0")                            # stvec (V=0 at boot)
    a.li("t0", TVS_HANDLER)
    a.csrw(0x205, "t0")                            # vstvec
    for csr, val in ((0x302, cfg["medeleg"]), (0x303, cfg["mideleg"]),
                     (0x602, cfg["hedeleg"]), (0x603, cfg["hideleg"]),
                     (0x306, cfg["mcounteren"]), (0x606, cfg["hcounteren"]),
                     (0x106, cfg["scounteren"]), (0x600, cfg["hstatus"]),
                     (0x200, cfg["vsstatus"]), (0x304, cfg["mie"]),
                     (0x645, cfg["hvip"]), (0x204, cfg["vsie"]),
                     (0x605, cfg["htimedelta"])):
        if val:
            a.li("t0", val)
            a.csrw(csr, "t0")
    if cfg["mstatus_set"]:
        a.li("t0", cfg["mstatus_set"])
        a.csrrs(0, 0x300, "t0")
    a.li("t0", _atp_value(cfg["satp"], S_L2))
    if cfg["satp"]["on"]:
        a.csrw(0x180, "t0")
    a.li("t0", _atp_value(cfg["vsatp"], S_L2))
    if cfg["vsatp"]["on"]:
        a.csrw(0x280, "t0")
    a.li("t0", _atp_value(cfg["hgatp"], G_L2))
    if cfg["hgatp"]["on"]:
        a.csrw(0x680, "t0")
    if cfg["stimecmp_delta"] is not None:
        a.csrr("t0", 0xC01)
        a.addi("t0", "t0", cfg["stimecmp_delta"])
        a.csrw(0x14D, "t0")
    if cfg["vstimecmp_delta"] is not None:
        a.csrr("t0", 0xC01)
        a.csrr("t1", 0x605)
        a.add("t0", "t0", "t1")
        a.addi("t0", "t0", cfg["vstimecmp_delta"])
        a.csrw(0x24D, "t0")
    if cfg["mtimecmp_delta"] is not None:
        a.csrr("t0", 0xC01)
        a.addi("t0", "t0", cfg["mtimecmp_delta"])
        a.li("t1", 0x10004000)
        a.sd("t0", 0, "t1")
    for reg, val in sorted(cfg["seed_regs"].items()):
        a.li(reg, val)
    if cfg["mode"] == "M":
        a.j("body")
        return
    if cfg["virt"]:
        a.li("t0", C.MSTATUS_MPV)
        a.csrrs(0, 0x300, "t0")
    if not cfg["user"]:
        a.li("t0", 1 << 11)                        # MPP = S
        a.csrrs(0, 0x300, "t0")
    a.li("t0", T_BODY)
    a.csrw(0x341, "t0")                            # mepc
    a.mret()


def _emit_handlers(a: Asm) -> None:
    """Fixed capture handlers (same for every scenario).  The HS and VS
    handlers carry a trampoline fast path: an ecall cause (8..10) with
    SENT_REG == TRAMP_MAGIC resumes at epc+4 instead of escalating; the
    M handler is unconditionally terminal, which (with the undelegable
    ecall-S/ecall-M) is the global termination backstop."""
    a.pad_to(TM_HANDLER)
    # M: fingerprint = mcause ^ mtval + mepc + mtval2 → DONE
    a.csrr("t0", 0x342)
    a.csrr("t1", 0x343)
    a.xor("t0", "t0", "t1")
    a.csrr("t1", 0x341)
    a.add("t0", "t0", "t1")
    a.csrr("t1", 0x34B)
    a.add("t0", "t0", "t1")
    a.li("t6", MMIO_DONE)
    a.sd("t0", 0, "t6")
    a.label("m_spin")
    a.j("m_spin")
    a.pad_to(TS_HANDLER)
    # HS/S: trampoline bounce for sentineled ecalls (interrupt causes are
    # negative, so the signed range check routes them to capture)
    a.csrr("t4", 0x142)                            # scause
    a.li("t5", 8)
    a.blt("t4", "t5", "hs_cap")
    a.li("t5", 11)
    a.bge("t4", "t5", "hs_cap")
    a.li("t5", TRAMP_MAGIC)
    a.bne(SENT_REG, "t5", "hs_cap")
    a.csrr("t4", 0x141)                            # sepc
    a.addi("t4", "t4", 4)
    a.csrw(0x141, "t4")
    a.li("t5", T_LOG + 0x20)                       # bounce tally (diffed)
    a.ld("t4", 0, "t5")
    a.addi("t4", "t4", 1)
    a.sd("t4", 0, "t5")
    a.sret()
    a.label("hs_cap")
    # capture: log scause/stval/htval, then ecall down to M (cause 9,
    # undelegable by the WARL medeleg mask)
    a.li("t5", T_LOG)
    a.csrr("t4", 0x142)
    a.sd("t4", 0, "t5")
    a.csrr("t4", 0x143)
    a.sd("t4", 8, "t5")
    a.csrr("t4", 0x643)
    a.sd("t4", 16, "t5")
    a.ecall()
    a.label("s_spin")
    a.j("s_spin")
    a.pad_to(TVS_HANDLER)
    # VS: same bounce (vscause/vsepc via the V=1 swap; only ecall-VU=8
    # can land here), else log vscause/vstval and ecall (10 → HS or M)
    a.csrr("t4", 0x142)
    a.li("t5", 8)
    a.blt("t4", "t5", "vs_cap")
    a.li("t5", 11)
    a.bge("t4", "t5", "vs_cap")
    a.li("t5", TRAMP_MAGIC)
    a.bne(SENT_REG, "t5", "vs_cap")
    a.csrr("t4", 0x141)
    a.addi("t4", "t4", 4)
    a.csrw(0x141, "t4")
    a.li("t5", T_LOG + 0x60)                       # VS bounce tally
    a.ld("t4", 0, "t5")
    a.addi("t4", "t4", 1)
    a.sd("t4", 0, "t5")
    a.sret()
    a.label("vs_cap")
    a.li("t5", T_LOG + 0x40)
    a.csrr("t4", 0x142)
    a.sd("t4", 0, "t5")
    a.csrr("t4", 0x143)
    a.sd("t4", 8, "t5")
    a.ecall()
    a.label("vs_spin")
    a.j("vs_spin")
    a.pad_to(T_BODY)
    a.label("body")


# -- sched-family image: fuzz bodies under the preemptive scheduler ----------

class FuzzGuest(programs.Workload):
    """A seeded VS-safe fuzz body speaking the Workload protocol: only
    touches caller-saved registers (plus s0 as loop fuel), keeps
    loads/stores aligned inside the guest window (the demand pagers
    handle the faults), and optionally sprinkles WFIs — the slice timer
    the scheduler always arms is what wakes them."""
    name = "fuzzguest"
    _POOL = (5, 6, 7, 10, 11, 12, 13, 14, 15, 28, 29, 30)

    def __init__(self, spec: Dict):
        self.spec = spec

    def asm(self, a: Asm):
        rng = np.random.Generator(np.random.PCG64(
            np.random.SeedSequence([self.spec["seed"]])))
        rreg = lambda: int(rng.choice(self._POOL))
        uid = [0]
        a.label("workload_entry")
        for _ in range(self.spec["n_items"]):
            r = rng.random()
            if r < 0.30:
                getattr(a, str(rng.choice(_ALU_RR)))(rreg(), rreg(), rreg())
            elif r < 0.45:
                getattr(a, str(rng.choice(_ALU_I)))(
                    rreg(), rreg(), int(rng.integers(-2048, 2048)))
            elif r < 0.55:
                a.li(rreg(), _rand_u64(rng))
            elif r < 0.72:                         # aligned in-window ld/sd
                ar = rreg()
                a.li(ar, 0x3000 + int(rng.integers(0, 0x1800)) * 8)
                if rng.random() < 0.5:
                    a.ld(rreg(), 0, ar)
                else:
                    a.sd(rreg(), 0, ar)
            elif r < 0.80:
                a.csrr(rreg(), 0xC01)              # time (hcounteren=7)
            elif r < 0.88:
                lab = f"fg{self.spec['seed']}u{uid[0]}"
                uid[0] += 1
                getattr(a, str(rng.choice(("beq", "bne", "bltu"))))(
                    rreg(), rreg(), lab)
                a.addi(rreg(), rreg(), int(rng.integers(-64, 64)))
                a.label(lab)
            elif r < 0.94 and self.spec["loops"]:
                lab = f"fg{self.spec['seed']}u{uid[0]}"
                uid[0] += 1
                a.li(8, int(rng.integers(2, 6)))   # s0 = fuel
                a.label(lab)
                getattr(a, str(rng.choice(_ALU_RR)))(rreg(), rreg(), rreg())
                a.addi(8, 8, -1)
                a.bnez(8, lab)
            elif self.spec["wfi"]:
                a.wfi()
            else:
                getattr(a, str(rng.choice(_ALU_RR)))(rreg(), rreg(), rreg())
        a.xor("a0", "t0", "t1")
        a.add("a0", "a0", "a2")
        a.ret()

    def golden(self) -> int:
        return 0                                   # diffed, never asserted


def _build_sched_image(cfg: Dict) -> np.ndarray:
    wls = [FuzzGuest(g) for g in cfg["guests"]]
    return programs.build_image_nguest(wls, timeslice=cfg["timeslice"])


def _gen_with_seen(seed: int, case: int, seen: set) -> Scenario:
    rng = _case_rng(seed, case)
    cfg = _choose_cfg(rng, _is_sched_case(case), seen)
    if cfg["family"] == "sched":
        return Scenario(seed=seed, case=case,
                        image=_build_sched_image(cfg), cfg=cfg)
    a = Asm(0)
    _emit_boot(a, rng, cfg)
    _emit_handlers(a)
    _emit_body(a, rng, cfg, case)
    img = Image(T_MEM_WORDS)
    img.place_code(0, a.assemble())
    _build_s_tables(img, rng, cfg)
    _build_g_tables(img, rng, cfg)
    return Scenario(seed=seed, case=case, image=img.mem, cfg=cfg)


def gen_scenario(seed: int, case: int) -> Scenario:
    """Deterministically regenerate scenario `case` of corpus `seed` by
    replaying the coverage-biased candidate choices of cases 0..case-1
    (cfg sampling only — no image assembly, so replay stays cheap)."""
    seen: set = set()
    for k in range(case):
        _choose_cfg(_case_rng(seed, k), _is_sched_case(k), seen)
    return _gen_with_seen(seed, case, seen)


def generate(seed: int, count: int) -> List[Scenario]:
    seen: set = set()
    return [_gen_with_seen(seed, k, seen) for k in range(count)]


# ---------------------------------------------------------------------------
# differential run + diff
# ---------------------------------------------------------------------------

# the comparison scope is defined ONCE in engine.py (shared with
# `engine.diff_states`); the oracle models the software TLB, so `walks`
# is compared exactly — the exclusion list is empty


def _final_arrays(fleet) -> Dict[str, np.ndarray]:
    """Extract a fleet's final state as host arrays (one batched copy)."""
    from repro_torch.core.hext import engine as _engine
    return _engine.state_arrays(fleet.harts.unwrap())


def _fleet_words(image: np.ndarray) -> int:
    """`Fleet.from_corpus`'s default sizing for one image: rounded up to
    a power of two."""
    return 1 << max(len(image) - 1, 1).bit_length()


def _pad_image(image: np.ndarray, mem_words: int) -> np.ndarray:
    """Zero-pad an image so a raw `oracle.run` leg sees the same
    address-space bound (and final-mem shape) as the batched Fleet leg."""
    out = np.zeros(mem_words, dtype=np.uint64)
    out[:len(image)] = image
    return out


def _run_corpus_fleet(scenarios: List[Scenario], max_ticks: int,
                      chunk: int, engine=None,
                      mem_words: Optional[int] = None, device=None
                      ) -> Dict[str, np.ndarray]:
    """Boot the corpus as one batched Fleet on the given engine backend
    and return final-state arrays.  ``engine=None`` is the default engine
    of ``device`` (default ``cuda``: the graph engine); an
    ``OracleEngine`` instance is the pure-Python reference."""
    from repro_torch.core.hext.sim import Fleet
    fleet = Fleet.from_corpus([s.image for s in scenarios],
                              names=[s.name for s in scenarios],
                              mem_words=mem_words, engine=engine,
                              device=device)
    fleet.run(max_ticks, chunk=chunk)
    return _final_arrays(fleet)


def _run_both(scenarios: List[Scenario], max_ticks: int, chunk: int,
              mem_words: Optional[int] = None, device=None, engine=None
              ) -> Dict:
    """Both legs from ONE ``Fleet.from_corpus`` boot: the machine leg on
    the fleet's engine (``engine``, or the device's default), the
    reference leg on an ``OracleEngine`` over the same boot state (the
    engines never write into their input).  Returns both legs' arrays,
    the oracle's events, the walls and the machine engine."""
    from repro_torch.core.hext import engine as _engine
    from repro_torch.core.hext.sim import Fleet
    fleet = Fleet.from_corpus([s.image for s in scenarios],
                              names=[s.name for s in scenarios],
                              mem_words=mem_words, engine=engine,
                              device=device)
    boot = fleet.harts.unwrap()
    card = boot.device.type == "cuda"
    if card:
        torch.cuda.synchronize(boot.device)
    t0 = time.perf_counter()
    fleet.run(max_ticks, chunk=chunk)
    if card:
        torch.cuda.synchronize(boot.device)
    t_mach = time.perf_counter() - t0
    mach = _final_arrays(fleet)
    oeng = _engine.OracleEngine()
    t0 = time.perf_counter()
    orac = _engine.state_arrays(oeng.run(boot, max_ticks, chunk))
    t_orac = time.perf_counter() - t0
    return {"mach": mach, "orac": orac, "events": oeng.last_events,
            "wall_machine": t_mach, "wall_oracle": t_orac,
            "engine": fleet.engine}


def _check_reset_parity(device=None) -> None:
    """The OracleEngine reference leg *adopts* the machine's boot state
    (``resume_state``), which would hide exactly one class of bug: a
    machine reset-state divergence.  Guard it by diffing one fresh
    machine boot (on ``device``) against the oracle's own independent
    reset (non-mem reset state is image-independent, so one check covers
    the corpus — and keeps the single-case ``--case`` repro path, which
    runs ``oracle.run`` from the oracle's reset, equivalent to the corpus
    leg)."""
    from repro_torch.core.hext import engine as _engine
    from repro_torch.core.hext.sim import HartState
    img = np.zeros(64, dtype=np.uint64)
    mach = _engine.state_arrays(HartState.fresh(64, device=device))
    orac = _oracle_arrays(oracle.reset_state(img))
    d = _engine.diff_arrays(mach, 0, orac, 0)
    if d:
        raise AssertionError(
            f"machine reset state diverged from the oracle's independent "
            f"reset: {d[:4]}")


def _oracle_arrays(ost: Dict) -> Dict[str, np.ndarray]:
    """Shape one oracle final state like a batch-of-1 `_final_arrays`."""
    out = {
        "pc": np.array([ost["pc"]], dtype=np.uint64),
        "regs": np.array([ost["regs"]], dtype=np.uint64),
        "csrs": np.array([ost["csrs"]], dtype=np.uint64),
        "priv": np.array([ost["priv"]]),
        "virt": np.array([1 if ost["virt"] else 0]),
        "halted": np.array([1 if ost["halted"] else 0]),
        "mem": np.array([ost["mem"]], dtype=np.uint64),
        "console": np.array([ost["console"]]),
        "done": np.array([1 if ost["done"] else 0]),
        "exit_code": np.array([ost["exit_code"]], dtype=np.uint64),
        "exc_by_level": np.array([ost["exc_by_level"]]),
        "int_by_level": np.array([ost["int_by_level"]]),
    }
    for k in _COUNTERS:
        out[k] = np.array([ost[k]])
    return out


def diff_pair(mach: Dict[str, np.ndarray], i: int,
              orac: Dict[str, np.ndarray], j: int) -> List[str]:
    """Compare machine hart `i` against oracle hart `j`, field by field —
    a thin wrapper over the single shared comparison core
    (`engine.diff_arrays`; in the output `a` is the machine, `b` the
    oracle; every counter including `walks` is in scope)."""
    from repro_torch.core.hext.engine import diff_arrays
    return diff_arrays(mach, i, orac, j)


def diff_case(mach: Dict[str, np.ndarray], i: int, ost: Dict) -> List[str]:
    """Compare machine hart `i` against an oracle final-state dict (the
    single-case repro path)."""
    return diff_pair(mach, i, _oracle_arrays(ost), 0)


# ---------------------------------------------------------------------------
# coverage accounting
# ---------------------------------------------------------------------------

def _bucket_key(b) -> str:
    return "|".join(str(x) for x in b)


def coverage_map(scenarios: List[Scenario],
                 events_by_case: Dict[int, frozenset]) -> Dict[str, int]:
    """Histogram of coverage buckets over a corpus: the static shape
    buckets plus the oracle-recorded architectural-event signatures
    (trap cause × priv × V, fence kind × scope, atp writes, WFI)."""
    hist: Dict[str, int] = {}
    for s in scenarios:
        buckets = set(_static_buckets(s.cfg))
        buckets |= set(events_by_case.get(s.case, ()))
        for b in sorted(_bucket_key(x) for x in buckets):
            hist[b] = hist.get(b, 0) + 1
    return hist


def run_corpus(seed: int, count: int, max_ticks: int = MAX_TICKS,
               chunk: int = CHUNK, verbose: bool = False, device=None,
               engine=None) -> Dict:
    """Generate, run (per family, one batched Fleet on the machine engine
    and the oracle from the same boot), diff, and bucket coverage.
    ``engine`` is the machine leg's for both families (default: each
    family fleet's own, the device's default).  Returns a report dict."""
    from repro_torch.device import resolve
    dev = resolve(device)
    # the device engine rounds the budget UP to whole chunk-scans; the
    # oracle must run the exact same tick count or budget-burning
    # scenarios would report phantom mismatches
    rnd = lambda t: -(-int(t) // int(chunk)) * int(chunk)
    _check_reset_parity(dev)
    t0 = time.time()
    scenarios = generate(seed, count)
    t_gen = time.time() - t0
    failures: List[Dict] = []
    events_by_case: Dict[int, frozenset] = {}
    t_mach = t_oracle = capture = 0.0
    families = [("fuzz", [s for s in scenarios if s.family == "fuzz"]),
                ("sched", [s for s in scenarios if s.family == "sched"])]
    by_family = {}
    for family, scens in families:
        if not scens:
            continue
        budget = rnd(max_ticks if family == "fuzz"
                     else max(SCHED_MAX_TICKS, max_ticks))
        mem_words = T_MEM_WORDS if family == "fuzz" else None
        legs = _run_both(scens, budget, chunk, mem_words=mem_words,
                         device=dev, engine=engine)
        t_mach += legs["wall_machine"]
        t_oracle += legs["wall_oracle"]
        capture += getattr(legs["engine"], "last_capture_s", 0.0)
        mach, orac = legs["mach"], legs["orac"]
        by_family[family] = {
            "harts": len(scens), "mem_words": int(mach["mem"].shape[1]),
            "ticks": budget, "wall_machine": legs["wall_machine"],
            "wall_oracle": legs["wall_oracle"],
            "engine": legs["engine"].name,
            "capture_s": getattr(legs["engine"], "last_capture_s", None)}
        for i, s in enumerate(scens):
            events_by_case[s.case] = legs["events"][i]
            d = diff_pair(mach, i, orac, i)
            if d:
                failures.append({"case": s.case, "mode": s.cfg["mode"],
                                 "repro": repro_line(seed, s.case, dev.type),
                                 "diff": d})
                if verbose:
                    print(f"MISMATCH case {s.case} ({s.cfg['mode']}): "
                          f"{d[:4]}\n  repro: "
                          f"{repro_line(seed, s.case, dev.type)}")
        del legs, mach, orac
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    hist = coverage_map(scenarios, events_by_case)
    return {
        "seed": seed, "count": count, "max_ticks": rnd(max_ticks),
        "device": str(dev), "failures": failures,
        "coverage": {"buckets": len(hist), "histogram": hist},
        "wall_gen": t_gen, "wall_machine": t_mach, "wall_oracle": t_oracle,
        "capture_s": capture, "families": by_family,
        "scenarios_per_sec_batched": count / max(t_mach, 1e-9),
    }


# ---------------------------------------------------------------------------
# CLI: corpus run, or one-case repro with a full diff dump
# ---------------------------------------------------------------------------

def _write_report(path: Optional[str], rep: Dict) -> None:
    if not path:
        return
    import json
    import os
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(rep, fh, indent=2)


# single-field corruptions of the machine-leg arrays: the mutation hooks
# the exit-status conformance test drives (--inject-fault)
_INJECTORS = {
    "x7": lambda m: m["regs"].__setitem__(
        (0, 7), int(m["regs"][0, 7]) ^ 0xDEAD),
    "pc": lambda m: m["pc"].__setitem__(0, int(m["pc"][0]) ^ 4),
    "instret": lambda m: m["instret"].__setitem__(
        0, int(m["instret"][0]) + 1),
    "walks": lambda m: m["walks"].__setitem__(0, int(m["walks"][0]) + 1),
    "mem": lambda m: m["mem"].__setitem__(
        (0, 0x3000 // 8), int(m["mem"][0, 0x3000 // 8]) ^ 1),
    "exit_code": lambda m: m["exit_code"].__setitem__(
        0, int(m["exit_code"][0]) ^ 1),
}

_CASE_FIELDS = ("pc", "priv", "virt", "halted", "done", "exit_code",
                "console") + tuple(
    ("instret", "instret_virt", "pagefaults", "walks", "ticks",
     "timer_irqs", "ctx_switches"))


def _case_main(seed: int, case: int, max_ticks: int, verbose: bool,
               out: Optional[str] = None,
               inject_fault: Optional[str] = None, device=None) -> int:
    from repro_torch.device import resolve
    dev = resolve(device)
    s = gen_scenario(seed, case)
    max_ticks = -(-int(max(max_ticks, s.max_ticks)) // CHUNK) * CHUNK
    print(f"case {case} of seed {seed}: family={s.family} "
          f"mode={s.cfg['mode']}" +
          (f" satp={s.cfg['satp']} vsatp={s.cfg['vsatp']} "
           f"hgatp={s.cfg['hgatp']} blocks={s.cfg['blocks']}"
           if s.family == "fuzz" else
           f" guests={s.cfg['n_guests']} timeslice={s.cfg['timeslice']}"))
    mem_words = _fleet_words(s.image)
    mach = _run_corpus_fleet([s], max_ticks, CHUNK, mem_words=mem_words,
                             device=dev)
    ost = oracle.run(_pad_image(s.image, mem_words), max_ticks)
    if inject_fault:
        mach = {k: np.array(v) for k, v in mach.items() if k != "tlb"}
        _INJECTORS[inject_fault](mach)
        print(f"(injected fault into machine-leg field {inject_fault!r})")
    # both-model values for every scalar/counter field, pass or fail
    print(f"{'field':<14}{'machine':>20}{'oracle':>20}")
    for k in _CASE_FIELDS:
        mv = int(mach[k][0])
        ov = int(_oracle_arrays(ost)[k][0])
        print(f"{k:<14}{mv:>20}{ov:>20}")
    d = diff_case(mach, 0, ost)
    _write_report(out, {"seed": seed, "case": case, "max_ticks": max_ticks,
                        "mode": s.cfg["mode"], "diff": d,
                        "repro": repro_line(seed, case, dev.type)})
    if d:
        print(f"MISMATCH ({len(d)} fields; a=machine b=oracle):")
        for line in d:
            print(f"  {line}")
        print(f"repro: {repro_line(seed, case, dev.type)}")
        return 1
    print("machine == oracle")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import json
    ap = argparse.ArgumentParser(
        description="coverage-guided differential conformance harness")
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    ap.add_argument("--count", type=int, default=256)
    ap.add_argument("--case", type=int, default=None,
                    help="re-run ONE scenario with a full diff dump")
    ap.add_argument("--max-ticks", type=int, default=MAX_TICKS)
    ap.add_argument("--out", default=None, help="write a JSON report")
    ap.add_argument("--coverage-out", default=None,
                    help="write the coverage-bucket histogram JSON")
    ap.add_argument("--coverage-baseline", default=None,
                    help="fail if bucket count regresses below this "
                         "baseline JSON's 'buckets'")
    ap.add_argument("--inject-fault", default=None,
                    choices=sorted(_INJECTORS),
                    help="corrupt one machine-leg field before diffing "
                         "(single-case mode; exercises the exit status)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.case is not None:
        return _case_main(args.seed, args.case, args.max_ticks, args.verbose,
                          out=args.out, inject_fault=args.inject_fault,
                          device=args.device)
    rep = run_corpus(args.seed, args.count, args.max_ticks,
                     verbose=args.verbose, device=args.device)
    cov = rep["coverage"]
    print(f"seed {rep['seed']}: {rep['count']} scenarios, "
          f"{len(rep['failures'])} mismatches, "
          f"{cov['buckets']} coverage buckets "
          f"(machine {rep['wall_machine']:.1f}s = "
          f"{rep['scenarios_per_sec_batched']:.1f}/s batched, "
          f"oracle {rep['wall_oracle']:.1f}s)")
    for f in rep["failures"]:
        print(f"  case {f['case']} ({f['mode']}): {f['diff'][0]}")
        print(f"    repro: {f['repro']}")
    _write_report(args.out, rep)
    if args.coverage_out:
        _write_report(args.coverage_out,
                      {"seed": rep["seed"], "count": rep["count"],
                       "buckets": cov["buckets"],
                       "histogram": cov["histogram"]})
    rc = 1 if rep["failures"] else 0
    if args.coverage_baseline:
        with open(args.coverage_baseline) as fh:
            base = json.load(fh)
        if cov["buckets"] < int(base["buckets"]):
            print(f"COVERAGE REGRESSION: {cov['buckets']} buckets < "
                  f"baseline {base['buckets']}")
            rc = 1
        else:
            print(f"coverage: {cov['buckets']} buckets >= "
                  f"baseline {base['buckets']}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
