"""Batched hart state machine — port of ``repro.core.hext.machine``.

The per-tick pipeline is the reference's, staged the same way:

  ``fetch``  — TLB probe for every hart; the two-stage walk (and the TLB
               fill it feeds) runs only when some *running* hart misses;
  ``decode`` — table-driven expansion to a :class:`decode.MicroOp`;
  ``execute``— uniform opclass contributors (``isa.execute_uop``), with
               the data-side walk and the SYSTEM/CSR contributor each
               behind their own batch-level gate;
  ``retire`` — per-field commit under the batch outcome masks (frozen /
               interrupt / idle / fault / ok); register writeback and the
               store are single conditional scatters.

The store comes in two forms, chosen by ``step_batched(store=)``:

* ``"copy"`` — out of place: the tick returns a new memory tensor and the
  caller's state is left as it was (every engine's tick but the graph's);
* ``"inplace"`` — the word a hart stores (or, for a hart that stores
  nothing, the word already there) is scattered into ``state["mem"]``
  itself, and the result's ``mem`` is that same tensor.  Every read of
  memory in the tick (fetch, the walks, loads, AMOs) is a gather made
  before the store, so the result is the same bit for bit.  Only the
  captured tick uses it, on the static buffers its graph owns
  (``engine.CapturedTicks``).

The reference's four batch-level ``lax.cond`` gates (fetch walk, data
walk, SYSTEM, trap) come in two forms, chosen by ``step_batched(gates=)``:

* ``"host"`` — ``if mask.any():``, one host sync each; the branch that is
  not taken is not run (the eager engine's tick);
* ``"device"`` — every branch runs on every tick and a device-side
  ``mask.any()`` selects, leaf by leaf, between its result and the neutral
  record; no host sync, so a chunk of ticks can be captured as one CUDA
  graph (``engine.GraphEngine``).

Either way a gate that stays shut yields the same neutral record
(:func:`zero_xr`, ``isa.neutral_sys``, the untouched CSR bank), so the two
forms are bit-identical by construction.

The stages run under :mod:`.tracing` spans: ``hext.interrupts``,
``hext.fetch`` (``hext.fetch_walk``: the gated walk and the TLB fill),
``hext.execute`` (``hext.data_walk`` with its fill, ``hext.system``) and
``hext.retire`` (``hext.trap``, ``hext.retire.store``).  Inside a graph
capture each records a pair of timing events into the graph; eagerly,
while a profiler records, each is a host span.

State is a raw dict of tensors with a leading hart dimension B (the
reference's ``_make_state`` keys); ``sim.HartState`` wraps it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.hext import csr as C
from repro_torch.core.hext import decode as D
from repro_torch.core.hext import isa
from repro_torch.core.hext import tlb as TLB
from repro_torch.core.hext import translate as X
from repro_torch.core.hext import tracing
from repro_torch.core.hext import trap as TR
from repro_torch.core.hext.bits import (device_const, lsr, s64, uge,
                                        word_index)

DEFAULT_MEM_WORDS = 1 << 15          # 256 KiB per hart

GATES = ("host", "device")
STORES = ("copy", "inplace")

COUNTER_KEYS = ("instret", "instret_virt", "pagefaults", "walks", "ticks",
                "timer_irqs", "ctx_switches")


def _make_state(mem_words: int, batch: int, device) -> Dict:
    """Power-on raw-dict state for ``batch`` harts (the typed
    ``sim.HartState.fresh`` is the public constructor)."""
    def z(*shape, dtype=torch.int64):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)

    st = {
        "pc": z(),
        "regs": z(32),
        "csrs": C.init_csrs(batch, device),
        "priv": torch.full((batch,), 3, dtype=torch.int64, device=device),
        "virt": z(dtype=torch.bool),
        "mem": z(mem_words),
        "tlb": TLB.init_tlb(batch, device),
        "halted": z(dtype=torch.bool),
        "done": z(dtype=torch.bool),
        "exit_code": z(),
        "console": z(),
        "exc_by_level": z(3),           # M, HS, VS
        "int_by_level": z(3),
    }
    st.update({k: z() for k in COUNTER_KEYS})
    return st


def load_image(state: Dict, image, base: int = 0) -> Dict:
    """Write a uint64-word image ((n,) for every hart, or (B, n)) into
    memory at byte address ``base``."""
    img = torch.as_tensor(np.ascontiguousarray(image).view(np.int64),
                          device=state["mem"].device)
    w = base >> 3
    mem = state["mem"].clone()
    mem[:, w:w + img.shape[-1]] = img
    return {**state, "mem": mem}


# the three comparators are adjacent in the bank
assert (C.R_STIMECMP, C.R_VSTIMECMP) == (C.R_MTIMECMP + 1, C.R_MTIMECMP + 2)
_TIMER_BITS = (C.IP_MTIP, C.IP_STIP, C.IP_VSTIP)


def _advance_timers(csrs):
    """CLINT-style virtual time source: mtime advances once per tick; each
    *armed* comparator (mtimecmp / stimecmp / vstimecmp, Sstc-style) drives
    its mip bit from the (unsigned) comparison.  Disarmed comparators (the
    boot value, 2^64-1) leave their mip bit fully software-owned.

    The VS comparator sees the *guest's* time base: vstimecmp compares
    against mtime + htimedelta."""
    mtime = csrs[:, C.R_MTIME] + 1
    now = torch.stack([mtime, mtime, mtime + csrs[:, C.R_HTIMEDELTA]], 1)
    cmpv = csrs[:, C.R_MTIMECMP:C.R_MTIMECMP + 3]
    armed = cmpv != s64(C.TIMER_DISARMED)
    fired = uge(now, cmpv)
    bits = device_const(_TIMER_BITS, csrs.device)
    # the three bits are distinct, so the sums are ORs
    set_b = ((armed & fired).long() * bits).sum(1)
    clr_b = ((armed & ~fired).long() * bits).sum(1)
    out = csrs.clone()
    out[:, C.R_MTIME] = mtime
    out[:, C.R_MIP] = (csrs[:, C.R_MIP] & ~clr_b) | set_b
    return out


def zero_xr(like) -> X.XResult:
    """Neutral XResult for the gate that skips the walk.  Safe because
    every consumer of a walk-only field is gated on ``walked`` /
    ``xr.fault`` (both forced false on the TLB fast path)."""
    z = torch.zeros_like(like)
    zb = torch.zeros_like(like, dtype=torch.bool)
    return X.XResult(pa=z, fault=zb, cause=z, tval=z, tval2=z, gva=zb,
                     implicit=zb, leaf_pte=z, g_leaf_pte=z, level=z)


def _gather(arr2d, idx):
    """Per-hart dynamic gather: arr2d (B, N), idx (B,) → (B,)."""
    return arr2d.gather(1, idx[:, None])[:, 0]


def _where_tree(cond, a, b):
    """``torch.where(cond, a, b)`` leaf by leaf over matching (named)
    tuples of tensors; ``cond`` is a 0-d bool tensor."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    leaves = [_where_tree(cond, x, y) for x, y in zip(a, b)]
    return type(a)(*leaves) if hasattr(a, "_fields") else tuple(leaves)


def _gated(need, gates: str, span: str, branch, neutral):
    """The reference's batch-level ``lax.cond(need.any(), branch,
    neutral)`` → ``(open, result)``.  ``"host"``: ``open`` is a Python bool
    read from the card and only the chosen side runs; ``"device"``: both
    sides run and ``open`` is a 0-d device bool that selects between them.
    The branch runs under the tracing span ``span`` (inside a captured
    tick, its stage of the stage table)."""
    def run_branch():
        with tracing.span(span):
            return branch()

    if gates == "host":
        open_ = bool(need.any())
        return open_, (run_branch() if open_ else neutral())
    open_ = need.any()
    return open_, _where_tree(open_, run_branch(), neutral())


def fetch(state: Dict, csrs1, m_run, gates: str = "host"):
    """Stage 1: translate PC (TLB fast path, gated walk) and gather the
    instruction word.  Returns (instr, fetch_fault, f_fetch, tlb1, walked)
    where tlb1 carries the fetch-side TLB fill."""
    pc0, priv0, virt0 = state["pc"], state["priv"], state["virt"]
    mem = state["mem"]
    sum_f, mxr_f = X.eff_ctx(csrs1, virt0)
    tv = TLB.lookup(state["tlb"], pc0, virt0, X.ACC_X, priv0, sum_f, mxr_f)
    use_f = tv.use
    walked = ~use_f
    need = m_run & walked
    walk_f, xrw = _gated(
        need, gates, "hext.fetch_walk",
        lambda: X.translate(mem, csrs1, priv0, virt0, pc0, X.ACC_X),
        lambda: zero_xr(pc0))
    pa = torch.where(use_f, tv.pa, xrw.pa)
    xr = xrw._replace(pa=pa, fault=walked & xrw.fault)
    # fetching from a PA beyond memory (MMIO included — nothing up there is
    # executable) is an instruction access fault, not a wrap into RAM
    fetch_oob = ~xr.fault & uge(pa, mem.shape[1] * 8)
    fetch_fault = xr.fault | fetch_oob
    # fetch guest-page-fault tinst is always 0
    f_fetch = isa.Fault(
        fetch_fault,
        torch.where(xr.fault, xr.cause, C.EXC_IACCESS),
        torch.where(xr.fault, xr.tval, pc0),
        torch.where(xr.fault, xr.tval2, 0),
        torch.where(xr.fault, xr.gva, virt0),
        torch.zeros_like(pc0))
    word = _gather(mem, word_index(pa, mem.shape[1]))
    instr = torch.where((pa & 4) != 0, lsr(word, 32), word & 0xFFFFFFFF)
    tlb1 = state["tlb"]
    # a fill needs a walk (``fill`` lies inside ``need``), so a batch with
    # no walk has nothing to fill: the host gate skips it, and under the
    # device gate the all-false mask keeps the old TLB
    if walk_f is not False:
        with tracing.span("hext.fetch_walk"):
            fill = m_run & ~fetch_fault & walked
            tlb1 = TLB.select(fill, isa.tlb_fill(
                {"tlb": state["tlb"], "csrs": csrs1, "priv": priv0,
                 "virt": virt0}, pc0, xr), state["tlb"])
    return instr, fetch_fault, f_fetch, tlb1, walked


def execute(state: Dict, csrs1, tlb1, instr, m_exec, gates: str = "host"):
    """Stages 2+3: decode to micro-ops, translate the data access (TLB
    fast path, gated walk), run the gated SYSTEM contributor, and merge
    everything through ``isa.execute_uop``.  ``m_exec`` masks the harts
    whose execution will actually commit (running, fetch OK) — it opens
    the batch-level gates only; outputs outside the mask are discarded by
    the retire stage."""
    pc0, priv0, virt0 = state["pc"], state["priv"], state["virt"]

    # ---- decode -----------------------------------------------------------
    uop = D.decode(instr)
    rv1 = _gather(state["regs"], uop.rs1)
    rv2 = _gather(state["regs"], uop.rs2)

    # ---- data translation (TLB fast path + gated walk) --------------------
    q = isa.mem_query(csrs1, priv0, virt0, uop, rv1)
    virt_d = virt0 | q.force_virt
    sum_d, mxr_d = X.eff_ctx(csrs1, virt_d)
    tv = TLB.lookup(tlb1, q.addr, virt_d, q.macc, priv0, sum_d, mxr_d)
    use_d = tv.use & ~q.hlvx
    walked_d = ~use_d
    need_d = m_exec & q.mem_op & ~q.misaligned & walked_d
    walk_d, xrw = _gated(
        need_d, gates, "hext.data_walk",
        lambda: X.translate(state["mem"], csrs1, priv0, virt0, q.addr,
                            q.macc, force_virt=q.force_virt, hlvx=q.hlvx),
        lambda: zero_xr(pc0))
    xr = xrw._replace(pa=torch.where(use_d, tv.pa, xrw.pa),
                      fault=walked_d & xrw.fault)

    # ---- SYSTEM contributor (gated: the CSR file ops are heavy) -----------
    sys_need = m_exec & (uop.cls == D.CLS_SYSTEM) & (uop.f3 != 4)
    _, sys = _gated(
        sys_need, gates, "hext.system",
        lambda: isa.exec_sys(csrs1, priv0, virt0, pc0, rv1, uop),
        lambda: isa.neutral_sys(csrs1))

    # ---- merge contributors -----------------------------------------------
    st = dict(state)
    st["csrs"] = csrs1
    st["tlb"] = tlb1
    return isa.execute_uop(st, uop, rv1, rv2, q, xr, walked_d, sys,
                           data_fill=walk_d)


_PF_CAUSES = (C.EXC_IPAGE_FAULT, C.EXC_LPAGE_FAULT, C.EXC_SPAGE_FAULT,
              C.EXC_IGUEST_PAGE_FAULT, C.EXC_LGUEST_PAGE_FAULT,
              C.EXC_SGUEST_PAGE_FAULT)


def retire(state: Dict, csrs1, tlb1, eo: isa.ExecOut, f_fetch, walked_f,
           masks, gates: str = "host", store: str = "copy"):
    """Stage 4: apply outcome-class commit masks per field.  Register
    writeback and the store are single conditional scatters; ``store``
    says whether the store writes a new memory or ``state["mem"]``
    itself (module docstring)."""
    frozen, take, icause, m_run, m_int = masks
    pc0, priv0, virt0 = state["pc"], state["priv"], state["virt"]

    fault = isa.merge_fault(f_fetch, eo.fault)
    m_fault = m_run & fault.fault
    m_ok = m_run & ~fault.fault
    m_trap = m_int | m_fault

    # ---- trap invoke (one gated take_trap for interrupts + faults) -------
    def trap():
        return TR.take_trap(
            csrs1, priv0, virt0, pc0, torch.where(take, icause, fault.cause),
            take, torch.where(take, 0, fault.tval),
            torch.where(take, 0, fault.tval2), ~take & fault.gva,
            torch.where(take, 0, fault.tinst))

    def no_trap():
        z = torch.zeros_like(pc0)
        return csrs1, z, z, torch.zeros_like(virt0), z

    _, (trap_csrs, trap_pc, trap_priv, trap_virt, handled) = _gated(
        m_trap, gates, "hext.trap", trap, no_trap)

    out = dict(state)
    out["pc"] = torch.where(m_trap, trap_pc,
                            torch.where(m_ok, eo.new_pc, pc0))
    out["csrs"] = torch.where(
        frozen[:, None], state["csrs"],
        torch.where(m_trap[:, None], trap_csrs,
                    torch.where(m_ok[:, None], eo.csrs, csrs1)))
    out["priv"] = torch.where(m_trap, trap_priv,
                              torch.where(m_ok, eo.priv, priv0))
    out["virt"] = torch.where(m_trap, trap_virt,
                              torch.where(m_ok, eo.virt, virt0))
    out["halted"] = ~m_trap & torch.where(m_ok, eo.halt, state["halted"])
    # delta retire: one conditional scatter each for regs and memory
    wb_go = (m_ok & eo.do_wb & (eo.rd != 0))
    regs = state["regs"]
    out["regs"] = regs.scatter(1, eo.rd[:, None], torch.where(
        wb_go, eo.wb, _gather(regs, eo.rd))[:, None])
    st_go = m_ok & eo.mem_commit
    mem = state["mem"]
    word = torch.where(st_go, eo.mem_word, _gather(mem, eo.mem_idx))
    # "copy": out of place, one copy of the whole memory a tick;
    # "inplace": one word a hart, written into the caller's memory
    scatter = mem.scatter_ if store == "inplace" else mem.scatter
    with tracing.span("hext.retire.store"):
        out["mem"] = scatter(1, eo.mem_idx[:, None], word[:, None])
    out["tlb"] = TLB.select(m_ok, eo.tlb, tlb1)

    out["console"] = state["console"] + (m_ok & eo.console_inc).long()
    out["done"] = state["done"] | (m_ok & eo.done_set)
    out["exit_code"] = torch.where(m_ok & eo.done_set, eo.exit_code,
                                   state["exit_code"])
    out["ctx_switches"] = state["ctx_switches"] + \
        (m_ok & eo.ctxsw_inc).long()

    # ---- counters ---------------------------------------------------------
    out["instret"] = state["instret"] + m_ok.long()
    out["instret_virt"] = state["instret_virt"] + (m_ok & virt0).long()
    out["walks"] = state["walks"] + (m_run & walked_f).long()
    out["ticks"] = state["ticks"] + (~frozen).long()
    is_pf = torch.isin(fault.cause, device_const(_PF_CAUSES, pc0.device))
    out["pagefaults"] = state["pagefaults"] + (m_fault & is_pf).long()
    is_timer = (icause >= 5) & (icause <= 7)
    out["timer_irqs"] = state["timer_irqs"] + (m_int & is_timer).long()
    h = handled[:, None]
    out["int_by_level"] = state["int_by_level"].scatter_add(
        1, h, m_int.long()[:, None])
    out["exc_by_level"] = state["exc_by_level"].scatter_add(
        1, h, m_fault.long()[:, None])
    return out


def step_batched(state: Dict, gates: str = "host",
                 store: str = "copy") -> Dict:
    """One architectural tick for a (B, ...) hart batch — the fused
    fetch → decode → execute → retire pipeline.  ``gates`` picks the form
    of the four batch-level gates and ``store`` that of the memory store
    (module docstring); the result is the same bit for bit.  With the
    default ``store="copy"`` the input is never written."""
    if gates not in GATES:
        raise ValueError(f"gates must be one of {GATES}, got {gates!r}")
    if store not in STORES:
        raise ValueError(f"store must be one of {STORES}, got {store!r}")
    frozen = state["done"]

    with tracing.span("hext.interrupts"):
        # ---- 0. virtual CLINT tick (frozen harts keep their old csrs) ----
        csrs1 = _advance_timers(state["csrs"])

        # ---- 1. CheckInterrupts (paper Fig 2) ----------------------------
        take, icause = TR.pending_interrupt(csrs1, state["priv"],
                                            state["virt"])
        # halted harts wake on any pending+locally-enabled interrupt (WFI
        # resumes on (mip & mie) != 0 regardless of global enables)
        wake = (csrs1[:, C.R_MIP] & csrs1[:, C.R_MIE]) != 0
        idle = state["halted"] & ~take & ~wake
        m_run = ~frozen & ~take & ~idle
        m_int = ~frozen & take

    # ---- 2..4. fetch → decode+execute → retire ----------------------------
    with tracing.span("hext.fetch"):
        instr, fetch_fault, f_fetch, tlb1, walked_f = fetch(
            state, csrs1, m_run, gates)
    with tracing.span("hext.execute"):
        eo = execute(state, csrs1, tlb1, instr, m_run & ~fetch_fault, gates)
    with tracing.span("hext.retire"):
        return retire(state, csrs1, tlb1, eo, f_fetch, walked_f,
                      (frozen, take, icause, m_run, m_int), gates, store)
