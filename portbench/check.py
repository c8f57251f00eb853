"""What decides ``correct``: the port's answers against the reference.

Once the window has closed, every answer the run produced is compared
with the frozen reference model (:mod:`portbench.reference.oracle`),
which boots the same image the port was given and steps it on the host:

* every lane's whole state at the end of the run — pc, registers, the CSR
  file, privilege, V, memory, the software TLB, halted/done/exit code,
  console and every counter — against the reference's state after as
  many ticks as the lane's job has run (a lane that was refilled
  counts from its splice, so this holds the refill to a fresh boot);
* every job that finished inside the run: its counters and exit code
  against the reference's at the end of the same job, and its exit code
  against its kind's golden where the kind has one.

Jobs of one kind boot from one image and no input reaches them, so the
reference steps each kind once and serves every lane of that kind.
Each number is exact and has the limit 0.
"""
from __future__ import annotations

import collections
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from portbench.reference import oracle as O

U64 = ("pc", "regs", "csrs", "mem", "exit_code")
I64 = ("priv", "console", "instret", "instret_virt", "pagefaults", "walks",
       "ticks", "timer_irqs", "ctx_switches", "exc_by_level",
       "int_by_level")
FLAGS = ("virt", "halted", "done")
TLB_U64 = ("vpn", "ppn")
TLB_I64 = ("level", "perm", "priv", "ptr")
TLB_FLAGS = ("guest", "sum", "mxr", "valid")
COUNTERS = ("done", "exit_code", "instret", "instret_virt", "ticks",
            "exc_by_level", "int_by_level", "pagefaults", "walks",
            "timer_irqs", "ctx_switches")

LIMITS = {"lanes_wrong": 0, "jobs_wrong": 0, "exit_codes_wrong": 0}


def _expected(st: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's state as the host arrays of one hart."""
    out: Dict[str, Any] = {}
    for k in U64:
        out[k] = np.array(st[k], dtype=np.uint64)
    for k in I64:
        out[k] = np.array(st[k], dtype=np.int64)
    for k in FLAGS:
        out[k] = np.array(st[k], dtype=bool)
    t = st["tlb"]
    out["tlb"] = {k: np.array(t[k], dtype=np.uint64) for k in TLB_U64}
    out["tlb"].update({k: np.array(t[k], dtype=np.int64) for k in TLB_I64})
    out["tlb"].update({k: np.array(t[k], dtype=bool) for k in TLB_FLAGS})
    return out


def _leaf(port: Dict[str, Any], key: str, sub: bool = False):
    a = port["tlb"][key] if sub else port[key]
    return a.view(np.uint64) if key in (TLB_U64 if sub else U64) else a


def _wrong_lanes(port: Dict[str, Any], lanes: np.ndarray,
                 exp: Dict[str, Any]) -> Tuple[np.ndarray, List[str]]:
    """(a mask over ``lanes`` of those that differ, the fields that do)."""
    bad = np.zeros(len(lanes), dtype=bool)
    fields: List[str] = []

    def cmp(name, got, want):
        d = (got != want).reshape(len(lanes), -1).any(1)
        if d.any():
            fields.append(name)
        np.logical_or(bad, d, out=bad)

    for k in U64 + I64 + FLAGS:
        cmp(k, _leaf(port, k)[lanes], exp[k])
    for k in TLB_U64 + TLB_I64 + TLB_FLAGS:
        cmp(f"tlb.{k}", _leaf(port, k, sub=True)[lanes], exp["tlb"][k])
    return bad, fields


def compare(port: Dict[str, Any], kinds: List[str], ages: np.ndarray,
            harvest: List[Tuple[str, int, Dict[str, Any]]],
            images: Dict[str, np.ndarray],
            goldens: Dict[str, Optional[int]]) -> Dict[str, int]:
    """Compare a run's answers with the reference; returns the numbers
    that ``LIMITS`` holds, and how many answers there were."""
    by_kind: Dict[str, Dict[int, List[int]]] = collections.defaultdict(
        lambda: collections.defaultdict(list))
    for i, (k, a) in enumerate(zip(kinds, ages)):
        by_kind[k][int(a)].append(i)
    done_by: Dict[str, int] = collections.defaultdict(int)
    for k, a, _ in harvest:
        done_by[k] = max(done_by[k], a)

    lanes_wrong = jobs_wrong = 0
    for kind in sorted(set(by_kind) | set(done_by)):
        st = O.reset_state([int(w) for w in images[kind]])
        t = 0
        for age in sorted(set(by_kind[kind]) | {done_by.get(kind, 0)}):
            while t < age and not st["done"]:
                O.step(st)
                t += 1
            lanes = np.array(by_kind[kind].get(age, []), dtype=np.int64)
            if lanes.size:
                bad, fields = _wrong_lanes(port, lanes, _expected(st))
                if bad.any():
                    lanes_wrong += int(bad.sum())
                    print(f"check: {kind} at {age} ticks: "
                          f"{int(bad.sum())} of {lanes.size} lanes differ "
                          f"({', '.join(fields)}); first lane "
                          f"{int(lanes[bad][0])}", file=sys.stderr)
        want = {k: (list(st[k]) if isinstance(st[k], list) else st[k])
                for k in COUNTERS}
        for k, a, got in harvest:
            if k != kind:
                continue
            if not (st["done"] and st["ticks"] <= a) or \
                    any(got[c] != want[c] for c in COUNTERS):
                jobs_wrong += 1
                if jobs_wrong <= 3:
                    print(f"check: finished {kind} (at age {a}): "
                          f"{got} against {want}", file=sys.stderr)
    exit_wrong = sum(got["exit_code"] != goldens[k] for k, _, got in harvest
                     if goldens[k] is not None)
    return {"lanes_wrong": lanes_wrong, "jobs_wrong": jobs_wrong,
            "exit_codes_wrong": exit_wrong, "lanes": len(kinds),
            "jobs": len(harvest)}
