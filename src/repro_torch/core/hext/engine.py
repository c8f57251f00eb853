"""Run loop of the port — counterpart of ``repro.core.hext.engine``.

:class:`TorchEngine` advances a batched ``HartState`` by up to
``max_ticks`` ticks: a Python loop over chunks of ``machine.step_batched``
with a per-chunk early exit once every hart reports ``done`` (one host
sync per chunk), the reference's ``JitEngine`` semantics — the budget
rounds up to whole chunks, and a chunk that starts with a live hart runs
all of its ticks (done harts are frozen, so extra ticks change nothing).

:func:`diff_states` is the field-by-field architectural differential
compare of the reference (``DIFF_SCALARS``/``DIFF_COUNTERS``, every
register, CSR and memory word).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.hext import csr as C
from repro_torch.core.hext import machine as _machine

__all__ = ["TorchEngine", "diff_states", "diff_arrays", "DIFF_SCALARS",
           "DIFF_COUNTERS"]

DIFF_SCALARS = ("pc", "priv", "virt", "halted", "done", "exit_code",
                "console")
DIFF_COUNTERS = ("instret", "instret_virt", "pagefaults", "walks",
                 "ticks", "timer_irqs", "ctx_switches")


def _n_chunks(max_ticks: int, chunk: int) -> int:
    """Tick budgets round UP to whole chunks (the reference's semantics)."""
    return -(-int(max_ticks) // int(chunk))


class TorchEngine:
    """Eager PyTorch backend: chunks of ``step_batched`` on the state's
    device, one ``all(done)`` host sync per chunk."""

    def run(self, state, max_ticks: int, chunk: int = 256):
        if int(chunk) < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        raw = state.to_raw()
        for _ in range(_n_chunks(max_ticks, chunk)):
            if bool(raw["done"].all()):
                break
            for _ in range(int(chunk)):
                raw = _machine.step_batched(raw)
        return type(state).from_raw(raw)


def diff_arrays(a: Dict[str, np.ndarray], i: int,
                b: Dict[str, np.ndarray], j: int,
                compare_mem: bool = True) -> List[str]:
    """Field-by-field architectural diff of hart ``i`` of raw numpy dict
    ``a`` against hart ``j`` of ``b`` (``HartState.to_numpy`` layout, which
    is also the reference's raw-dict layout)."""
    d: List[str] = []

    def chk(name, x, y):
        if int(x) != int(y):
            d.append(f"{name}: a={int(x):#x} b={int(y):#x}")

    for k in DIFF_SCALARS + DIFF_COUNTERS:
        chk(k, a[k][i], b[k][j])
    for r in range(1, 32):
        chk(f"x{r}", a["regs"][i, r], b["regs"][j, r])
    for idx in range(C.N_CSR):
        chk(f"csr[{idx}]", a["csrs"][i, idx], b["csrs"][j, idx])
    for lvl, nm in enumerate(("M", "HS", "VS")):
        chk(f"exc@{nm}", a["exc_by_level"][i, lvl],
            b["exc_by_level"][j, lvl])
        chk(f"int@{nm}", a["int_by_level"][i, lvl],
            b["int_by_level"][j, lvl])
    if compare_mem:
        ma, mb = a["mem"][i], b["mem"][j]
        bad = np.nonzero(ma != mb)[0]
        if bad.size:
            w = int(bad[0])
            d.append(f"mem[{w * 8:#x}]: a={int(ma[w]):#x} "
                     f"b={int(mb[w]):#x} (+{bad.size - 1} more words)")
    return d


def diff_states(a, b, i: int = 0, j: int = 0,
                compare_mem: bool = True) -> List[str]:
    """Diff hart ``i`` of ``HartState`` ``a`` against hart ``j`` of ``b``:
    pc / x1..x31 / the full CSR file / priv / virt / halted / done /
    exit_code / console / memory / every counter."""
    return diff_arrays(a.to_numpy(), i, b.to_numpy(), j,
                       compare_mem=compare_mem)
