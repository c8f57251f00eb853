"""The card's peaks and the least bytes one tick of the fleet needs.

The bytes are counted from the architecture that is simulated, never
from how the port stores it: each hart's architectural state other than
memory is read once and written once a tick, plus the memory words that
the counters say the tick touched.  That is a lower bound, so the tick's
share of its roofline cannot pass 100 %.
"""
from __future__ import annotations

from portbench.reference import consts as C
from portbench.reference import oracle as O

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
H100_HBM_BYTES_PER_S = 3.35e12

WORD = 8                     # an RV64 register, CSR, PC or memory word
FLAG = 1                     # a bit of state, rounded up to a byte

# one hart: pc, x1..x31, the CSR file, exit code, console, the 7 counters
# and the 2 x 3 trap counters in words; privilege, V, halted and done in
# bytes; each TLB entry's VPN and PPN in words and its level, permission
# bits and tags (guest, privilege, SUM, MXR, valid) in a byte each, and
# the replacement pointer in a byte
HART_WORDS = 1 + 31 + C.N_CSR + 2 + 7 + 6
HART_FLAGS = 4
TLB_ENTRY_BYTES = 2 * WORD + 7 * FLAG
HART_STATE_BYTES = (HART_WORDS * WORD + HART_FLAGS * FLAG
                    + O.N_TLB * TLB_ENTRY_BYTES + FLAG)


def tick_bytes(harts: int, instret_per_tick: float,
               walks_per_tick: float) -> float:
    """Least HBM bytes of one tick of ``harts`` harts: the state read and
    written, and per retired instruction one fetch word and one data word,
    and per walk at least one PTE word (all summed over the fleet)."""
    return (2 * harts * HART_STATE_BYTES
            + WORD * (2 * instret_per_tick + walks_per_tick))


def tick_roofline_pct(harts: int, instret_per_tick: float,
                      walks_per_tick: float, tick_device_s: float) -> float:
    """The tick's share of its HBM roofline, in %."""
    least_s = tick_bytes(harts, instret_per_tick, walks_per_tick) \
        / H100_HBM_BYTES_PER_S
    return 100.0 * least_s / tick_device_s
