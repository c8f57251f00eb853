"""Shared 64-bit helpers for the port's hext core.

Every 64-bit architectural value (pc, registers, CSRs, memory words, PTEs,
addresses) is carried as ``torch.int64`` holding the two's-complement bit
pattern of the reference's ``uint64``.  ``torch.uint64`` is not usable for
this: add/sub/shifts/``<``/``//``/``%`` and ``index_put`` raise on it.  So
the operations whose meaning depends on signedness are written here once:

* :func:`s64` maps a Python int (taken mod 2**64) to the signed int64 that
  has the same bits — every constant ≥ 2**63 (``misa``'s ``2 << 62``,
  ``~0``, ``TIMER_DISARMED``, ``INT_BIT``) goes through it;
* :func:`ult`/:func:`uge` compare as unsigned;
* :func:`lsr` is the logical right shift;
* :func:`word_index` reproduces the reference's ``(pa >> 3).astype(int32)
  % n`` wrapped word index exactly (truncate to 32 bits, then a
  non-negative remainder), so no gather or scatter can leave the memory.

All functions work elementwise on tensors with a leading hart dimension.
Shift amounts stay inside [0, 63]: a shift by 64 is never relied on.
"""
from __future__ import annotations

import functools

import torch

MASK64 = (1 << 64) - 1
INT_MIN = -(1 << 63)


@functools.lru_cache(maxsize=None)
def device_const(values: tuple, device) -> torch.Tensor:
    """A small int64 constant vector, built once per device (indexing with
    a Python list would copy it to the device on every call)."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def s64(x: int) -> int:
    """Python int mod 2**64 → the signed int64 with the same bits."""
    x &= MASK64
    return x - (1 << 64) if x >> 63 else x


def ult(a, b):
    """Unsigned ``a < b`` on int64 bit patterns."""
    return (a ^ INT_MIN) < (b ^ INT_MIN)


def uge(a, b):
    """Unsigned ``a >= b`` on int64 bit patterns."""
    return (a ^ INT_MIN) >= (b ^ INT_MIN)


def lsr(x, s):
    """Logical right shift of int64 ``x`` by ``s`` ∈ [0, 63] (int or
    tensor)."""
    if isinstance(s, int):
        return x if s == 0 else (x >> s) & ((1 << (64 - s)) - 1)
    # mask of the low 64-s bits: ~((-1 << (63 - s)) << 1); s = 0 gives
    # all ones without ever shifting by 64
    return (x >> s) & ~((-1 << (63 - s)) << 1)


def sext(x, bits: int):
    """Sign-extend the low ``bits`` of x (upper bits ignored)."""
    if bits >= 64:
        return x
    x = x & ((1 << bits) - 1)
    m = 1 << (bits - 1)
    return (x ^ m) - m


def word_index(pa, n_words: int):
    """Word index of byte address ``pa`` as the reference computes it:
    ``(pa >> 3)`` truncated to int32, then ``% n_words`` (non-negative).

    The wrapped index is only a safe-indexing device: a PA beyond memory
    faults in the walker and at the final access, so the wrapped value is
    never architecturally visible."""
    w = lsr(pa, 3) & 0xFFFFFFFF
    w = (w ^ 0x80000000) - 0x80000000          # int32 two's complement
    return torch.remainder(w, n_words)


def read64(mem, pa):
    """Aligned 64-bit word read at physical byte address ``pa`` per hart:
    mem (B, W), pa (B,) → (B,)."""
    idx = word_index(pa, mem.shape[1])
    return mem.gather(1, idx[:, None])[:, 0]


def _size_mask(nbits):
    """(1 << nbits) - 1 for nbits ∈ {8, 16, 32, 64} without a shift by 64."""
    return torch.where(nbits >= 64, -1,
                       (1 << torch.clamp(nbits, max=63)) - 1)


def word_extract(word, pa, size_log2, unsigned):
    """Read 1/2/4/8 bytes out of an aligned 64-bit word (RAM and the CLINT
    MMIO registers)."""
    off = (pa & 7) << 3                                  # bit offset
    v = lsr(word, off)
    nbits = 8 << size_log2
    v = v & _size_mask(nbits)
    shift = 64 - nbits                                   # sign extension
    sv = (v << shift) >> shift
    return torch.where(unsigned, v, sv)


def word_deposit(word, pa, val, size_log2):
    """Merge a 1/2/4/8-byte store into an aligned 64-bit word."""
    off = (pa & 7) << 3
    mask = _size_mask(8 << size_log2)
    return (word & ~(mask << off)) | ((val & mask) << off)
