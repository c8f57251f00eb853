"""Table-driven instruction decode → flat micro-op record — port of
``repro.core.hext.decode``.

The reference's host-built 128-entry numpy tables over the 7-bit major
opcode become device tensors; one gather per table expands a (B,) batch
of 32-bit instruction words into a :class:`MicroOp` (opclass, register
selects, funct fields and the format-selected immediate).  All fields are
int64 (bit patterns of the reference's uint64), ``alu_imm`` is bool.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.hext.bits import sext

# --- opclass indices ---------------------------------------------------------
(CLS_ILLEGAL, CLS_ALU, CLS_ALU32, CLS_LUI, CLS_AUIPC, CLS_JAL, CLS_JALR,
 CLS_BRANCH, CLS_LOAD, CLS_STORE, CLS_SYSTEM, CLS_FENCE,
 N_CLS) = range(13)

CLS_NAMES = ("illegal", "alu", "alu32", "lui", "auipc", "jal", "jalr",
             "branch", "load", "store", "system", "fence")

# --- immediate formats -------------------------------------------------------
(IMM_NONE, IMM_I, IMM_S, IMM_B, IMM_U, IMM_J, N_IMM) = range(7)

# --- host-built lookup tables over the 7-bit major opcode -------------------
_OPC = {
    0x33: (CLS_ALU, IMM_NONE),      # OP
    0x13: (CLS_ALU, IMM_I),         # OP-IMM
    0x3B: (CLS_ALU32, IMM_NONE),    # OP-32
    0x1B: (CLS_ALU32, IMM_I),       # OP-IMM-32
    0x37: (CLS_LUI, IMM_U),
    0x17: (CLS_AUIPC, IMM_U),
    0x6F: (CLS_JAL, IMM_J),
    0x67: (CLS_JALR, IMM_I),
    0x63: (CLS_BRANCH, IMM_B),
    0x03: (CLS_LOAD, IMM_I),
    0x23: (CLS_STORE, IMM_S),
    0x73: (CLS_SYSTEM, IMM_NONE),   # CSR / priv / hlv-hsv / fences(V)
    0x0F: (CLS_FENCE, IMM_NONE),    # FENCE / FENCE.I: architectural no-op
}

OPCLASS_TAB = np.zeros(128, np.int64)
IMMFMT_TAB = np.zeros(128, np.int64)
for _op, (_cls, _fmt) in _OPC.items():
    OPCLASS_TAB[_op] = _cls
    IMMFMT_TAB[_op] = _fmt

# uses-immediate-as-ALU-operand (OP-IMM forms): imm replaces rs2
ALU_IMM_TAB = np.zeros(128, bool)
ALU_IMM_TAB[0x13] = ALU_IMM_TAB[0x1B] = True


class MicroOp(NamedTuple):
    """Decoded record for a (B,) batch of instruction words.

    ``cls`` is the opclass index (``CLS_*``), ``rd``/``rs1``/``rs2`` the
    register selects, ``f3``/``f7`` the funct fields, ``imm`` the
    format-selected sign-extended immediate, ``alu_imm`` whether the ALU
    b-operand is ``imm`` (OP-IMM forms), and ``instr`` the raw word."""

    cls: torch.Tensor
    rd: torch.Tensor
    rs1: torch.Tensor
    rs2: torch.Tensor
    f3: torch.Tensor
    f7: torch.Tensor
    imm: torch.Tensor
    alu_imm: torch.Tensor
    instr: torch.Tensor


@functools.lru_cache(maxsize=None)
def _tables(device):
    return (torch.as_tensor(OPCLASS_TAB, device=device),
            torch.as_tensor(IMMFMT_TAB, device=device),
            torch.as_tensor(ALU_IMM_TAB, device=device))


def imm_fields(instr):
    """The five immediate encodings of ``instr`` (each sign-extended).
    Every field is masked below bit 32, so ``>>`` need not be logical."""
    imm_i = sext(instr >> 20, 12)
    imm_s = sext(((instr >> 20) & ~0x1F) | ((instr >> 7) & 0x1F), 12)
    imm_b = sext((((instr >> 31) & 1) << 12) |
                 (((instr >> 7) & 1) << 11) |
                 (((instr >> 25) & 0x3F) << 5) |
                 (((instr >> 8) & 0xF) << 1), 13)
    imm_u = sext(instr & 0xFFFFF000, 32)
    imm_j = sext((((instr >> 31) & 1) << 20) |
                 (((instr >> 12) & 0xFF) << 12) |
                 (((instr >> 20) & 1) << 11) |
                 (((instr >> 21) & 0x3FF) << 1), 21)
    return imm_i, imm_s, imm_b, imm_u, imm_j


def decode(instr) -> MicroOp:
    """Expand a (B,) int64 batch of instruction words into a MicroOp."""
    opc_t, fmt_t, aluimm_t = _tables(instr.device)
    op7 = instr & 0x7F
    fmt = fmt_t[op7]
    imms = torch.stack((torch.zeros_like(instr),) + imm_fields(instr), 1)
    return MicroOp(
        cls=opc_t[op7],
        rd=(instr >> 7) & 31,
        rs1=(instr >> 15) & 31,
        rs2=(instr >> 20) & 31,
        f3=(instr >> 12) & 7,
        f7=(instr >> 25) & 0x7F,
        imm=imms.gather(1, fmt[:, None])[:, 0],
        alu_imm=aluimm_t[op7],
        instr=instr,
    )
