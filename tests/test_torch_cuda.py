"""Card-only tests of the port (marker ``cuda``; they skip without a GPU).

The CPU path of every function is held against the JAX package by the
other ``test_torch_*`` files; these hold the card against the CPU on the
same seeded inputs (integer semantics of shifts, wrap-around and division
on CUDA), and the CUDA ``pagewalk`` kernel against its plain version.
This file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.hext import csr as C
from repro_torch.core.hext import decode as D
from repro_torch.core.hext import isa as I
from repro_torch.core.hext import machine
from repro_torch.core.hext import programs
from repro_torch.core.hext import tlb as T
from repro_torch.core.hext import translate as X
from repro_torch.core.hext import trap as TR
from repro_torch.core.hext.sim import Fleet
from repro_torch.kernels.pagewalk import kernel as K
from repro_torch.kernels.pagewalk import ops
from repro_torch.kernels.pagewalk.ref import two_stage_translate_ref

pytestmark = pytest.mark.cuda
MASK64 = (1 << 64) - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's card path)")
    return torch.device("cuda")


def _u64(rng, n):
    full = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    small = rng.integers(0, 64, n).astype(np.uint64)
    corner = np.array([0, 1, 1 << 63, MASK64, (1 << 63) - 1, 0xFFFFFFFF,
                       1 << 32], np.uint64)[rng.integers(0, 7, n)]
    pick = rng.integers(0, 3, n)
    out = np.where(pick == 0, full, np.where(pick == 1, small, corner))
    return torch.as_tensor(out.astype(np.uint64).view(np.int64))


def _pick(rng, values, n):
    return torch.as_tensor(np.asarray(values)[rng.integers(0, len(values),
                                                           n)])


def _page_tables(rng, n, words=4096):
    ppn = rng.integers(0, 10, n * words)
    flags = rng.integers(0, 256, n * words)
    ptr = rng.random(n * words) < 0.5
    flags = np.where(ptr, 1 | (flags & 0xD0), flags)
    return torch.as_tensor(((ppn << 10) | flags).reshape(n, words))


def _walk_csrs(rng, n):
    c = _u64(rng, n * C.N_CSR).reshape(n, C.N_CSR)
    for r in (C.R_SATP, C.R_VSATP, C.R_HGATP):
        mode = torch.as_tensor(np.where(rng.random(n) < 0.8, 8, 0))
        c[:, r] = (mode << 60) | torch.as_tensor(rng.integers(0, 8, n))
    return c


def _vas(rng, n):
    return torch.as_tensor((rng.integers(0, 4, n) << 30) |
                           (rng.integers(0, 512, n) << 21) |
                           (rng.integers(0, 512, n) << 12) |
                           rng.integers(0, 4096, n))


def _words(rng, n, opcodes):
    w = rng.integers(0, 1 << 32, n)
    op = np.asarray(opcodes)[rng.integers(0, len(opcodes), n)]
    return torch.as_tensor((w & ~0x7F) | op)


def _case_inputs(name, rng, n=2048):
    """(function, args) of one parity case, built on the CPU."""
    priv = _pick(rng, [0, 1, 3], n)
    virt = torch.as_tensor(rng.random(n) < 0.5)
    if name in ("mulhu", "mulh", "mulhsu", "divs", "rems", "divu", "remu"):
        return getattr(I, name), (_u64(rng, n), _u64(rng, n))
    if name == "alu":
        return (lambda w, a, b: I._alu_result(D.decode(w), a, b),
                (_words(rng, n, [0x33, 0x13, 0x3B, 0x1B]), _u64(rng, n),
                 _u64(rng, n)))
    if name == "csr_read":
        return C.csr_read, (_u64(rng, n * C.N_CSR).reshape(n, C.N_CSR),
                            torch.as_tensor(rng.integers(0, 4096, n)),
                            priv, virt)
    if name == "csr_write":
        return C.csr_write, (_u64(rng, n * C.N_CSR).reshape(n, C.N_CSR),
                             _pick(rng, sorted(k for k in C.CSR_ADDR), n),
                             _u64(rng, n), priv, virt)
    if name == "translate":
        return (lambda m, c, p, v, va, a, fv, hx: X.translate(
            m, c, p, v, va, a, force_virt=fv, hlvx=hx),
            (_page_tables(rng, 256), _walk_csrs(rng, 256), priv[:256],
             virt[:256], _vas(rng, 256), _pick(rng, [0, 1, 2], 256),
             virt[:256].roll(1), virt[:256].roll(2)))
    if name == "take_trap":
        return TR.take_trap, (
            _u64(rng, n * C.N_CSR).reshape(n, C.N_CSR), priv, virt,
            _u64(rng, n), torch.as_tensor(rng.integers(0, 24, n)),
            virt.roll(1), _u64(rng, n), _u64(rng, n), virt.roll(2),
            _u64(rng, n))
    if name == "pending_interrupt":
        c = _u64(rng, n * C.N_CSR).reshape(n, C.N_CSR)
        c[:, C.R_MIP] &= 0x1FFF
        return TR.pending_interrupt, (c, priv, virt)
    if name == "exec_sys":
        return (lambda c, p, v, pc, r, w: I.exec_sys(c, p, v, pc, r,
                                                     D.decode(w)),
                (_u64(rng, n * C.N_CSR).reshape(n, C.N_CSR), priv, virt,
                 _u64(rng, n), _u64(rng, n), _words(rng, n, [0x73])))
    raise KeyError(name)


def _assert_same(a, b, what):
    if isinstance(a, dict):
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    else:
        assert torch.equal(a, b.cpu()), what


CASES = ["mulhu", "mulh", "mulhsu", "divs", "rems", "divu", "remu", "alu",
         "csr_read", "csr_write", "translate", "take_trap",
         "pending_interrupt", "exec_sys"]


@pytest.mark.parametrize("name", CASES)
def test_card_matches_cpu(cuda, name):
    rng = np.random.default_rng(sum(map(ord, name)))
    fn, args = _case_inputs(name, rng)
    want = fn(*args)
    got = fn(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    _assert_same(want, got, name)


def test_fleet_ticks_on_card_match_cpu(cuda):
    fft = next(w for w in programs.WORKLOADS if w.name == "fft")
    cpu = Fleet.boot([fft, fft], guest=[False, True], device="cpu")
    card = Fleet.boot([fft, fft], guest=[False, True], device=cuda)
    a, b = cpu.harts.to_raw(), card.harts.to_raw()
    for tick in range(1, 401):
        a, b = machine.step_batched(a), machine.step_batched(b)
        if tick % 50 == 0:
            _assert_same(a, b, f"tick {tick}")


@pytest.mark.parametrize("B", [1, 7, 512, 513, 262144])
def test_pagewalk_kernel_matches_ref(cuda, B):
    rng = np.random.default_rng(B)
    T_, R, P, G = 8, 64, 512, 4096
    tables = [torch.as_tensor(x, device=cuda) for x in (
        rng.integers(-1, G, (T_, R, P), dtype=np.int32),
        rng.integers(0, 4, (T_, R, P), dtype=np.int32),
        rng.integers(-1, T_ * G, (T_, G), dtype=np.int32))]
    q = [torch.as_tensor(x, device=cuda) for x in (
        rng.integers(0, T_, B, dtype=np.int32),
        rng.integers(0, R, B, dtype=np.int32),
        rng.integers(0, P, B, dtype=np.int32),
        rng.integers(0, 2, B).astype(bool))]
    before = K.two_stage_translate_kernel.launches
    got = ops.two_stage_translate(*tables, *q, device=cuda)
    assert K.two_stage_translate_kernel.launches == before + 1
    for x, y in zip(got, two_stage_translate_ref(*tables, *q)):
        assert torch.equal(x, y)


def test_force_ref_on_card_raises(cuda):
    z = torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda)
    q = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="CPU path"):
        ops.two_stage_translate(z, z, z[0], q, q, q, force="ref",
                                device=cuda)
