"""Card-only tests of the port (marker ``cuda``; they skip without a GPU).

The CPU path of every function is held against the JAX package by the
other ``test_torch_*`` files; these hold the card against the CPU on the
same seeded inputs (integer semantics of shifts, wrap-around and division
on CUDA), the CUDA ``pagewalk`` and ``paged_attention`` kernels against
their plain versions, and the hext graph engine (device gates, one CUDA
graph, whose in-place store leaks nothing from one run into the next)
against the eager engine, with a CPU snapshot restored onto the card;
and the fleet operations on the graph engine (a 32-case torture
corpus against the oracle, a migration, ``replace_hart`` with no new
graph, and the service's long-workload park/resume and N=3 shed cases);
and the MoE block and a reduced MoE LM on the card against the CPU; and
the reduced recurrent, state-space, encoder-decoder and frontend LMs;
and one train step of every reduced config.  This file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.hext import csr as C
from repro_torch.core.hext import decode as D
from repro_torch.core.hext import engine as E
from repro_torch.core.hext import isa as I
from repro_torch.core.hext import machine
from repro_torch.core.hext import programs
from repro_torch.core.hext import tlb as T
from repro_torch.core.hext import translate as X
from repro_torch.core.hext import trap as TR
from repro_torch.core.hext.sim import Fleet
from repro_torch.core.vmem import kvcache as KC
from repro_torch.core.vmem import page_table as PT
from repro_torch.kernels.flash_attention import kernel as FAK
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import kernel as PAK
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.pagewalk import kernel as K
from repro_torch.kernels.pagewalk import ops
from repro_torch.kernels.pagewalk.ref import (Coord, translate_ref,
                                              two_stage_translate_ref)
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TF

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


@pytest.mark.parametrize("B", [1, 3, 5, 7, 512, 513, 262144])
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


def test_pagewalk_kernel_out_of_range_coordinates(cuda):
    """Negative coordinates wrap once, then everything is clamped, as in
    the plain version (and a JAX gather); (-1, 0, -1) included."""
    rng = np.random.default_rng(99)
    T_, R, P, G = 3, 4, 5, 6
    tables = [torch.as_tensor(x, device=cuda) for x in (
        rng.integers(-1, G + 2, (T_, R, P), dtype=np.int32),
        rng.integers(0, 4, (T_, R, P), dtype=np.int32),
        rng.integers(-1, 9, (T_, G), dtype=np.int32))]
    coords = [rng.integers(-2 * n, 2 * n, 4096).astype(np.int32)
              for n in (T_, R, P)]
    for c, v in zip(coords, (-1, 0, -1)):
        c[0] = v
    q = [torch.as_tensor(x, device=cuda) for x in coords] + [
        torch.as_tensor(rng.integers(0, 2, 4096).astype(bool), device=cuda)]
    got = K.two_stage_translate_kernel(*tables, *q)
    for x, y in zip(got, two_stage_translate_ref(*tables, *q)):
        assert torch.equal(x, y)


def _walk_tables(rng, dims, cuda, offset=0):
    """Seeded tables on the card; ``offset`` elements into a larger buffer
    (a table base that is not 16-byte aligned)."""
    T_, R, P, G = dims
    out = []
    for lo, hi, shape in ((-1, G + 2, (T_, R, P)), (0, 4, (T_, R, P)),
                          (-1, 4 * G, (T_, G))):
        n = int(np.prod(shape))
        buf = torch.as_tensor(rng.integers(lo, hi, n + offset,
                                           dtype=np.int32), device=cuda)
        out.append(buf[offset:].view(shape))
    return out


def _walk_queries(rng, B, dims, cuda, offset=0):
    """Coordinates in [-2n, 2n) and want_write, each ``offset`` elements
    into its buffer."""
    q = [torch.as_tensor(rng.integers(-2 * n, 2 * n, B + offset,
                                      dtype=np.int32), device=cuda)[offset:]
         for n in dims[:3]]
    return q + [torch.as_tensor(rng.integers(0, 2, B + offset).astype(bool),
                                device=cuda)[offset:]]


@pytest.mark.parametrize("B", [1, 5, 513, 4099, 262143])
def test_pagewalk_kernel_unaligned_bases(cuda, B):
    """Every coordinate 4 bytes and want_write 1 byte past an aligned
    base (and the tables 4 bytes past one), with a ragged length."""
    rng = np.random.default_rng(B)
    dims = (8, 64, 512, 4096)
    tables = _walk_tables(rng, dims, cuda, offset=1)
    q = _walk_queries(rng, B, dims, cuda, offset=1)
    assert all(x.data_ptr() % 16 == 4 for x in q[:3] + tables)
    got = K.two_stage_translate_kernel(*tables, *q)
    for x, y in zip(got, two_stage_translate_ref(*tables, *q)):
        assert torch.equal(x, y)


def test_pagewalk_kernel_large_tables(cuda):
    """Tables of 32 MiB (16 x 256 x 1024 pages, beyond what the L2 keeps
    for long) and a grid that strides: against the plain version."""
    rng = np.random.default_rng(12)
    dims = (16, 256, 1024, 4096)
    tables = _walk_tables(rng, dims, cuda)
    q = _walk_queries(rng, 1 << 20, dims, cuda)
    assert sum(x.nbytes for x in tables) > 32 << 20
    for x, y in zip(K.two_stage_translate_kernel(*tables, *q),
                    two_stage_translate_ref(*tables, *q)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("rows", [128, 1100])
def test_translate_fused_entry_stride0_coordinates(cuda, rows):
    """The fused entry at [B, 1] x [1, P] coordinates (stride 0 on one
    side each), with a fused cache over a random third of the entries:
    bit-equal to its plain version on the same arguments, and to the CPU
    route of ``ops.translate``; 1100 rows (284,900 queries) make the grid
    stride."""
    rng = np.random.default_rng(13)
    dims = (8, 16, 256, 4096)
    tables = _walk_tables(rng, dims, cuda)
    fused = torch.as_tensor(rng.integers(-1, 9999, dims[:3], dtype=np.int32),
                            device=cuda)
    fused_ok = torch.as_tensor(rng.random(dims[:3]) < 0.3, device=cuda)
    t = torch.as_tensor(rng.integers(-9, 9, (rows, 1), dtype=np.int32),
                        device=cuda)
    r = torch.as_tensor(rng.integers(-17, 17, (rows, 1), dtype=np.int32),
                        device=cuda)
    pages = torch.arange(-3, 256, dtype=torch.int32, device=cuda)[None]
    acc = torch.as_tensor(rng.random((rows, 1)) < 0.5, device=cuda)
    plan = ops.plan_coords(t, r, pages, acc, cuda)
    assert (plan.outer, plan.inner) == (rows, 259)
    assert [c[2:] for c in plan.coords] == [(1, 0), (1, 0), (0, 1), (1, 0)]
    args = (*tables, *plan.coords, plan.outer, plan.inner, fused, fused_ok)
    before = K.two_stage_translate_kernel.launches
    got = K.translate_kernel(*args)
    assert K.two_stage_translate_kernel.launches == before + 1
    for x, y in zip(got, translate_ref(*args)):
        assert torch.equal(x, y)
    cpu = ops.translate(*[x.cpu() for x in tables], t.cpu(), r.cpu(),
                        pages.cpu(), acc.cpu(), fused.cpu(), fused_ok.cpu())
    card = ops.translate(*tables, t, r, pages, acc, fused, fused_ok)
    for x, y in zip(card, cpu):
        assert torch.equal(x.cpu(), y)


def test_translate_kernel_rejects_strides_past_storage(cuda):
    """A coordinate whose strides would read past its storage, or go
    backwards, is refused before any pointer reaches the kernel."""
    tables = _walk_tables(np.random.default_rng(14), (2, 3, 4, 5), cuda)
    x = torch.zeros(12, dtype=torch.int32, device=cuda)
    val = Coord(None, 0, 0, 0)
    K.translate_kernel(*tables, Coord(x, 0, 4, 1), val, val, val, 3, 4)
    for bad in (Coord(x, 0, 5, 1), Coord(x[1:], 0, 4, 1),
                Coord(x, 0, -1, 1)):
        with pytest.raises(ValueError, match="storage"):
            K.translate_kernel(*tables, bad, val, val, val, 3, 4)


# aten ops that allocate or make a view and launch nothing on the card
# (a ``to`` that copies has ``_to_copy``/``copy_`` below it)
_LAUNCH_FREE_OPS = {"aten::empty", "aten::empty_strided", "aten::view",
                    "aten::reshape", "aten::_reshape_alias", "aten::expand",
                    "aten::as_strided", "aten::to", "aten::alias",
                    "aten::detach"}


def _launching_ops(event):
    """The aten ops under a profiler event, nested ones included, that
    launch a kernel, copy or make a scalar into a tensor (the CUDA runtime
    calls under it come from CUPTI and are not read)."""
    out = []
    for child in event.cpu_children:
        if child.name.startswith("aten::") and \
                child.name not in _LAUNCH_FREE_OPS:
            out.append(child.name)
        out += _launching_ops(child)
    return out


def test_translate_is_one_launch(cuda):
    """Every form of translate the port calls — translate_block, the
    control plane's Python ints, write_token's 0-d int64 page, the batched
    decode's [B, 1] x [1, P] — is one walk on the card, issues no aten op
    that launches a kernel or copies (CPU-side profiler events, which need
    no CUPTI), and, where the profiler sees the card, no other kernel and
    no host-to-device copy; and it equals the CPU route."""
    tabs, args = {}, {}
    for dev in ("cpu", cuda):
        # made before the profiled calls: making them launches kernels
        args[str(dev)] = (
            torch.tensor(37, device=dev) // 16,
            torch.full((4, 1), 1, dtype=torch.int32, device=dev),
            torch.arange(4, dtype=torch.int32, device=dev)[:, None],
            torch.arange(16, dtype=torch.int32, device=dev)[None])
        kv = KC.PagedKVCache.create(
            n_slots=64, page_size=16, n_kv_heads=1, head_dim=8,
            n_tenants=2, reqs_per_tenant=4, logical_pages=16,
            tenant_pages=32, dtype=torch.float32, device=dev)
        for req in range(4):
            for p in range(1 + 3 * req):
                kv, ok = KC.ensure_mapped(kv, 1, req, p)
                assert ok
        tabs[str(dev)] = kv.tables
    forms = {
        "translate_block": lambda t, a: PT.translate_block(t, 1, 2, 16),
        "ints": lambda t, a: PT.translate(t, 1, 3, 5, use_fused=False),
        "int64 page": lambda t, a: PT.translate(t, 1, 0, a[0],
                                                acc_write=True),
        "batched": lambda t, a: PT.translate(t, *a[1:]),
    }
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, form in forms.items():
        want = form(tabs["cpu"], args["cpu"])
        before = K.two_stage_translate_kernel.launches
        got = form(tabs[str(cuda)], args[str(cuda)])
        assert K.two_stage_translate_kernel.launches == before + 1, name
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y), name
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("translate_call"):
                form(tabs[str(cuda)], args[str(cuda)])
            torch.cuda.synchronize()
        span = [e for e in prof.events() if e.name == "translate_call" and
                e.device_type == torch.autograd.DeviceType.CPU]
        assert len(span) == 1, name
        assert not _launching_ops(span[0]), (name, _launching_ops(span[0]))
        # the span's own annotation on the device's timeline is no kernel
        dev_events = [e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA and
                      e.name != "translate_call"]
        if dev_events:
            assert len([n for n in dev_events
                        if not n.startswith(("Memcpy", "Memset"))]) == 1, \
                (name, dev_events)
            assert not [n for n in dev_events
                        if n.startswith("Memcpy HtoD")], (name, dev_events)


def _attention_inputs(rng, B, H, KV, hd, page, n_pages, dtype, cuda):
    slots = n_pages * B + 2
    q = torch.as_tensor(rng.standard_normal((B, H, hd)), dtype=dtype)
    kp, vp = (torch.as_tensor(rng.standard_normal((slots, page, KV, hd)),
                              dtype=dtype) for _ in range(2))
    pm = rng.integers(0, slots, (B, n_pages)).astype(np.int32)
    pm[:, 1:][rng.random((B, n_pages - 1)) < 0.25] = -1    # holes
    pm[0, -1] = slots + 5                                  # clamped slot
    pm[-1, :] = -1                                         # all unmapped
    lengths = rng.integers(1, n_pages * page + 3, B).astype(np.int32)
    lengths[-2] = 0                                        # empty row
    return [x.to(cuda) for x in (q, kp, vp, torch.as_tensor(pm),
                                 torch.as_tensor(lengths))]


# the JAX tests' shapes, the serving width, a page needing more than 48 KB
# of shared memory, and a head dim that is not a multiple of 4 (the dot
# product's remainder loop)
ATTENTION_SHAPES = [(2, 4, 1, 16, 8, 4), (3, 8, 2, 32, 16, 6),
                    (1, 16, 8, 64, 8, 3), (16, 32, 4, 128, 16, 24),
                    (4, 8, 1, 256, 64, 3), (2, 4, 2, 6, 8, 3)]


@pytest.mark.parametrize("shape", ATTENTION_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_paged_attention_kernel_matches_ref(cuda, shape, dtype):
    """Rows with a valid token agree with the plain version (fp32 3e-5,
    bf16 2e-2); rows with none give the TPU kernel's zeros."""
    B = max(shape[0], 3)
    x = _attention_inputs(np.random.default_rng(sum(shape)), B, *shape[1:],
                          dtype, cuda)
    before = PAK.paged_attention_kernel.launches
    got = pa_ops.paged_attention(*x, shape[3] ** -0.5, device=cuda)
    assert PAK.paged_attention_kernel.launches == before + 1
    want = paged_attention_ref(*x, shape[3] ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    page = shape[4]
    tok = (x[3] >= 0).repeat_interleave(page, dim=1)
    t = torch.arange(tok.shape[1], device=cuda)
    rows = (tok & (t[None] < x[4][:, None])).any(dim=1)
    assert not rows[-1] and not rows[-2] and rows[0]
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got[rows].float(), want[rows].float(),
                               atol=tol, rtol=tol)
    assert torch.equal(got[~rows].float(),
                       torch.zeros_like(got[~rows].float()))


@pytest.mark.parametrize("shape", ATTENTION_SHAPES[:4], ids=str)
def test_paged_attention_kernel_unmapped_reads_zero(cuda, shape):
    """The vmem decode contract: every row, length 0 (the uniform mean of
    the gathered rows) included, agrees with the plain version."""
    B = max(shape[0], 3)
    x = _attention_inputs(np.random.default_rng(7 + sum(shape)), B,
                          *shape[1:], torch.float32, cuda)
    got = PAK.paged_attention_kernel(*x, 0.3, unmapped_reads_zero=1)
    want = paged_attention_ref(*x, 0.3, unmapped_reads_zero=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


def _long_inputs(rng, lengths, n_pages, dtype, cuda, H=32, KV=4, hd=128,
                 page=16):
    """A page table of ``n_pages`` with holes over a shared pool; one row
    per length."""
    B = len(lengths)
    slots = 2 * n_pages
    q = torch.as_tensor(rng.standard_normal((B, H, hd)), dtype=dtype)
    kp, vp = (torch.as_tensor(rng.standard_normal((slots, page, KV, hd)),
                              dtype=dtype) for _ in range(2))
    pm = rng.integers(0, slots, (B, n_pages)).astype(np.int32)
    pm[:, 1:][rng.random((B, n_pages - 1)) < 0.1] = -1
    return [x.to(cuda) for x in (q, kp, vp, torch.as_tensor(pm),
                                 torch.as_tensor(np.asarray(lengths,
                                                            np.int32)))]


# (lengths, n_pages): requests of >= 300 pages (many splits), lengths that
# end mid-split and mid-page, a row whose every split is empty (length 0),
# and single-request calls (B = 1, as the vmem decode path calls it)
LONG_CASES = [((320 * 16, 64 * 5 + 16 * 2 + 7, 0), 320),
              ((300 * 16 - 5, 17, 1), 300),
              ((64 * 5 + 16 * 2 + 7,), 256), ((4095,), 256)]


@pytest.mark.parametrize("unmapped_reads_zero", [0, 1])
@pytest.mark.parametrize("case", LONG_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_paged_attention_kernel_many_splits(cuda, case, dtype,
                                            unmapped_reads_zero):
    lengths, n_pages = case
    x = _long_inputs(np.random.default_rng(len(lengths) + n_pages),
                     lengths, n_pages, dtype, cuda)
    assert PAK.choose_splits(
        len(lengths), 4, 16, n_pages,
        torch.cuda.get_device_properties(cuda).multi_processor_count) > 8
    got = PAK.paged_attention_kernel(
        *x, 128 ** -0.5, unmapped_reads_zero=unmapped_reads_zero)
    want = paged_attention_ref(*x, 128 ** -0.5,
                               unmapped_reads_zero=unmapped_reads_zero)
    torch.cuda.synchronize()
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    if unmapped_reads_zero:
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        return
    tok = (x[3] >= 0).repeat_interleave(16, dim=1)
    t = torch.arange(tok.shape[1], device=cuda)
    rows = (tok & (t[None] < x[4][:, None])).any(dim=1)
    torch.testing.assert_close(got[rows].float(), want[rows].float(),
                               atol=tol, rtol=tol)
    assert torch.equal(got[~rows].float(),
                       torch.zeros_like(got[~rows].float()))


def test_paged_attention_kernel_rejects_bad_inputs(cuda):
    x = _attention_inputs(np.random.default_rng(1), 2, 4, 2, 16, 8, 4,
                          torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple"):
        PAK.paged_attention_kernel(x[0][:, :3].contiguous(), *x[1:], 0.25)
    with pytest.raises(ValueError, match="int32"):
        PAK.paged_attention_kernel(*x[:3], x[3].long(), x[4], 0.25)
    with pytest.raises(ValueError, match="CPU path"):
        pa_ops.paged_attention(*x, 0.25, force="ref", device=cuda)


def test_paged_decode_attention_on_card_matches_cpu(cuda):
    """The vmem path on the card (pagewalk + paged_attention kernels)
    against the same path on the CPU, a hole below the length included."""
    rng = np.random.default_rng(3)
    data = [torch.as_tensor(rng.standard_normal((64, 16, 4, 128)),
                            dtype=torch.float32) for _ in range(2)]
    kvs = {}
    for dev in ("cpu", cuda):
        kv = KC.PagedKVCache.create(
            n_slots=64, page_size=16, n_kv_heads=4, head_dim=128,
            n_tenants=2, reqs_per_tenant=2, logical_pages=8,
            tenant_pages=32, dtype=torch.float32, device=dev)
        for p in range(6):
            kv, ok = KC.ensure_mapped(kv, 1, 1, p)
            assert ok
        kv.k_pool.copy_(data[0])
        kv.v_pool.copy_(data[1])
        # a hole: page 2's tenant page loses its host slot
        tp = int(kv.tables.vs_table[1, 1, 2])
        kv = kv._replace(tables=PT.hfence(PT.unmap_stage2(kv.tables, 1, tp),
                                          1))
        kvs[str(dev)] = kv
    q = torch.as_tensor(rng.standard_normal((32, 128)), dtype=torch.float32)
    for length in (1, 50, 96):
        a = KC.paged_decode_attention(kvs["cpu"], 1, 1, q, length, 0.088)
        pa0 = PAK.paged_attention_kernel.launches
        pw0 = K.two_stage_translate_kernel.launches
        b = KC.paged_decode_attention(kvs[str(cuda)], 1, 1, q.to(cuda),
                                      length, 0.088)
        assert PAK.paged_attention_kernel.launches == pa0 + 1
        assert K.two_stage_translate_kernel.launches == pw0 + 1
        torch.testing.assert_close(b.cpu(), a, atol=3e-5, rtol=3e-5)


# ---------------------------------------------------------------------------
# flash attention and the dense LM serving path
# ---------------------------------------------------------------------------

# (B, S, H, KV, hd, window): tests/test_kernels.py's shapes, then hd = 120
# at a ragged S, windows 1 and >= S, and Danube's head layout (G = 4); then
# hd = 20 (the tensor-core kernel's element loads), a window edge inside a
# key tile with a ragged last tile, and G = 1 at hd = 120; then
# RecurrentGemma's head layout at hd 256 (KV 1, G 16) at a ragged S with a
# window edge inside a 32-key tile, and hd 250 (element loads at HDP 256)
FLASH_SHAPES = [(1, 64, 2, 1, 16, 0), (2, 128, 4, 2, 32, 0),
                (1, 128, 4, 4, 32, 32), (2, 256, 8, 2, 64, 0),
                (1, 100, 8, 2, 120, 32), (2, 77, 4, 2, 120, 1),
                (1, 70, 4, 1, 120, 500), (1, 300, 32, 8, 120, 128),
                (1, 65, 2, 1, 256, 0), (2, 150, 4, 2, 20, 40),
                (1, 257, 4, 1, 128, 64), (1, 200, 4, 4, 120, 0),
                (1, 203, 16, 1, 256, 50), (2, 77, 4, 2, 250, 0),
                (1, 100, 16, 1, 256, 40)]


def _flash_inputs(rng, B, S, H, KV, hd, dtype, dev):
    q = rng.standard_normal((B, S, H, hd)) * 0.5
    k = rng.standard_normal((B, S, KV, hd)) * 0.5
    v = rng.standard_normal((B, S, KV, hd))
    return [torch.as_tensor(x, dtype=torch.float32).to(dtype).to(dev)
            for x in (q, k, v)]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_flash_attention_kernel_matches_ref(cuda, shape, dtype):
    B, S, H, KV, hd, window = shape
    q, k, v = _flash_inputs(np.random.default_rng(sum(shape)), B, S, H, KV,
                            hd, dtype, cuda)
    n0 = FAK.flash_attention_kernel.launches
    got = fa_ops.flash_attention(q, k, v, hd ** -0.5, window)
    assert FAK.flash_attention_kernel.launches == n0 + 1
    want = flash_attention_ref(q, k, v, hd ** -0.5, window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_kernel_unaligned_bases(cuda):
    """bf16 tensors whose data starts 2 bytes past a 16-byte boundary take
    the tensor-core kernel's element loads and agree all the same."""
    B, S, H, KV, hd, window = 1, 130, 4, 2, 64, 48
    q, k, v = _flash_inputs(np.random.default_rng(5), B, S, H, KV, hd,
                            torch.bfloat16, cuda)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        return y

    qs, ks, vs = map(shifted, (q, k, v))
    assert qs.data_ptr() % 16 and qs.is_contiguous()
    got = FAK.flash_attention_kernel(qs, ks, vs, hd ** -0.5, window)
    want = flash_attention_ref(q, k, v, hd ** -0.5, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_attention_kernel_rejects_bad_inputs(cuda):
    q, k, v = _flash_inputs(np.random.default_rng(1), 1, 32, 4, 2, 16,
                            torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple"):
        FAK.flash_attention_kernel(q[:, :, :3].contiguous(), k, v, 0.25)
    with pytest.raises(ValueError, match="float32"):
        FAK.flash_attention_kernel(q, k.bfloat16(), v, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        FAK.flash_attention_kernel(q.transpose(1, 2), k, v, 0.25)
    with pytest.raises(ValueError, match="CPU path"):
        fa_ops.flash_attention(q, k, v, 0.25, force="ref")


def _rel(got, want):
    g, w = got.float().cpu(), want.float().cpu()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def test_dense_lm_on_card_matches_cpu(cuda):
    """Reduced Danube (window 32, ring slabs of 32): prefill of 64 tokens
    (one flash launch per layer) and 4 decode steps on the card against
    the same weights on the CPU, within 2e-2 by row norm (bf16 matmuls
    round differently on the two)."""
    cfg = get_config("h2o_danube_3_4b", reduced=True)
    lm_cpu = TF.init_lm(cfg, 5, device="cpu")
    lm_gpu = TF.init_lm(cfg, 5, device="cpu").to(cuda)
    rng = np.random.default_rng(11)
    B, S = 2, 64
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 4)))
    c_cpu = TF.init_cache(cfg, B, cfg.max_seq, device="cpu")
    c_gpu = TF.init_cache(cfg, B, cfg.max_seq, device=cuda)
    n0 = FAK.flash_attention_kernel.launches
    a, c_cpu = TF.prefill(lm_cpu, cfg, toks[:, :S], c_cpu)
    b, c_gpu = TF.prefill(lm_gpu, cfg, toks[:, :S].to(cuda), c_gpu)
    assert FAK.flash_attention_kernel.launches == n0 + cfg.n_layers
    assert _rel(b, a) <= 2e-2
    for i in range(cfg.n_layers):
        for n in "kv":
            assert _rel(c_gpu[i][n], c_cpu[i][n]) <= 2e-2
    for t in range(4):
        pos = torch.full((B,), S + t)
        a, c_cpu = TF.decode_step(lm_cpu, cfg, toks[:, S + t], pos, c_cpu)
        b, c_gpu = TF.decode_step(lm_gpu, cfg, toks[:, S + t].to(cuda),
                                  pos.to(cuda), c_gpu)
        assert _rel(b, a) <= 2e-2
    assert FAK.flash_attention_kernel.launches == n0 + cfg.n_layers


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_130m",
                                  "whisper_base", "internvl2_2b"])
def test_recurrent_and_enc_dec_lm_on_card_matches_cpu(cuda, arch):
    """Reduced RecurrentGemma (RG-LRU + local attention), Mamba2 (SSD),
    Whisper (encoder frames, cross attention) and InternVL2 (prepended
    patches): prefill of 64 tokens (one flash launch an attention layer)
    and 4 decode steps on the card against the same weights on the CPU,
    logits and every cache entry within 2e-2 by row norm."""
    cfg = get_config(arch, reduced=True)
    lm_cpu = TF.init_lm(cfg, 5, device="cpu")
    lm_gpu = TF.init_lm(cfg, 5, device="cpu").to(cuda)
    g = torch.Generator().manual_seed(13)
    B, S = 2, 64
    toks = torch.randint(0, cfg.vocab_size, (B, S + 4), generator=g)
    extra, F = None, 0
    if cfg.is_enc_dec or cfg.n_frontend_tokens:
        n = cfg.n_enc_ctx if cfg.is_enc_dec else cfg.n_frontend_tokens
        extra = torch.randn((B, n, cfg.d_model), generator=g)
        F = 0 if cfg.is_enc_dec else n
    c_cpu = TF.init_cache(cfg, B, F + S + 4, device="cpu")
    c_gpu = TF.init_cache(cfg, B, F + S + 4, device=cuda)
    n0 = FAK.flash_attention_kernel.launches
    a, c_cpu = TF.prefill(lm_cpu, cfg, toks[:, :S], c_cpu, extra)
    b, c_gpu = TF.prefill(lm_gpu, cfg, toks[:, :S].to(cuda), c_gpu,
                          None if extra is None else extra.to(cuda))
    n_attn = TF.layer_kinds(cfg).count("attn")
    assert FAK.flash_attention_kernel.launches == n0 + n_attn
    assert _rel(b, a) <= 2e-2
    for t in range(4):
        pos = torch.full((B,), F + S + t)
        a, c_cpu = TF.decode_step(lm_cpu, cfg, toks[:, S + t], pos, c_cpu)
        b, c_gpu = TF.decode_step(lm_gpu, cfg, toks[:, S + t].to(cuda),
                                  pos.to(cuda), c_gpu)
        assert _rel(b, a) <= 2e-2
    for lc, lg in zip(c_cpu, c_gpu, strict=True):
        for n in lc:
            x, y = lc[n].float().flatten(1), lg[n].float().cpu().flatten(1)
            assert float((y - x).norm() / x.norm()) <= 2e-2, n
    assert FAK.flash_attention_kernel.launches == n0 + n_attn


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One ``build_train_step`` step of each reduced config (batch 2 x 32
    of ``SyntheticLMData``; whisper's frames, InternVL2's patches) from
    one seeded fp32 state on the card and on the CPU: the loss within
    5e-3 relative and the grad norm within 5e-2 (bf16 products summed in
    another order; an MoE config may route a near-tied token otherwise),
    every updated parameter finite, and no kernel launched (the training
    attention is ``attention_core``)."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.runtime.sharding import single_device_policy
    from repro_torch.runtime.train_loop import (build_train_step,
                                                init_train_state)

    cfg = get_config(arch, reduced=True)
    step = build_train_step(cfg, single_device_policy(),
                            cosine_schedule(1e-3, 0, 10))
    batch = SyntheticLMData(cfg, 2, 32, seed=3).batch_at(0)
    lm_cpu, opt_cpu = init_train_state(cfg, 5, device="cpu")
    lm_gpu, opt_gpu = init_train_state(cfg, 5, device="cpu")
    lm_gpu = lm_gpu.to(cuda)
    opt_gpu = opt_gpu._replace(
        step=opt_gpu.step.to(cuda),
        m={k: x.to(cuda) for k, x in opt_gpu.m.items()},
        v={k: x.to(cuda) for k, x in opt_gpu.v.items()})
    n0 = FAK.flash_attention_kernel.launches
    _, _, a = step(lm_cpu, opt_cpu, batch, 0)
    _, _, b = step(lm_gpu, opt_gpu, batch, 0)
    assert FAK.flash_attention_kernel.launches == n0
    assert abs(float(b["loss"]) - float(a["loss"])) <= \
        5e-3 * abs(float(a["loss"]))
    assert abs(float(b["grad_norm"]) - float(a["grad_norm"])) <= \
        5e-2 * float(a["grad_norm"])
    assert all(bool(torch.isfinite(p).all()) for p in lm_gpu.parameters())


def _row_close(got, want, elem=2e-2, row=1e-2):
    """bf16: by element (of the max value) and by row norm; rows that are
    zero on both sides (tokens whose every assignment dropped) agree."""
    g, w = got.float().cpu(), want.float().cpu()
    assert float((g - w).abs().max()) <= elem * float(w.abs().max())
    gn, wn = (g - w).norm(dim=-1), w.norm(dim=-1)
    assert bool((gn[wn == 0] == 0).all())
    assert float((gn[wn > 0] / wn[wn > 0]).max()) <= row


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "granite_moe_3b_a800m"])
def test_moe_layer_on_card_matches_cpu(cuda, arch):
    """One MoE layer at full width (seeded bf16 experts), 2 x 256 tokens,
    the second row one token repeated (its assignments overflow): the
    CPU's routing of the card's fp32 logits equals the card's (experts,
    gates, ranks, keep set) bit for bit; the card's output is within
    2e-2 by element and 1e-2 by row of the CPU's on that routing; two
    runs on the card are bit-equal."""
    cfg = get_config(arch)
    cpu = MOE.MoE(cfg, torch.Generator().manual_seed(3), device="cpu")
    card = MOE.MoE(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 256, cfg.d_model), generator=g).bfloat16()
    x[1] = x[1, :1]
    xc = x.to(cuda)
    logits = MOE.router_logits(card, cfg, xc)
    gates, experts, _ = MOE.route_logits(cfg, logits, torch.bfloat16)
    g0, e0, _ = MOE.route_logits(cfg, logits.cpu(), torch.bfloat16)
    assert torch.equal(experts.cpu(), e0) and torch.equal(gates.cpu(), g0)
    E, C = MOE._padded_experts(cfg), MOE.capacity(cfg, 256)
    rank, keep = MOE.dispatch(experts, E, C)
    r0, k0 = MOE.dispatch(e0, E, C)
    assert torch.equal(rank.cpu(), r0) and torch.equal(keep.cpu(), k0)
    assert int((~k0[1]).sum()) > 0 and int(e0.max()) < cfg.moe.n_experts
    y1, _ = MOE.apply_moe(card, cfg, xc)
    y2, _ = MOE.apply_moe(card, cfg, xc)
    assert torch.equal(y1, y2)
    want = MOE._gather_moe(cpu, cfg, x, g0, e0)
    _row_close(y1, want)


def test_moe_lm_on_card_matches_cpu(cuda, monkeypatch):
    """Reduced Qwen3-MoE: prefill of 64 tokens (one flash launch a layer)
    and 4 decode steps on the card against the same weights on the CPU,
    logits within 2e-2 by row.  Routing is a step function of h2, which
    the two devices round differently, so each MoE call on the card is
    held on the CPU's h2: the card's h2 within 2e-2 by row of the CPU's,
    the CPU's routing of the card's logits for the CPU's h2 equal to the
    card's, and the card goes on with that routing."""
    cfg = get_config("qwen3_moe_30b_a3b", reduced=True)
    lm_cpu = TF.init_lm(cfg, 5, device="cpu")
    lm_gpu = TF.init_lm(cfg, 5, device="cpu").to(cuda)
    rng = np.random.default_rng(12)
    B, S = 2, 64
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 4)))
    toks[1, :S] = toks[1, 0]
    route, seen = MOE._route, []

    def held(p, cfg, x):
        if not x.is_cuda:
            seen.append(x)
            return route(p, cfg, x)
        want = seen.pop(0)
        _row_close(x, want, row=2e-2)
        logits = MOE.router_logits(p, cfg, want.to(x.device))
        out = MOE.route_logits(cfg, logits, x.dtype)
        ref = MOE.route_logits(cfg, logits.cpu(), x.dtype)
        assert torch.equal(out[1].cpu(), ref[1])
        return out

    monkeypatch.setattr(MOE, "_route", held)
    c_cpu = TF.init_cache(cfg, B, cfg.max_seq, device="cpu")
    c_gpu = TF.init_cache(cfg, B, cfg.max_seq, device=cuda)
    n0 = FAK.flash_attention_kernel.launches
    a, c_cpu = TF.prefill(lm_cpu, cfg, toks[:, :S], c_cpu)
    b, c_gpu = TF.prefill(lm_gpu, cfg, toks[:, :S].to(cuda), c_gpu)
    assert FAK.flash_attention_kernel.launches == n0 + cfg.n_layers
    assert _rel(b, a) <= 2e-2
    for t in range(4):
        pos = torch.full((B,), S + t)
        a, c_cpu = TF.decode_step(lm_cpu, cfg, toks[:, S + t], pos, c_cpu)
        b, c_gpu = TF.decode_step(lm_gpu, cfg, toks[:, S + t].to(cuda),
                                  pos.to(cuda), c_gpu)
        assert _rel(b, a) <= 2e-2
    assert not seen


# ---------------------------------------------------------------------------
# hext engines (last: nothing after them traces the card)
# ---------------------------------------------------------------------------

def _four_harts(dev, engine=None):
    wls = [next(w for w in programs.WORKLOADS if w.name == n)
           for n in ("sha", "fft")]
    return Fleet.boot(wls * 2, guest=[False, False, True, True],
                      device=dev, engine=engine)


@pytest.mark.parametrize("ips", [1, 8])
def test_graph_engine_matches_eager_engine(cuda, ips):
    eager = _four_harts(cuda, "eager").run(512, chunk=512)
    graph = _four_harts(cuda, E.GraphEngine(instrs_per_step=ips))
    graph.run(512, chunk=512)
    for i in range(4):
        assert E.diff_states(graph.harts, eager.harts, i, i) == [], i
    # a second run on the cached graph from a fresh boot agrees too, and
    # the returned state does not alias the graph's static buffers
    again = _four_harts(cuda, graph.engine).run(512, chunk=512)
    held = again.harts.to_numpy()
    _four_harts(cuda, graph.engine).run(64, chunk=64)
    for i in range(4):
        assert E.diff_arrays(held, i, again.harts.to_numpy(), i) == []
        assert E.diff_states(again.harts, eager.harts, i, i) == [], i


@pytest.mark.parametrize("ips", [1, 8])
def test_graph_engine_in_place_store_leaks_nothing(cuda, ips):
    """The captured tick stores into the graph's static memory in place.
    Two fresh states of one shape run one after the other on one engine:
    each equals an eager run of its own, so neither the warm-up tick nor
    the first run's stores reach the second, and a run leaves its input's
    memory as it was."""
    eng = E.GraphEngine(instrs_per_step=ips)
    first = _four_harts(cuda, eng)
    inputs = first.harts.unwrap()
    held = inputs.mem.clone()
    first.run(512, chunk=512)
    assert torch.equal(inputs.mem, held)
    assert not torch.equal(first.harts.mem, held)      # the harts stored
    eager = _four_harts(cuda, "eager").run(512, chunk=512)
    for i in range(4):
        assert E.diff_states(first.harts, eager.harts, i, i) == [], i
    wls = [next(w for w in programs.WORKLOADS if w.name == n)
           for n in ("crc32", "stringsearch")]

    def other(engine):
        return Fleet.boot(wls * 2, guest=[False, False, True, True],
                          device=cuda, engine=engine)

    second = other(eng)
    inputs = second.harts.unwrap()
    held = inputs.mem.clone()
    second.run(512, chunk=512)
    assert eng.n_graphs == 1
    assert torch.equal(inputs.mem, held)
    want = other("eager").run(512, chunk=512)
    for i in range(4):
        assert E.diff_states(second.harts, want.harts, i, i) == [], i


def test_graph_engine_raises_on_cpu_state(cuda):
    with pytest.raises(ValueError, match="CUDA"):
        E.GraphEngine().run(_four_harts("cpu").harts.unwrap(), 32, chunk=32)


def test_cuda_fleet_default_engine_is_graph(cuda):
    assert _four_harts(cuda).engine.name == "graph"
    assert _four_harts("cpu").engine.name == "eager"
    assert _four_harts(cuda, "eager").engine.name == "eager"


def test_restore_onto_card_runs_on_bit_identical(cuda, tmp_path):
    cpu = _four_harts("cpu").run(256, chunk=256)
    path = cpu.snapshot(tmp_path / "fleet.npz")
    card = Fleet.restore(path, device=cuda)
    assert card.engine.name == "graph" and card.harts.device.type == "cuda"
    for i in range(4):
        assert E.diff_states(card.harts, cpu.harts, i, i) == [], i
    cpu.run(256, chunk=256)
    card.run(256, chunk=256)
    for i in range(4):
        assert E.diff_states(card.harts, cpu.harts, i, i) == [], i


# ---------------------------------------------------------------------------
# fleet operations on the card: torture, guest operations, the service
# ---------------------------------------------------------------------------

def test_torture_corpus_on_graph_engine_matches_oracle(cuda):
    """32 scenarios of the fixed-seed corpus (28 fuzz, 4 sched), each
    family one graph on the card, against the oracle from the same boot."""
    from repro_torch.core.hext import torture
    eng = E.GraphEngine()
    rep = torture.run_corpus(torture.DEFAULT_SEED, 32, device=cuda,
                             engine=eng)
    assert rep["failures"] == [], [f["repro"] for f in rep["failures"]]
    assert rep["families"]["fuzz"]["engine"] == "graph"
    assert eng.n_graphs == 2


def _wl(name):
    return next(w for w in programs.WORKLOADS if w.name == name)


def _retry(fleet, op):
    from repro_torch.core.hext.sim import MigrationError
    for _ in range(12):
        try:
            return op()
        except MigrationError:
            fleet.run(300, chunk=300)
    pytest.fail("the guest never became movable")


def test_migrate_guest_on_card_hits_goldens(cuda):
    sha, crc, ss, fft = (_wl(n) for n in ("sha", "crc32", "stringsearch",
                                          "fft"))
    fleet = Fleet.boot([(sha, crc), (ss, fft)], guests_per_hart=2,
                       timeslice=300, device=cuda)
    assert fleet.engine.name == "graph"
    fleet.run(1000, chunk=500)
    _retry(fleet, lambda: fleet.migrate_guest(0, 1, guest=1))
    assert fleet.harts.device.type == "cuda"
    fleet.run(30000, chunk=1024)
    rep = fleet.report()
    assert rep["sha+moved/2guest-preempt"]["ok_guests"] == [True, None]
    dst = rep["stringsearch+crc32/2guest-preempt"]
    assert dst["ok"] and dst["ok_guests"] == [True, True]


def test_replace_hart_on_card_captures_no_new_graph(cuda):
    from repro_torch.core.hext.sim import HartSpec, HartState
    sha, fft = _wl("sha"), _wl("fft")
    fleet = Fleet.boot([sha, sha], guest=True, device=cuda)
    fleet.run(512, chunk=512)
    eng, graphs = fleet.engine, fleet.engine.n_graphs
    assert graphs == 1
    # a state booted on the CPU is moved onto the fleet's card
    fleet.replace_hart(1, HartState.boot(fft, device="cpu"),
                       HartSpec(fft, False, "fft"))
    assert fleet.harts.device.type == "cuda"
    fleet.run(30000, chunk=1024)
    assert fleet.engine is eng and eng.n_graphs == graphs
    rep = fleet.report()
    assert rep["sha/guest"]["ok"] and rep["fft/native"]["ok"]


def _svc(cuda, tmp_path, **kw):
    from repro_torch.core.hext.service import FleetService
    kw.setdefault("n_harts", 2)
    kw.setdefault("guests_per_hart", 2)
    return FleetService(timeslice=300, slice_ticks=2048, chunk=512,
                        snapshot_dir=str(tmp_path / "snaps"), device=cuda,
                        **kw)


def test_service_evict_park_resume_roundtrip_on_card(cuda, tmp_path):
    """The reference's long-workload case: queue pressure parks the
    youngest guest; it resumes into a reserved slot at its golden."""
    from repro_torch.core.hext.policies import BinPackPolicy
    svc = _svc(cuda, tmp_path, policy=BinPackPolicy(partial_after=1))
    for t, name in enumerate(["qsort", "bitcount", "dijkstra", "susan"]):
        svc.submit(_wl(name), tenant=t)
    svc.step()
    late = svc.submit(_wl("sha"), tenant=4)
    assert svc.drain(400)
    assert svc.stats["parks"] >= 1 and svc.stats["resumes"] >= 1
    assert svc.stats["completed"] == 5 and svc.stats["failed"] == 0
    parked = [j for j in svc.jobs() if any("parked" in e for e in j.events)]
    assert parked and all(j.ok for j in parked)
    assert any("resumed" in e for j in parked for e in j.events)
    assert svc.job(late).ok
    assert svc._pod.engine.n_graphs == 1


def test_service_shed_migration_preserves_goldens_on_card(cuda, tmp_path):
    """The reference's N=3 case: a hot lane sheds a guest to the cool
    lane by live migration; every checksum still matches."""
    from repro_torch.core.hext.policies import BinPackPolicy
    svc = _svc(cuda, tmp_path, guests_per_hart=3,
               policy=BinPackPolicy(partial_after=1, shed_margin=2))
    for t, name in enumerate(["susan", "dijkstra", "bitcount"]):
        svc.submit(_wl(name), tenant=t)
    svc.step()
    svc.submit(_wl("qsort"), tenant=3)
    assert svc.drain(400)
    assert svc.stats["migrations"] >= 1
    assert svc.stats["completed"] == 4 and svc.stats["failed"] == 0
    moved = [j for j in svc.jobs() if any("migrated" in e for e in j.events)]
    assert moved and all(j.ok for j in moved)
    assert svc._pod.engine.n_graphs == 1
