"""Card-only tests of the port (marker ``cuda``; they skip without a GPU).

The CPU path of every function is held against the JAX package by the
other ``test_torch_*`` files; these hold the card against the CPU on the
same seeded inputs (integer semantics of shifts, wrap-around and division
on CUDA), and the CUDA ``pagewalk`` and ``paged_attention`` kernels against
their plain versions.
This file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.hext import csr as C
from repro_torch.core.hext import decode as D
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
from repro_torch.kernels.pagewalk.ref import two_stage_translate_ref
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
# at a ragged S, windows 1 and >= S, and Danube's head layout (G = 4)
FLASH_SHAPES = [(1, 64, 2, 1, 16, 0), (2, 128, 4, 2, 32, 0),
                (1, 128, 4, 4, 32, 32), (2, 256, 8, 2, 64, 0),
                (1, 100, 8, 2, 120, 32), (2, 77, 4, 2, 120, 1),
                (1, 70, 4, 1, 120, 500), (1, 300, 32, 8, 120, 128),
                (1, 65, 2, 1, 256, 0)]


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
