"""Unit parity of the port's hext core against the JAX package.

Every case makes its inputs with a seeded numpy generator, runs the JAX
function (vmapped over the batch, under a test-local
``jax.enable_x64(True)``) and the port's batched counterpart on the CPU,
and requires exact equality of every output field: the simulator is
integer, so there is no tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hext import bits as jbits
from repro.core.hext import csr as jC
from repro.core.hext import decode as jD
from repro.core.hext import isa as jI
from repro.core.hext import tlb as jT
from repro.core.hext import translate as jX
from repro.core.hext import trap as jTR
from repro_torch.core.hext import bits
from repro_torch.core.hext import csr as C
from repro_torch.core.hext import decode as D
from repro_torch.core.hext import isa as I
from repro_torch.core.hext import tlb as T
from repro_torch.core.hext import translate as X
from repro_torch.core.hext import trap as TR

MASK64 = (1 << 64) - 1
CORNERS = [0, 1, 2, 3, 5, 7, 0x7F, 0x80, 0xFFFF, 0x7FFFFFFF, 0x80000000,
           0xFFFFFFFF, 1 << 32, (1 << 32) + 1, (1 << 63) - 1, 1 << 63,
           (1 << 63) + 1, MASK64, MASK64 - 1, MASK64 - 6]
MMIO = [I.MMIO_CONSOLE, I.MMIO_DONE, I.MMIO_CTXSW, I.MMIO_MTIMECMP,
        I.MMIO_MTIME]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def u64(rng, n, corners=True):
    """Random uint64s: full-width, small, small-negative and corners."""
    full = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    small = rng.integers(0, 64, n).astype(np.uint64)
    neg = (np.uint64(MASK64) - rng.integers(0, 64, n).astype(np.uint64))
    pick = rng.integers(0, 4 if corners else 3, n)
    out = np.where(pick == 0, full, np.where(pick == 1, small, neg))
    if corners:
        cor = np.array(CORNERS, np.uint64)[rng.integers(0, len(CORNERS), n)]
        out = np.where(pick == 3, cor, out)
    return out.astype(np.uint64)


def tt(x):
    """numpy → the port's carrier: uint64 as int64 bits, ints as int64."""
    a = np.asarray(x)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype != np.bool_:
        a = a.astype(np.int64)
    return torch.as_tensor(np.ascontiguousarray(a))


def as_i64(x):
    a = np.asarray(x)
    if a.dtype == np.uint64:
        return a.view(np.int64)
    return a.astype(np.int64)


def assert_same(port, ref, what=""):
    """Exact equality of a port output (tensor / NamedTuple / dict) with a
    reference output (numpy arrays), field by field."""
    if isinstance(port, dict):
        assert set(port) == set(ref), what
        for k in port:
            assert_same(port[k], ref[k], f"{what}.{k}")
        return
    if isinstance(port, tuple):
        fields = getattr(port, "_fields", range(len(port)))
        for i, name in enumerate(fields):
            assert_same(port[i], ref[i], f"{what}.{name}")
        return
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    p, r = np.broadcast_arrays(as_i64(p), as_i64(r))
    bad = np.nonzero(p != r)
    assert bad[0].size == 0, (
        f"{what}: {bad[0].size} mismatches, first at {bad[0][0]}: "
        f"port={p[bad][0]:#x} ref={r[bad][0]:#x}")


@functools.lru_cache(maxsize=None)
def _jitted(fn, in_axes):
    return jax.jit(jax.vmap(fn, in_axes=in_axes))


def jrun(fn, *args, in_axes=0):
    """Run a per-hart JAX function over the batch; numpy outputs."""
    with jax.enable_x64(True):
        jargs = jax.tree.map(jnp.asarray, args)
        out = _jitted(fn, in_axes)(*jargs)
        return jax.tree.map(np.asarray, out)


def rand_csrs(rng, n):
    """Random CSR banks with the timer comparators mostly disarmed."""
    c = u64(rng, n * jC.N_CSR).reshape(n, jC.N_CSR)
    for r in (jC.R_MTIMECMP, jC.R_STIMECMP, jC.R_VSTIMECMP):
        keep = rng.random(n) < 0.5
        c[keep, r] = np.uint64(MASK64)
    return c


# ---------------------------------------------------------------------------
# bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [8, 12, 13, 16, 21, 32])
def test_sext(nbits):
    rng = np.random.default_rng(nbits)
    x = u64(rng, 2000)
    ref = jrun(lambda v: jbits.sext(v, nbits), x)
    assert_same(bits.sext(tt(x), nbits), ref)


@pytest.mark.parametrize("size", range(4))
def test_word_extract(size):
    rng = np.random.default_rng(10 + size)
    n = 2000
    word, pa = u64(rng, n), u64(rng, n)
    uns = rng.random(n) < 0.5
    sz = np.full(n, size, np.int32)
    ref = jrun(jbits.word_extract, word, pa, sz, uns)
    assert_same(bits.word_extract(tt(word), tt(pa), tt(sz), tt(uns)), ref)


@pytest.mark.parametrize("size", range(4))
def test_word_deposit(size):
    rng = np.random.default_rng(20 + size)
    n = 2000
    word, pa, val = u64(rng, n), u64(rng, n), u64(rng, n)
    sz = np.full(n, size, np.int32)
    ref = jrun(jbits.word_deposit, word, pa, val, sz)
    assert_same(bits.word_deposit(tt(word), tt(pa), tt(val), tt(sz)), ref)


@pytest.mark.parametrize("words", [64, 96])
def test_read64_wraps_like_reference(words):
    rng = np.random.default_rng(words)
    n = 500
    mem = u64(rng, n * words).reshape(n, words)
    pa = u64(rng, n)
    ref = jrun(jbits.read64, mem, pa)
    assert_same(bits.read64(tt(mem), tt(pa)), ref)


def test_unsigned_helpers():
    rng = np.random.default_rng(1)
    a, b = u64(rng, 4000), u64(rng, 4000)
    s = rng.integers(0, 64, 4000)
    ta, tb = tt(a), tt(b)
    np.testing.assert_array_equal(bits.ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(bits.uge(ta, tb).numpy(), a >= b)
    want = (a >> s.astype(np.uint64)).view(np.int64)
    np.testing.assert_array_equal(bits.lsr(ta, tt(s)).numpy(), want)
    for k in (0, 1, 3, 12, 32, 63):
        np.testing.assert_array_equal(bits.lsr(ta, k).numpy(),
                                      (a >> np.uint64(k)).view(np.int64))
    assert bits.s64(MASK64) == -1 and bits.s64(1 << 63) == -(1 << 63)


# ---------------------------------------------------------------------------
# csr
# ---------------------------------------------------------------------------

def test_init_csrs():
    with jax.enable_x64(True):
        ref = np.asarray(jC.init_csrs())
    assert_same(C.init_csrs(3, "cpu"), np.broadcast_to(ref, (3, C.N_CSR)))


PRIV_VIRT = [(p, v) for p in (0, 1, 3) for v in (False, True)]
KNOWN_CSRS = sorted(set(jC.CSR_ADDR) | {0x100, 0x104, 0x144})


def csr_addresses():
    """Every 12-bit address once, and each known CSR 64 more times (each
    row gets its own random bank and operand)."""
    return np.concatenate([np.arange(4096),
                           np.repeat(KNOWN_CSRS, 64)]).astype(np.int32)


@pytest.mark.parametrize("priv,virt", PRIV_VIRT)
def test_csr_read_every_address(priv, virt):
    rng = np.random.default_rng(100 + priv * 2 + virt)
    addr = csr_addresses()
    n = addr.shape[0]
    csrs = rand_csrs(rng, n)
    pv = np.full(n, priv, np.int32)
    vv = np.full(n, virt)
    ref = jrun(jC.csr_read, csrs, addr, pv, vv)
    assert_same(C.csr_read(tt(csrs), tt(addr), tt(pv), tt(vv)), ref,
                "csr_read")


@pytest.mark.parametrize("priv,virt", PRIV_VIRT)
def test_csr_write_every_address(priv, virt):
    rng = np.random.default_rng(200 + priv * 2 + virt)
    addr = csr_addresses()
    n = addr.shape[0]
    csrs = rand_csrs(rng, n)
    val = u64(rng, n)
    pv = np.full(n, priv, np.int32)
    vv = np.full(n, virt)
    ref = jrun(jC.csr_write, csrs, addr, val, pv, vv)
    assert_same(C.csr_write(tt(csrs), tt(addr), tt(val), tt(pv), tt(vv)),
                ref, "csr_write")


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def rand_words(rng, n, opcodes=None):
    w = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    if opcodes is not None:
        op = np.array(opcodes, np.uint64)[rng.integers(0, len(opcodes), n)]
        w = (w & ~np.uint64(0x7F)) | op
    return w


@pytest.mark.parametrize("seed", range(3))
def test_decode(seed):
    rng = np.random.default_rng(300 + seed)
    words = np.concatenate([rand_words(rng, 1000),
                            rand_words(rng, 3000, list(jD._OPC))])
    ref = jrun(jD.decode, words)
    assert_same(D.decode(tt(words)), ref, "decode")


# ---------------------------------------------------------------------------
# translate
# ---------------------------------------------------------------------------

WALK_WORDS = 4096        # 8 pages: ppns 0..7 exist, 8..9 are beyond memory


def rand_page_tables(rng, n):
    """Memory of PTE-like words: half pointers (V only), half random leaf
    flags; ppns mostly inside memory, some beyond it, some misaligned."""
    k = n * WALK_WORDS
    ppn = rng.integers(0, 10, k).astype(np.uint64)
    flags = rng.integers(0, 256, k).astype(np.uint64)
    ptr = rng.random(k) < 0.5
    flags = np.where(ptr, np.uint64(1) | (flags & np.uint64(0xD0)), flags)
    return ((ppn << np.uint64(10)) | flags).reshape(n, WALK_WORDS)


def rand_walk_csrs(rng, n):
    c = rand_csrs(rng, n)
    for r in (jC.R_SATP, jC.R_VSATP, jC.R_HGATP):
        mode = np.where(rng.random(n) < 0.8, 8, 0).astype(np.uint64)
        root = rng.integers(0, 8, n).astype(np.uint64)
        c[:, r] = (mode << np.uint64(60)) | root
    return c


def rand_vas(rng, n):
    va = ((rng.integers(0, 4, n).astype(np.uint64) << np.uint64(30)) |
          (rng.integers(0, 512, n).astype(np.uint64) << np.uint64(21)) |
          (rng.integers(0, 512, n).astype(np.uint64) << np.uint64(12)) |
          rng.integers(0, 4096, n).astype(np.uint64))
    wild = rng.random(n) < 0.1
    return np.where(wild, u64(rng, n), va).astype(np.uint64)


def walk_inputs(rng, n):
    return dict(mem=rand_page_tables(rng, n), csrs=rand_walk_csrs(rng, n),
                priv=rng.choice(np.array([0, 1, 3], np.int32), n),
                virt=rng.random(n) < 0.5, va=rand_vas(rng, n),
                acc=rng.integers(0, 3, n).astype(np.uint64),
                fv=rng.random(n) < 0.3, hx=rng.random(n) < 0.2)


@pytest.mark.parametrize("seed", range(4))
def test_translate(seed):
    rng = np.random.default_rng(400 + seed)
    w = walk_inputs(rng, 512)
    ref = jrun(lambda m, c, p, v, va, a, fv, hx: jX.translate(
        m, c, p, v, va, a, force_virt=fv, hlvx=hx),
        w["mem"], w["csrs"], w["priv"], w["virt"], w["va"], w["acc"],
        w["fv"], w["hx"])
    got = X.translate(tt(w["mem"]), tt(w["csrs"]), tt(w["priv"]),
                      tt(w["virt"]), tt(w["va"]), tt(w["acc"]),
                      force_virt=tt(w["fv"]), hlvx=tt(w["hx"]))
    assert_same(got, ref, "translate")
    # the inputs reach successes and faults of several causes
    assert 0 < int(got.fault.sum()) < 512
    assert len(set(got.cause[got.fault].tolist())) >= 3


@pytest.mark.parametrize("seed", range(2))
def test_g_translate(seed):
    rng = np.random.default_rng(450 + seed)
    w = walk_inputs(rng, 512)
    hgatp = w["csrs"][:, jC.R_HGATP]
    mxr = rng.random(512) < 0.5
    cause_acc = rng.integers(0, 3, 512).astype(np.uint64)
    ref = jrun(lambda m, h, g, a, x, ca: jX.g_translate(
        m, h, g, a, x, cause_acc=ca),
        w["mem"], hgatp, w["va"], w["acc"], mxr, cause_acc)
    got = X.g_translate(tt(w["mem"]), tt(hgatp), tt(w["va"]), tt(w["acc"]),
                        tt(mxr), cause_acc=tt(cause_acc))
    assert_same(got, ref, "g_translate")


def test_eff_ctx():
    rng = np.random.default_rng(460)
    csrs = rand_csrs(rng, 1000)
    virt = rng.random(1000) < 0.5
    assert_same(X.eff_ctx(tt(csrs), tt(virt)),
                jrun(jX.eff_ctx, csrs, virt), "eff_ctx")


# ---------------------------------------------------------------------------
# tlb
# ---------------------------------------------------------------------------

def rand_tlb(rng, n):
    N = jT.N_TLB
    return {
        "vpn": rng.integers(0, 6, (n, N)).astype(np.uint64),
        "ppn": rng.integers(0, 1 << 20, (n, N)).astype(np.uint64),
        "level": rng.integers(0, 3, (n, N)).astype(np.int32),
        "perm": rng.integers(0, 8, (n, N)).astype(np.int32),
        "guest": rng.random((n, N)) < 0.5,
        "priv": rng.choice(np.array([0, 1, 3], np.int32), (n, N)),
        "sum": rng.random((n, N)) < 0.5,
        "mxr": rng.random((n, N)) < 0.5,
        "valid": rng.random((n, N)) < 0.7,
        "ptr": rng.integers(0, 40, n).astype(np.int32),
    }


def tlb_tt(t):
    return {k: tt(v) for k, v in t.items()}


def near_vas(rng, n):
    return ((rng.integers(0, 6, n).astype(np.uint64) << np.uint64(12)) |
            rng.integers(0, 4096, n).astype(np.uint64))


@pytest.mark.parametrize("seed", range(3))
def test_tlb_lookup(seed):
    rng = np.random.default_rng(500 + seed)
    n = 2000
    tlb = rand_tlb(rng, n)
    va = near_vas(rng, n)
    virt = rng.random(n) < 0.5
    acc = rng.integers(0, 3, n).astype(np.uint64)
    priv = rng.choice(np.array([0, 1, 3], np.int32), n)
    sb, mx = rng.random(n) < 0.5, rng.random(n) < 0.5
    ref = jrun(jT.lookup, tlb, va, virt, acc, priv, sb, mx)
    got = T.lookup(tlb_tt(tlb), tt(va), tt(virt), tt(acc), tt(priv), tt(sb),
                   tt(mx))
    assert int(got.hit.sum()) > 0
    assert_same(got, ref, "lookup")


@pytest.mark.parametrize("seed", range(2))
def test_tlb_insert(seed):
    rng = np.random.default_rng(520 + seed)
    n = 1000
    tlb = rand_tlb(rng, n)
    va, pa = u64(rng, n), u64(rng, n)
    level = rng.integers(0, 3, n).astype(np.int32)
    perm = rng.integers(0, 8, n).astype(np.int32)
    virt, sb, mx = (rng.random(n) < 0.5 for _ in range(3))
    priv = rng.choice(np.array([0, 1, 3], np.int32), n)
    ref = jrun(jT.insert, tlb, va, pa, level, perm, virt, priv, sb, mx)
    got = T.insert(tlb_tt(tlb), tt(va), tt(pa), tt(level), tt(perm),
                   tt(virt), tt(priv), tt(sb), tt(mx))
    assert_same(got, ref, "insert")


@pytest.mark.parametrize("seed", range(2))
def test_compose_perms(seed):
    rng = np.random.default_rng(540 + seed)
    n = 4000
    vs_pte = rng.integers(0, 256, n).astype(np.uint64)
    g_pte = rng.integers(0, 256, n).astype(np.uint64)
    priv = rng.choice(np.array([0, 1, 3], np.int32), n)
    sb, mx = rng.random(n) < 0.5, rng.random(n) < 0.5
    ref = jrun(jT.compose_perms, vs_pte, g_pte, priv, sb, mx)
    assert_same(T.compose_perms(tt(vs_pte), tt(g_pte), tt(priv), tt(sb),
                                tt(mx)), ref, "compose_perms")


@pytest.mark.parametrize("guest_only,native_only,scoped", [
    (True, False, False), (False, True, False), (True, False, True),
    (False, True, True)])
def test_tlb_flush(guest_only, native_only, scoped):
    rng = np.random.default_rng(560 + 2 * guest_only + scoped)
    n = 1000
    tlb = rand_tlb(rng, n)
    va = near_vas(rng, n)

    def jflush(t, v):
        return jT.flush(t, guest_only=guest_only, native_only=native_only,
                        va=v if scoped else None)

    ref = jrun(jflush, tlb, va)
    got = T.flush(tlb_tt(tlb), guest_only=guest_only,
                  native_only=native_only, va=tt(va) if scoped else None)
    assert_same(got, ref, "flush")


@pytest.mark.parametrize("seed", range(2))
def test_tlb_flush_where(seed):
    rng = np.random.default_rng(580 + seed)
    n = 1000
    tlb = rand_tlb(rng, n)
    conds = [rng.random(n) < 0.3 for _ in range(4)]
    va = near_vas(rng, n)
    ref = jrun(jT.flush_where, tlb, *conds, va)
    got = T.flush_where(tlb_tt(tlb), *[tt(c) for c in conds], tt(va))
    assert_same(got, ref, "flush_where")


# ---------------------------------------------------------------------------
# trap
# ---------------------------------------------------------------------------

def trap_inputs(rng, n):
    csrs = rand_csrs(rng, n)
    small = rng.random(n) < 0.5      # sparse interrupt bits now and then
    csrs[small, jC.R_MIP] &= np.uint64(0x1FFF)
    is_int = rng.random(n) < 0.4
    cause = np.where(is_int, rng.choice([1, 2, 3, 5, 6, 7, 9, 10, 11, 12], n),
                     rng.integers(0, 24, n)).astype(np.uint64)
    return dict(csrs=csrs, priv=rng.choice(np.array([0, 1, 3], np.int32), n),
                virt=rng.random(n) < 0.5, cause=cause, is_int=is_int,
                pc=u64(rng, n), tval=u64(rng, n), tval2=u64(rng, n),
                gva=rng.random(n) < 0.5, tinst=u64(rng, n))


@pytest.mark.parametrize("seed", range(2))
def test_route(seed):
    rng = np.random.default_rng(600 + seed)
    w = trap_inputs(rng, 2000)
    ref = jrun(jTR.route, w["csrs"], w["priv"], w["virt"], w["cause"],
               w["is_int"])
    got = TR.route(tt(w["csrs"]), tt(w["priv"]), tt(w["virt"]),
                   tt(w["cause"]), tt(w["is_int"]))
    assert_same(got, ref, "route")


@pytest.mark.parametrize("seed", range(3))
def test_take_trap(seed):
    rng = np.random.default_rng(620 + seed)
    w = trap_inputs(rng, 2000)
    keys = ("csrs", "priv", "virt", "pc", "cause", "is_int", "tval",
            "tval2", "gva", "tinst")
    ref = jrun(jTR.take_trap, *[w[k] for k in keys])
    got = TR.take_trap(*[tt(w[k]) for k in keys])
    assert_same(got, ref, "take_trap")
    assert len(set(got[4].tolist())) == 3      # M, HS and VS all reached


@pytest.mark.parametrize("seed", range(3))
def test_pending_interrupt(seed):
    rng = np.random.default_rng(640 + seed)
    w = trap_inputs(rng, 4000)
    ref = jrun(jTR.pending_interrupt, w["csrs"], w["priv"], w["virt"])
    got = TR.pending_interrupt(tt(w["csrs"]), tt(w["priv"]), tt(w["virt"]))
    assert 0 < int(got[0].sum()) < 4000
    assert_same(got, ref, "pending_interrupt")


# ---------------------------------------------------------------------------
# isa
# ---------------------------------------------------------------------------

def operand_pairs(rng, n):
    c = np.array(CORNERS, np.uint64)
    a = np.concatenate([np.repeat(c, len(c)), u64(rng, n)])
    b = np.concatenate([np.tile(c, len(c)), u64(rng, n)])
    return a, b


@pytest.mark.parametrize("name", ["mulhu", "mulh", "mulhsu", "divs", "rems",
                                  "divu", "remu"])
def test_mul_div(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    a, b = operand_pairs(rng, 3000)
    ref = jrun(getattr(jI, name), a, b)
    assert_same(getattr(I, name)(tt(a), tt(b)), ref, name)


def alu_words(rng, n):
    w = rand_words(rng, n, [0x33, 0x13, 0x3B, 0x1B])
    f7 = np.array([0, 1, 0x20, 0x21], np.uint64)[rng.integers(0, 4, n)]
    keep = rng.random(n) < 0.8
    w = np.where(keep, (w & np.uint64(0x01FFFFFF)) | (f7 << np.uint64(25)),
                 w)
    return w.astype(np.uint64)


@pytest.mark.parametrize("seed", range(3))
def test_alu_result(seed):
    rng = np.random.default_rng(700 + seed)
    n = 4000
    words = alu_words(rng, n)
    rv1, rv2 = u64(rng, n), u64(rng, n)
    ref = jrun(lambda w, a, b: jI._alu_result(jD.decode(w), a, b),
               words, rv1, rv2)
    got = I._alu_result(D.decode(tt(words)), tt(rv1), tt(rv2))
    assert_same(got, ref, "alu")


def mem_words(rng, n):
    """Loads, stores and the hlv/hlvx/hsv family."""
    w = rand_words(rng, n, [0x03, 0x23, 0x73])
    hx = (w & np.uint64(0x7F)) == np.uint64(0x73)
    w = np.where(hx, (w & ~np.uint64(0x7000)) | np.uint64(0x4000), w)
    return w.astype(np.uint64)


@pytest.mark.parametrize("seed", range(2))
def test_mem_query(seed):
    rng = np.random.default_rng(720 + seed)
    n = 4000
    words = mem_words(rng, n)
    csrs = rand_csrs(rng, n)
    priv = rng.choice(np.array([0, 1, 3], np.int32), n)
    virt = rng.random(n) < 0.5
    rv1 = u64(rng, n)
    ref = jrun(lambda c, p, v, w, r: jI.mem_query(c, p, v, jD.decode(w), r),
               csrs, priv, virt, words, rv1)
    got = I.mem_query(tt(csrs), tt(priv), tt(virt), D.decode(tt(words)),
                      tt(rv1))
    assert_same(got, ref, "mem_query")


_PRIV_OPS = [0x00000073, 0x00100073, 0x10200073, 0x30200073, 0x10500073]


def sys_words(rng, n):
    """CSR ops on known (and unknown) addresses, xRET/WFI/ECALL/EBREAK and
    the three fences with random rs1/rs2."""
    known = np.array(sorted(set(jC.CSR_ADDR) | {0x100, 0x104, 0x144}),
                     np.uint64)
    addr = np.where(rng.random(n) < 0.85,
                    known[rng.integers(0, len(known), n)],
                    rng.integers(0, 4096, n).astype(np.uint64))
    f3 = np.array([1, 2, 3, 5, 6, 7], np.uint64)[rng.integers(0, 6, n)]
    rs1 = rng.integers(0, 32, n).astype(np.uint64)
    rd = rng.integers(0, 32, n).astype(np.uint64)
    csr_op = ((addr << np.uint64(20)) | (rs1 << np.uint64(15)) |
              (f3 << np.uint64(12)) | (rd << np.uint64(7)) | np.uint64(0x73))
    fence_f7 = np.array([0x09, 0x11, 0x31], np.uint64)[rng.integers(0, 3, n)]
    rs2 = rng.integers(0, 32, n).astype(np.uint64)
    fence = ((fence_f7 << np.uint64(25)) | (rs2 << np.uint64(20)) |
             (rs1 << np.uint64(15)) | np.uint64(0x73))
    priv_op = np.array(_PRIV_OPS, np.uint64)[rng.integers(0, 5, n)]
    kind = rng.integers(0, 4, n)
    return np.where(kind < 2, csr_op,
                    np.where(kind == 2, fence, priv_op)).astype(np.uint64)


def sys_csrs(rng, n):
    c = rand_csrs(rng, n)
    sparse = rng.random(n) < 0.5
    c[sparse, jC.R_MIP] &= np.uint64(0x3)
    return c


@pytest.mark.parametrize("seed", range(3))
def test_exec_sys(seed):
    rng = np.random.default_rng(740 + seed)
    n = 3000
    words = sys_words(rng, n)
    csrs = sys_csrs(rng, n)
    priv = rng.choice(np.array([0, 1, 3], np.int32), n)
    virt = rng.random(n) < 0.5
    pc, rv1 = u64(rng, n), u64(rng, n)
    ref = jrun(lambda c, p, v, pc_, r, w: jI.exec_sys(c, p, v, pc_, r,
                                                      jD.decode(w)),
               csrs, priv, virt, pc, rv1, words)
    got = I.exec_sys(tt(csrs), tt(priv), tt(virt), tt(pc), tt(rv1),
                     D.decode(tt(words)))
    assert_same(got, ref, "exec_sys")


def _jax_execute(mem, csrs, tlb, pc, priv, virt, words, rv1, rv2, walked):
    uop = jD.decode(words)
    q = jI.mem_query(csrs, priv, virt, uop, rv1)
    xr = jX.translate(mem, csrs, priv, virt, q.addr, q.macc,
                      force_virt=q.force_virt, hlvx=q.hlvx)
    sys = jI.exec_sys(csrs, priv, virt, pc, rv1, uop)
    state = {"mem": mem, "csrs": csrs, "tlb": tlb, "pc": pc, "priv": priv,
             "virt": virt}
    return jI.execute_uop(state, uop, rv1, rv2, q, xr, walked, sys)


@pytest.mark.parametrize("seed", range(3))
def test_execute_uop(seed):
    rng = np.random.default_rng(760 + seed)
    n = 512
    w = walk_inputs(rng, n)
    words = np.concatenate([
        rand_words(rng, n // 4),
        alu_words(rng, n // 4), mem_words(rng, n // 4),
        sys_words(rng, n - 3 * (n // 4))])
    rng.shuffle(words)
    rv1 = np.where(rng.random(n) < 0.3,
                   np.array(MMIO, np.uint64)[rng.integers(0, 5, n)],
                   rand_vas(rng, n)).astype(np.uint64)
    rv2 = u64(rng, n)
    tlb = rand_tlb(rng, n)
    walked = rng.random(n) < 0.7
    pc = u64(rng, n)
    args = (w["mem"], w["csrs"], tlb, pc, w["priv"], w["virt"], words, rv1,
            rv2, walked)
    ref = jrun(_jax_execute, *args)

    mem, csrs, ttlb, tpc, priv, virt = (tt(w["mem"]), tt(w["csrs"]),
                                        tlb_tt(tlb), tt(pc), tt(w["priv"]),
                                        tt(w["virt"]))
    uop = D.decode(tt(words))
    q = I.mem_query(csrs, priv, virt, uop, tt(rv1))
    xr = X.translate(mem, csrs, priv, virt, q.addr, q.macc,
                     force_virt=q.force_virt, hlvx=q.hlvx)
    sys = I.exec_sys(csrs, priv, virt, tpc, tt(rv1), uop)
    state = {"mem": mem, "csrs": csrs, "tlb": ttlb, "pc": tpc, "priv": priv,
             "virt": virt}
    got = I.execute_uop(state, uop, tt(rv1), tt(rv2), q, xr, tt(walked), sys)
    assert_same(got, ref, "execute_uop")
