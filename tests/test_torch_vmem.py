"""The port's two-stage paged KV cache (``repro_torch.core.vmem``) against
the JAX package's ``repro.core.vmem``, on the CPU.

Each scenario runs once through each package; after every operation the
whole state (every table, every pool array, the K/V pools bit for bit)
and every returned value must be exactly equal.  Inputs come from seeded
numpy generators and are handed to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.vmem import allocator as JAL
from repro.core.vmem import kvcache as JKC
from repro.core.vmem import page_table as JPT
from repro_torch.core.vmem import allocator as AL
from repro_torch.core.vmem import kvcache as KC
from repro_torch.core.vmem import page_table as PT
from repro_torch.kernels.pagewalk import kernel as PWK


class Side:
    """What differs between the two packages when a scenario drives them."""

    def __init__(self, port: bool):
        self.port = port
        self.PT, self.AL, self.KC = (PT, AL, KC) if port else (JPT, JAL, JKC)
        self.kw = {"device": "cpu"} if port else {}
        self.f32 = torch.float32 if port else jnp.float32

    def arr(self, x):
        return torch.as_tensor(np.asarray(x)) if self.port else \
            jnp.asarray(x)


def snap(x):
    """A comparable numpy form of a state or result of either package;
    bf16 arrays become their uint16 bit patterns."""
    if hasattr(x, "_fields"):
        return {f: snap(getattr(x, f)) for f in x._fields}
    if isinstance(x, dict):
        return {k: snap(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return {str(i): snap(v) for i, v in enumerate(x)}
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16).copy()
        return x.numpy().copy()
    if isinstance(x, (bool, int, float)):
        return np.asarray(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    else:
        assert a.shape == b.shape, f"{where}: {a.shape} vs {b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=where)


def replay(scenario, *args):
    """Run ``scenario(side, *args)`` (a generator of (label, value)) on both
    packages and compare every yielded value exactly.  Values are copied
    when yielded: the port writes its K/V pools in place."""
    want = [(label, snap(v)) for label, v in scenario(Side(False), *args)]
    got = [(label, snap(v)) for label, v in scenario(Side(True), *args)]
    assert [w[0] for w in want] == [g[0] for g in got]
    for (label, w), (_, g) in zip(want, got):
        assert_same(w, g, label)
    return len(want)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_vmem.py
# ---------------------------------------------------------------------------

def sc_two_stage_composition(s):
    t = s.PT.TwoStageTable.create(2, 2, 8, 16, **s.kw)
    t = s.PT.map_stage1(t, 0, 0, 3, 5)
    yield "map_stage1", t
    t = s.PT.map_stage2(t, 0, 5, 42)
    yield "map_stage2", t
    yield "translate", s.PT.translate(t, 0, 0, 3)


def sc_stage1_fault_then_stage2_fault(s):
    t = s.PT.TwoStageTable.create(1, 1, 4, 4, **s.kw)
    yield "translate0", s.PT.translate(t, 0, 0, 2)
    t = s.PT.map_stage1(t, 0, 0, 2, 1)
    yield "map_stage1", t
    yield "translate1", s.PT.translate(t, 0, 0, 2)


def sc_write_permission(s):
    t = s.PT.TwoStageTable.create(1, 1, 4, 4, **s.kw)
    t = s.PT.map_stage1(t, 0, 0, 0, 0, perm=s.PT.PERM_R)
    t = s.PT.map_stage2(t, 0, 0, 7)
    yield "tables", t
    yield "read", s.PT.translate(t, 0, 0, 0)
    yield "write", s.PT.translate(t, 0, 0, 0, acc_write=True)


def sc_hfence(s):
    t = s.PT.TwoStageTable.create(1, 1, 4, 4, **s.kw)
    t = s.PT.map_stage1(t, 0, 0, 0, 1)
    t = s.PT.map_stage2(t, 0, 1, 9)
    t = s.PT.fill_fused(t, 0, 0, 0)
    yield "fill_fused", t
    yield "hit", s.PT.translate(t, 0, 0, 0)
    t = s.PT.map_stage2(t, 0, 1, 4)
    yield "stale", s.PT.translate(t, 0, 0, 0)
    t = s.PT.hfence(t, 0)
    yield "hfence", t
    yield "fresh", s.PT.translate(t, 0, 0, 0)
    t = s.PT.fill_fused(t, 0, 0, 0)
    t = s.PT.unmap_stage2(t, 0, 1)
    t = s.PT.hfence(t)
    yield "unmap + hfence all", t
    yield "after unmap", s.PT.translate(t, 0, 0, 0)


def sc_isolation(s):
    t = s.PT.TwoStageTable.create(2, 1, 4, 4, **s.kw)
    for tenant, slot in ((0, 10), (1, 20)):
        t = s.PT.map_stage1(t, tenant, 0, 0, 0)
        t = s.PT.map_stage2(t, tenant, 0, slot)
        yield f"tenant {tenant}", t
    yield "t0", s.PT.translate(t, 0, 0, 0)
    yield "t1", s.PT.translate(t, 1, 0, 0)


def sc_quota(s):
    pool = s.AL.PagePool.create(8, [2, 8], **s.kw)
    for tenant in (0, 0, 0, 1):
        pool, slot = s.AL.alloc(pool, tenant)
        yield f"alloc {tenant}", (pool, slot)


def sc_write_read_roundtrip(s):
    kv = s.KC.PagedKVCache.create(
        n_slots=8, page_size=4, n_kv_heads=2, head_dim=8, n_tenants=2,
        reqs_per_tenant=2, logical_pages=4, tenant_pages=8, **s.kw)
    kv, ok = s.KC.ensure_mapped(kv, 0, 0, 0)
    yield "ensure_mapped", (kv, ok)
    k = s.arr(np.full((2, 8), 3.0, np.float32))
    v = s.arr(np.full((2, 8), 5.0, np.float32))
    kv, fault = s.KC.write_token(kv, 0, 0, 2, k, v)
    yield "write_token", (kv, fault)
    yield "gather_kv", s.KC.gather_kv(kv, 0, 0, 1)


def sc_evict_tenant(s):
    kv = s.KC.PagedKVCache.create(
        n_slots=8, page_size=4, n_kv_heads=2, head_dim=8, n_tenants=2,
        reqs_per_tenant=1, logical_pages=4, tenant_pages=8, **s.kw)
    for p in range(3):
        kv, ok = s.KC.ensure_mapped(kv, 0, 0, p)
        yield f"ensure_mapped {p}", (kv, ok)
    kv = s.KC.evict_tenant(kv, 0)
    yield "evict", kv
    yield "translate", s.PT.translate(kv.tables, 0, 0, 0, use_fused=False)
    yield "invariants", s.AL.check_invariants(kv.pool)


def sc_decode_dense(s):
    rng = np.random.RandomState(0)
    kv = s.KC.PagedKVCache.create(
        n_slots=16, page_size=4, n_kv_heads=2, head_dim=8, n_tenants=1,
        reqs_per_tenant=1, logical_pages=8, tenant_pages=16, dtype=s.f32,
        **s.kw)
    ks = rng.randn(10, 2, 8).astype(np.float32)
    vs = rng.randn(10, 2, 8).astype(np.float32)
    for t in range(10):
        kv, ok = s.KC.ensure_mapped(kv, 0, 0, t // 4)
        kv, fault = s.KC.write_token(kv, 0, 0, t, s.arr(ks[t]), s.arr(vs[t]))
        yield f"token {t}", (kv, ok, fault)


SCENARIOS = [sc_two_stage_composition, sc_stage1_fault_then_stage2_fault,
             sc_write_permission, sc_hfence, sc_isolation, sc_quota,
             sc_write_read_roundtrip, sc_evict_tenant, sc_decode_dense]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_state_equal_after_each_op(scenario):
    assert replay(scenario) >= 2


def test_wrapped_tenant_reads_last_tenant():
    """translate reads tenant -1 as the last tenant (a JAX gather)."""
    t = PT.TwoStageTable.create(2, 1, 4, 4, device="cpu")
    t = PT.map_stage1(t, 1, 0, 0, 0)
    t = PT.map_stage2(t, 1, 0, 20)
    assert int(PT.translate(t, -1, 0, 0).slot) == 20


# ---------------------------------------------------------------------------
# the allocator under seeded random sequences, out-of-range slots included
# ---------------------------------------------------------------------------

def sc_allocator_sequence(s, seed, n_slots, quotas, n_ops):
    rng = np.random.default_rng(seed)
    pool = s.AL.PagePool.create(n_slots, quotas, **s.kw)
    T = len(quotas)
    for i in range(n_ops):
        op = rng.integers(0, 8)
        if op <= 3:
            tenant = int(rng.integers(-1, T + 1))
            pool, slot = s.AL.alloc(pool, tenant)
            yield f"{i} alloc {tenant}", (pool, slot)
            continue
        if op <= 6:
            slot = int(rng.choice([rng.integers(0, n_slots), -1,
                                   n_slots + 3, n_slots - 1]))
            pool = s.AL.free(pool, slot)
            yield f"{i} free {slot}", pool
        else:
            tenant = int(rng.integers(-1, T + 1))
            pool = s.AL.free_tenant(pool, tenant)
            yield f"{i} free_tenant {tenant}", pool
        yield f"{i} invariants", s.AL.check_invariants(pool)


@pytest.mark.parametrize("seed", range(6))
def test_allocator_random_sequence(seed):
    assert replay(sc_allocator_sequence, seed, 6, [3, 4, 6], 40) > 40


def sc_allocator_corners(s):
    """free of a free slot on a full pool (the push index is n_slots),
    free(-1), free(n_slots + 3) while the last slot is owned (the reference
    pushes the bogus id), and teardown after that."""
    pool = s.AL.PagePool.create(4, [4, 4], **s.kw)
    pool = s.AL.free(pool, 2)
    yield "free a free slot on a full pool", pool
    for tenant in (0, 1, 0, 1):
        pool, slot = s.AL.alloc(pool, tenant)
        yield f"alloc {tenant}", (pool, slot)
    pool, slot = s.AL.alloc(pool, 0)
    yield "alloc on an empty pool", (pool, slot)
    for slot in (-1, 7, 7, 7, 7, 7):
        pool = s.AL.free(pool, slot)
        yield f"free {slot}", pool
    pool = s.AL.free_tenant(pool, 0)
    yield "free_tenant 0", pool
    pool, slot = s.AL.alloc(pool, 1)
    yield "alloc after", (pool, slot)
    yield "invariants", s.AL.check_invariants(pool)


def test_allocator_corners():
    assert replay(sc_allocator_corners) > 10


# ---------------------------------------------------------------------------
# the control plane and the data plane, mixed
# ---------------------------------------------------------------------------

def sc_kv_sequence(s, seed):
    rng = np.random.default_rng(seed)
    T, R, P, page, KVH, hd = 3, 2, 4, 4, 2, 8
    kv = s.KC.PagedKVCache.create(
        n_slots=10, page_size=page, n_kv_heads=KVH, head_dim=hd, n_tenants=T,
        reqs_per_tenant=R, logical_pages=P, tenant_pages=6,
        quotas=[4, 6, 2], **s.kw)
    for i in range(30):
        op = rng.integers(0, 6)
        t, r = int(rng.integers(0, T)), int(rng.integers(0, R))
        if op <= 2:
            p = int(rng.integers(0, P))
            kv, ok = s.KC.ensure_mapped(kv, t, r, p)
            yield f"{i} ensure_mapped {t} {r} {p}", (kv, ok)
        elif op <= 4:
            pos = int(rng.integers(0, P * page))
            k = rng.standard_normal((KVH, hd)).astype(np.float32)
            v = rng.standard_normal((KVH, hd)).astype(np.float32)
            kv, fault = s.KC.write_token(kv, t, r, pos, s.arr(k), s.arr(v))
            yield f"{i} write_token {t} {r} {pos}", (kv, fault)
        else:
            kv = s.KC.evict_tenant(kv, t)
            yield f"{i} evict_tenant {t}", kv
    yield "gather", s.KC.gather_kv(kv, 1, 0, P)


@pytest.mark.parametrize("seed", range(4))
def test_kv_control_and_data_plane_sequence(seed):
    assert replay(sc_kv_sequence, seed) == 31


# ---------------------------------------------------------------------------
# translate: negative and out-of-range coordinates, batch shapes
# ---------------------------------------------------------------------------

def _random_tables(rng, T=3, R=4, P=5, G=6):
    return {"vs_table": rng.integers(-1, G + 2, (T, R, P), dtype=np.int32),
            "vs_perm": rng.integers(0, 4, (T, R, P), dtype=np.int32),
            "g_table": rng.integers(-1, 40, (T, G), dtype=np.int32),
            "fused": rng.integers(-1, 40, (T, R, P), dtype=np.int32),
            "fused_ok": rng.random((T, R, P)) < 0.3}


SHAPES = [((), (), (), ()), ((7,), (7,), (7,), (7,)),
          ((2, 3), (2, 3), (2, 3), ()), ((4, 1), (1,), (5,), (4, 5)),
          ((), (), (9,), (9,))]


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("shapes", SHAPES, ids=str)
def test_translate_out_of_range_and_batched(shapes, use_fused):
    rng = np.random.default_rng(len(shapes[0]) * 10 + len(shapes[2]))
    tabs = _random_tables(rng)
    dims = (3, 4, 5)
    coords = [rng.integers(-2 * n, 2 * n, sh).astype(np.int32)
              for sh, n in zip(shapes[:3], dims)]
    acc = rng.random(shapes[3]) < 0.5
    want = JPT.translate(JPT.TwoStageTable(**{k: jnp.asarray(v)
                                               for k, v in tabs.items()}),
                         *[jnp.asarray(c) for c in coords],
                         acc_write=jnp.asarray(acc), use_fused=use_fused)
    port_t = PT.TwoStageTable.from_numpy(tabs, device="cpu")
    got = PT.translate(port_t, *coords, acc_write=acc, use_fused=use_fused)
    assert_same(snap(want), snap(got))


def test_translate_scalar_acc_write_python_bool():
    rng = np.random.default_rng(11)
    tabs = _random_tables(rng)
    jt = JPT.TwoStageTable(**{k: jnp.asarray(v) for k, v in tabs.items()})
    pt = PT.TwoStageTable.from_numpy(tabs, device="cpu")
    pages = np.arange(-5, 10, dtype=np.int32)
    for acc in (False, True):
        assert_same(snap(JPT.translate(jt, 1, -1, pages, acc_write=acc)),
                    snap(PT.translate(pt, 1, -1, pages, acc_write=acc)))
    assert_same(snap(JPT.translate_block(jt, -1, 2, 5)),
                snap(PT.translate_block(pt, -1, 2, 5)))


# ---------------------------------------------------------------------------
# translate as one walk: the coordinates as the kernel takes them (values,
# ranges, strided tensors over an [outer, inner] grid, a materialised 3-d
# broadcast), against JAX's translate on tables after each kind of edit
# ---------------------------------------------------------------------------

def _walk_coords(rng):
    """(tenant, req, page, acc_write) in the port's forms, by case."""
    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.as_tensor(rng.integers(lo, hi, shape)).to(dtype)
    base = ints(-8, 8, (3, 12))
    return {
        "scalar x page range": (1, -1, range(-3, 9), False),
        "scalar x stepped range": (-1, 2, range(0, 10, 2), True),
        "column x row": (ints(-6, 6, (4, 1)), ints(-8, 8, (4, 1)),
                         ints(-10, 10, (1, 5)),
                         torch.as_tensor(rng.random((4, 5)) < 0.5)),
        "3-d materialised": (ints(-6, 6, (2, 1, 3)), ints(-8, 8, (1, 4, 1)),
                             ints(-10, 10, (2, 4, 3)), False),
        "out of range": (ints(-6, 6, (9,)), ints(-8, 8, (9,)),
                         ints(-10, 10, (9,)),
                         torch.as_tensor(rng.random(9) < 0.5)),
        "strided views": (base[1:, ::2], base[0, 1::2], base[1:, 1:2],
                          torch.as_tensor(rng.random(7) < 0.5)[1:]),
        "int64 0-d": (torch.tensor(-1), 2, torch.tensor(13), True),
        "numpy scalars": (np.int32(2), np.int64(-1),
                          np.arange(-2, 7, dtype=np.int32), np.bool_(True)),
    }


def _to_jax(x):
    if isinstance(x, range):
        return jnp.arange(x.start, x.stop, x.step, dtype=jnp.int32)
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    return x


def _edited_tables(s, state):
    """Seeded random tables, then (cumulatively, up to ``state``) stage-1
    edits, a fused fill and an hfence of one tenant, on one side."""
    t = s.PT.TwoStageTable(**{k: s.arr(v) for k, v in
                              _random_tables(np.random.default_rng(5))
                              .items()})
    steps = ("random", "map_stage1", "fill_fused", "hfence")
    if steps.index(state) >= 1:
        t = s.PT.map_stage1(t, 1, 2, 3, 4)
        t = s.PT.map_stage1(t, 0, -1, 4, 2, perm=1)
    if steps.index(state) >= 2:
        t = s.PT.fill_fused(t, s.arr([0, 1, 2, 2, -1]), s.arr([0, 1, 3, -1, 2]),
                            s.arr([4, 3, 0, 1, -1]))
    if steps.index(state) >= 3:
        t = s.PT.hfence(t, 1)
    return t


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("state", ["random", "map_stage1", "fill_fused",
                                   "hfence"])
@pytest.mark.parametrize("case", list(_walk_coords(np.random.default_rng(0))))
def test_translate_one_walk_matches_jax(case, state, use_fused):
    coords = _walk_coords(np.random.default_rng(21))[case]
    jt, pt = _edited_tables(Side(False), state), _edited_tables(Side(True),
                                                                state)
    assert_same(snap(jt), snap(pt), "tables")
    want = JPT.translate(jt, *map(_to_jax, coords[:3]),
                         acc_write=_to_jax(coords[3]), use_fused=use_fused)
    got = PT.translate(pt, *coords[:3], acc_write=coords[3],
                       use_fused=use_fused)
    assert_same(snap(want), snap(got))


def test_table_edits_with_out_of_range_coordinates():
    """map/unmap/fill/hfence scatter with JAX's rule: a negative coordinate
    wraps once, one still out of range drops the write."""
    def sc(s):
        rng = np.random.default_rng(5)
        tabs = _random_tables(rng)
        t = s.PT.TwoStageTable(**{k: jnp.asarray(v) for k, v in
                                  tabs.items()}) if not s.port else \
            PT.TwoStageTable.from_numpy(tabs, device="cpu")
        for c in ((-1, 0, 2), (1, -4, -5), (3, 0, 0), (0, 4, 1), (-4, 1, 1)):
            t = s.PT.map_stage1(t, *c, 3)
            yield f"map_stage1 {c}", t
            t = s.PT.fill_fused(t, *c)
            yield f"fill_fused {c}", t
        for c in ((-1, 2), (2, 6), (0, -6), (-3, -1)):
            t = s.PT.map_stage2(t, *c, 33)
            yield f"map_stage2 {c}", t
            t = s.PT.unmap_stage2(t, c[1], c[0])
            yield f"unmap_stage2 {c}", t
        for tenant in (-1, 3, -4, 0):
            t = s.PT.hfence(t, tenant)
            yield f"hfence {tenant}", t
    assert replay(sc) == 22


# ---------------------------------------------------------------------------
# paged_decode_attention against the reference's oracle (fp32)
# ---------------------------------------------------------------------------

def _decode_case(s, hole, length):
    """10 tokens in 3 pages; ``hole`` unmaps page 1's stage 2."""
    rng = np.random.RandomState(0)
    kv = s.KC.PagedKVCache.create(
        n_slots=16, page_size=4, n_kv_heads=2, head_dim=8, n_tenants=1,
        reqs_per_tenant=1, logical_pages=8, tenant_pages=16, dtype=s.f32,
        **s.kw)
    for t in range(10):
        kv, _ = s.KC.ensure_mapped(kv, 0, 0, t // 4)
        kv, _ = s.KC.write_token(kv, 0, 0, t,
                                 s.arr(rng.randn(2, 8).astype(np.float32)),
                                 s.arr(rng.randn(2, 8).astype(np.float32)))
    if hole:
        tp = int(np.asarray(kv.tables.vs_table[0, 0, 1]))
        tables = s.PT.hfence(s.PT.unmap_stage2(kv.tables, 0, tp), 0)
        kv = kv._replace(tables=tables)
    q = s.arr(rng.randn(4, 8).astype(np.float32))          # H=4, G=2
    return kv, q


@pytest.mark.parametrize("hole,length", [(False, 10), (True, 10),
                                         (False, 0), (True, 3), (True, 30)])
def test_paged_decode_attention_matches_jax(hole, length):
    jkv, jq = _decode_case(Side(False), hole, length)
    pkv, pq = _decode_case(Side(True), hole, length)
    assert_same(snap(jkv), snap(pkv), "cache")
    want = np.asarray(JKC.paged_decode_attention(jkv, 0, 0, jq, length,
                                                 scale=0.35))
    before = PWK.two_stage_translate_kernel.launches
    got = KC.paged_decode_attention(pkv, 0, 0, pq, length, scale=0.35)
    assert got.dtype == torch.float32 and got.shape == (4, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert PWK.two_stage_translate_kernel.launches == before


# ---------------------------------------------------------------------------
# carrying state across
# ---------------------------------------------------------------------------

def test_numpy_round_trip_is_bit_exact_for_bf16():
    rng = np.random.default_rng(9)
    jkv = JKC.PagedKVCache.create(
        n_slots=6, page_size=4, n_kv_heads=2, head_dim=8, n_tenants=2,
        reqs_per_tenant=2, logical_pages=3, tenant_pages=4)
    for t, r, p in ((0, 0, 0), (1, 1, 2), (0, 1, 1)):
        jkv, ok = JKC.ensure_mapped(jkv, t, r, p)
        assert ok
        jkv, fault = JKC.write_token(
            jkv, t, r, p * 4 + 1,
            jnp.asarray(rng.standard_normal((2, 8)) * 1e3, jnp.float32),
            jnp.asarray(rng.standard_normal((2, 8)), jnp.float32))
        assert not bool(fault)
    # every bf16 bit pattern (NaNs and infinities included) in the pools
    bits = np.arange(6 * 4 * 2 * 8, dtype=np.uint16) * 171 + 7
    jkv = jkv._replace(v_pool=jnp.asarray(
        bits.reshape(6, 4, 2, 8).view(jnp.bfloat16)))
    pkv = KC.PagedKVCache.from_numpy(jkv, device="cpu")
    assert pkv.k_pool.dtype == torch.bfloat16
    assert_same(snap(jkv), snap(pkv), "from_numpy")
    out = pkv.to_numpy()
    assert out["pool_dtype"] == "bfloat16"
    np.testing.assert_array_equal(out["v_pool"], bits.reshape(6, 4, 2, 8))
    np.testing.assert_array_equal(
        out["k_pool"], np.asarray(jkv.k_pool).view(np.uint16))
    back = KC.PagedKVCache.from_numpy(out, device="cpu")
    assert_same(snap(pkv), snap(back), "round trip")
    assert_same(snap(JPT.TwoStageTable(**{
        k: jnp.asarray(v) for k, v in pkv.tables.to_numpy().items()})),
        snap(jkv.tables), "tables back to JAX")


def test_pools_are_written_in_place():
    kv = KC.PagedKVCache.create(
        n_slots=4, page_size=2, n_kv_heads=1, head_dim=4, n_tenants=1,
        reqs_per_tenant=1, logical_pages=2, tenant_pages=4, device="cpu")
    kv2, ok = KC.ensure_mapped(kv, 0, 0, 0)
    kv3, fault = KC.write_token(kv2, 0, 0, 1, torch.ones(1, 4),
                                torch.ones(1, 4))
    assert ok and not bool(fault)
    assert kv3.k_pool.data_ptr() == kv.k_pool.data_ptr()
    assert float(kv.k_pool.float().sum()) == 4.0
    # tables and pool are new objects; the older ones are untouched
    assert int(kv.pool.top) == 4 and int(kv2.pool.top) == 3
