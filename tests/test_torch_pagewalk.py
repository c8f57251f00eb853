"""The port's two-stage table walk against the JAX package's.

On the CPU the entry point runs the plain version (``ref.py``); the CUDA
kernel is held against it on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pagewalk.ops import two_stage_translate as jax_translate
from repro_torch.kernels.pagewalk import kernel as K
from repro_torch.kernels.pagewalk import ops
from repro_torch.kernels.pagewalk.ref import Coord, translate_ref


def _random_tables(rng, T=3, R=4, P=16, G=32, slots=40):
    vs = rng.integers(-1, G, size=(T, R, P)).astype(np.int32)
    perm = rng.integers(0, 4, size=(T, R, P)).astype(np.int32)
    g = rng.integers(-1, slots, size=(T, G)).astype(np.int32)
    return vs, perm, g


def _queries(rng, B, T=3, R=4, P=16):
    return (rng.integers(0, T, B).astype(np.int32),
            rng.integers(0, R, B).astype(np.int32),
            rng.integers(0, P, B).astype(np.int32),
            rng.integers(0, 2, B).astype(bool))


@pytest.mark.parametrize("force", ["ref", "interpret"])
@pytest.mark.parametrize("B", [1, 7, 512, 513])
def test_ref_matches_jax(B, force):
    rng = np.random.default_rng(B)
    tables = _random_tables(rng)
    q = _queries(rng, B)
    want = jax_translate(*tables, *q, force=force)
    got = ops.two_stage_translate(*tables, *q, device="cpu")
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _out_of_range_queries(rng, B, dims):
    """Coordinates in [-2n, 2n) of each dimension n (negative ones wrap
    once in a JAX gather, then everything is clamped), plus the query
    (tenant=-1, req=0, page=-1)."""
    t, r, p = (rng.integers(-2 * n, 2 * n, B).astype(np.int32)
               for n in dims)
    t[0], r[0], p[0] = -1, 0, -1
    return t, r, p, rng.integers(0, 2, B).astype(bool)


@pytest.mark.parametrize("B", [1, 64, 513])
def test_out_of_range_coordinates_match_jax(B):
    rng = np.random.default_rng(100 + B)
    T, R, P, G = 3, 4, 5, 6
    tables = _random_tables(rng, T, R, P, G, slots=9)
    q = _out_of_range_queries(rng, B, (T, R, P))
    # JAX arrays: a numpy table would index by numpy's rules
    want = jax_translate(*map(jnp.asarray, tables + q), force="ref")
    got = ops.two_stage_translate(*tables, *q, device="cpu")
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_negative_query_reads_last_tenant_and_page():
    """(tenant=-1, req=0, page=-1) reads tenant T-1, page P-1."""
    T, R, P, G = 3, 4, 5, 6
    vs = np.full((T, R, P), -1, np.int32)
    perm = np.full((T, R, P), 3, np.int32)
    g = np.full((T, G), 7, np.int32)
    vs[0, 0, 0] = 2                   # what clamping alone would read
    q = [np.array([x], np.int32) for x in (-1, 0, -1)]
    slot, fault, stage = ops.two_stage_translate(vs, perm, g, *q,
                                                 device="cpu")
    assert (int(slot[0]), bool(fault[0]), int(stage[0])) == (-1, True, 1)
    vs[T - 1, 0, P - 1] = 4
    slot, fault, stage = ops.two_stage_translate(vs, perm, g, *q,
                                                 device="cpu")
    assert (int(slot[0]), bool(fault[0]), int(stage[0])) == (7, False, 0)


@pytest.mark.parametrize("seed", range(6))
def test_fault_iff_any_stage_invalid(seed):
    rng = np.random.default_rng(seed)
    vs, perm, g = _random_tables(rng)
    t, r, p, w = _queries(rng, 64)
    slot, fault, stage = ops.two_stage_translate(vs, perm, g, t, r, p, w,
                                                 device="cpu")
    for i in range(64):
        tp = vs[t[i], r[i], p[i]]
        want = 2 if w[i] else 1
        s1_bad = tp < 0 or (perm[t[i], r[i], p[i]] & want) == 0
        s2_bad = (not s1_bad) and g[t[i], tp] < 0
        assert bool(fault[i]) == (s1_bad or s2_bad)
        assert int(stage[i]) == (1 if s1_bad else 2 if s2_bad else 0)
        assert int(slot[i]) == (-1 if fault[i] else g[t[i], tp])


def test_want_write_defaults_to_read():
    rng = np.random.default_rng(3)
    tables = _random_tables(rng)
    t, r, p, _ = _queries(rng, 33)
    a = ops.two_stage_translate(*tables, t, r, p, device="cpu")
    b = ops.two_stage_translate(*tables, t, r, p, np.zeros(33, bool),
                                device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cpu_tensors_never_launch_the_kernel():
    rng = np.random.default_rng(4)
    tables = _random_tables(rng)
    q = _queries(rng, 100)
    before = K.two_stage_translate_kernel.launches
    ops.two_stage_translate(*tables, *q, device="cpu")
    ops.two_stage_translate(*tables, *q, force="ref", device="cpu")
    assert K.two_stage_translate_kernel.launches == before


def test_force_kernel_on_cpu_raises():
    rng = np.random.default_rng(5)
    with pytest.raises(ValueError, match="CUDA"):
        ops.two_stage_translate(*_random_tables(rng), *_queries(rng, 8),
                                force="kernel", device="cpu")


def test_kernel_wrapper_rejects_cpu_tensors():
    rng = np.random.default_rng(6)
    args = [torch.as_tensor(x) for x in _random_tables(rng) +
            _queries(rng, 8)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.two_stage_translate_kernel(*args)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(7)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.two_stage_translate(*_random_tables(rng), *_queries(rng, 8))


# ---------------------------------------------------------------------------
# the launch shape (pure functions of the shapes) and the coordinate plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,grid", [
    (1, 1), (256, 1), (257, 2), (32768, 128), (262144, 528),
    (10_000_000, 528)])
def test_grid_rule(n, grid):
    """One CTA per 256 queries, at most MAX_CTAS_PER_SM an SM (132 SMs):
    beyond that the kernel strides."""
    assert K.grid_size(n, 132) == grid


@pytest.mark.parametrize("B", [1, 7, 513])
def test_flat_vectors_are_a_one_row_grid(B):
    """The TPU kernel's contract (four 1-d vectors) is the walk over the
    grid (1, B) with each vector read at stride 1, as
    ``two_stage_translate_kernel`` passes it: the plain version of those
    arguments equals JAX's walk, out-of-range coordinates included."""
    rng = np.random.default_rng(200 + B)
    tables = _random_tables(rng)
    q = _out_of_range_queries(rng, B, (3, 4, 16))
    want = jax_translate(*map(jnp.asarray, tables + q), force="ref")
    coords = [Coord(torch.as_tensor(x), 0, 0, 1) for x in q]
    got = translate_ref(*[torch.as_tensor(x) for x in tables], *coords, 1, B)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# (shapes of tenant, req, page, acc_write) -> (outer, inner, materialised)
PLANS = [
    (((), (), "range9", ()), (1, 9, False)),
    (((4, 1), (4, 1), (1, 5), ()), (4, 5, False)),
    (((7,), (7,), (7,), (7,)), (1, 7, False)),
    (((2, 1, 3), (1, 4, 1), (2, 4, 3), ()), (1, 24, True)),
    (((3, 1, 5), (3, 1, 5), (1, 1, 5), (3, 1, 1)), (3, 5, False)),
    (((), (), (), ()), (1, 1, False)),
]


def _plan_arg(shape, rng, k):
    if shape == "range9":
        return range(9)
    if shape == ():
        return int(rng.integers(-3, 3)) if k < 3 else True
    if k == 3:
        return torch.as_tensor(rng.random(shape) < 0.5)
    return torch.as_tensor(rng.integers(-9, 9, shape).astype(np.int32))


@pytest.mark.parametrize("shapes,want", PLANS, ids=str)
def test_plan_coords_layout(shapes, want):
    """Broadcasts that collapse to [outer, inner] read the caller's tensors
    through strides; one that does not is materialised; either way the
    plain version of the plan equals the same walk on explicitly broadcast
    1-d vectors."""
    rng = np.random.default_rng(len(str(shapes)))
    args = [_plan_arg(sh, rng, k) for k, sh in enumerate(shapes)]
    plan = ops.plan_coords(*args, device=torch.device("cpu"))
    assert (plan.outer, plan.inner) == want[:2]
    given = [a for a in args if isinstance(a, torch.Tensor)]
    kept = [c.tensor for c in plan.coords if c.tensor is not None]
    assert all(any(k is g for g in given) for k in kept) is not want[2]
    tables = [torch.as_tensor(x) for x in _random_tables(rng, 3, 4, 5, 6)]
    flat = [torch.as_tensor(np.asarray(a) if not isinstance(a, range)
                            else np.arange(9, dtype=np.int32))
            .expand(plan.shape).reshape(-1) for a in args]
    want_out = ops.two_stage_translate(*tables, *[f.to(torch.int32)
                                                  for f in flat[:3]],
                                       flat[3].to(torch.bool), device="cpu")
    got = translate_ref(*tables, *plan.coords, plan.outer, plan.inner)
    for x, y in zip(got, want_out):
        assert torch.equal(x, y)


def test_translate_ref_reads_strides_and_offsets():
    """A Coord reads its tensor at o * s_outer + i * s_inner from the
    tensor's own start (an offset view included); a value coordinate is
    value + o * s_outer + i * s_inner."""
    base = torch.arange(40, dtype=torch.int32)
    c = Coord(base[3:], 0, 10, 2)
    vals = Coord(None, 5, 100, -1)
    from repro_torch.kernels.pagewalk.ref import read_coord
    assert read_coord(c, 2, 3, "cpu").tolist() == [3, 5, 7, 13, 15, 17]
    assert read_coord(vals, 2, 3, "cpu").tolist() == [5, 4, 3, 105, 104,
                                                      103]


def test_translate_kernel_rejects_cpu_tables():
    rng = np.random.default_rng(8)
    tables = [torch.as_tensor(x) for x in _random_tables(rng)]
    coords = [Coord(None, 0, 0, 0)] * 4
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.translate_kernel(*tables, *coords, 1, 1)
