"""The port's paged decode attention against the JAX package's.

On the CPU the entry point runs the plain version (``ref.py``), held here
against the JAX ``paged_attention_ref`` (both contracts: the TPU kernel's,
``unmapped_reads_zero=0``, and the vmem decode path's, ``=1``) and against
the JAX Pallas kernel in interpret mode.  The CUDA kernel is held against
the plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.vmem import kvcache as JKC
from repro.core.vmem import page_table as JPT
from repro.kernels.paged_attention.ops import paged_attention as jax_attention
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# the shapes of tests/test_kernels.py::test_paged_attention_matches_ref
SHAPES = [(2, 4, 1, 16, 8, 4), (3, 8, 2, 32, 16, 6), (1, 16, 8, 64, 8, 3)]


def _inputs(seed, B, H, KV, hd, page, n_pages, holes=True):
    """fp32 inputs; with ``holes``, page tables hold unmapped pages (-1)
    and an out-of-range slot, and one extra row has every page unmapped and
    another a length of 0 (rows with no valid token)."""
    rng = np.random.default_rng(seed)
    slots = n_pages * B + 2
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((slots, page, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((slots, page, KV, hd)).astype(np.float32)
    pm = rng.integers(0, slots, (B, n_pages)).astype(np.int32)
    lengths = rng.integers(1, n_pages * page, B).astype(np.int32)
    if holes:
        # page 0 stays mapped, so every row with a length has a token
        pm[:, 1:][rng.random((B, n_pages - 1)) < 0.25] = -1
        pm[0, -1] = slots + 5
        q = np.concatenate([q, rng.standard_normal((2, H, hd))
                            .astype(np.float32)])
        pm = np.concatenate([pm, np.full((1, n_pages), -1, np.int32),
                             pm[:1]])
        lengths = np.concatenate([lengths, [n_pages * page, 0]]) \
            .astype(np.int32)
    return q, kp, vp, pm, lengths, hd ** -0.5


def _valid_rows(pm, lengths, page):
    tok_mapped = np.repeat(pm >= 0, page, axis=1)
    t = np.arange(tok_mapped.shape[1])
    return (tok_mapped & (t[None] < lengths[:, None])).any(axis=1)


@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ref_matches_jax_ref(shape, holes):
    """unmapped_reads_zero=0: the JAX ref's function, all-masked rows (the
    uniform mean of the gathered V rows) included."""
    x = _inputs(sum(shape), *shape, holes=holes)
    want = np.asarray(jax_ref(*map(jnp.asarray, x[:5]), x[5]))
    got = ops.paged_attention(*x, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ref_matches_jax_kernel_interpret(shape, holes):
    """The Pallas kernel in interpret mode agrees with the port's plain
    version on every row with a valid token (on a row with none, the
    kernel gives zeros and the ref the uniform mean; the CUDA kernel keeps
    the kernel's zeros and is checked for them on the card)."""
    x = _inputs(sum(shape) + 1, *shape, holes=holes)
    want = np.asarray(jax_attention(*map(jnp.asarray, x[:5]), x[5],
                                    force="interpret"))
    got = ops.paged_attention(*x, device="cpu").numpy()
    rows = _valid_rows(x[3], x[4], shape[4])
    assert rows.sum() >= shape[0]
    np.testing.assert_allclose(got[rows], want[rows], atol=3e-5, rtol=3e-5)
    if holes:
        np.testing.assert_array_equal(want[~rows], 0.0)


def _kvcache_with_hole(seed, hole_page, length):
    """A JAX cache of 10 fp32 tokens over 3 pages of 4; ``hole_page``
    (or None) has its stage 2 unmapped after the writes."""
    rng = np.random.default_rng(seed)
    kv = JKC.PagedKVCache.create(
        n_slots=16, page_size=4, n_kv_heads=2, head_dim=8, n_tenants=1,
        reqs_per_tenant=1, logical_pages=4, tenant_pages=16,
        dtype=jnp.float32)
    for t in range(10):
        kv, ok = JKC.ensure_mapped(kv, 0, 0, t // 4)
        assert ok
        kv, _ = JKC.write_token(
            kv, 0, 0, t,
            jnp.asarray(rng.standard_normal((2, 8)), jnp.float32),
            jnp.asarray(rng.standard_normal((2, 8)), jnp.float32))
    if hole_page is not None:
        tp = int(kv.tables.vs_table[0, 0, hole_page])
        kv = kv._replace(tables=JPT.hfence(
            JPT.unmap_stage2(kv.tables, 0, tp), 0))
    q = jnp.asarray(rng.standard_normal((4, 8)), jnp.float32)
    return kv, q


@pytest.mark.parametrize("hole_page,length", [(None, 10), (1, 10), (0, 3),
                                              (2, 16), (None, 0), (1, 0)])
def test_unmapped_reads_zero_matches_kvcache_oracle(hole_page, length):
    """unmapped_reads_zero=1 is JAX ``paged_decode_attention``: a faulted
    page below the length counts with K = V = 0; length 0 averages every
    gathered row."""
    kv, q = _kvcache_with_hole(7, hole_page, length)
    want = np.asarray(JKC.paged_decode_attention(kv, 0, 0, q, length,
                                                 scale=0.35))
    tr = JPT.translate_block(kv.tables, 0, 0, 4)
    pm = np.where(np.asarray(tr.fault), -1, np.asarray(tr.slot))[None]
    args = (np.array(q)[None], np.array(kv.k_pool),
            np.array(kv.v_pool), pm.astype(np.int32),
            np.array([length], np.int32), 0.35)
    got = ops.paged_attention(*args, device="cpu", unmapped_reads_zero=1)
    np.testing.assert_allclose(got[0].numpy(), want, atol=3e-5, rtol=3e-5)
    if hole_page is not None and length > 4 * hole_page:
        # the two contracts differ exactly where a hole lies below length
        masked = jax_ref(*map(jnp.asarray, args[:5]), 0.35)[0]
        assert np.abs(np.asarray(masked) - want).max() > 1e-3


def test_bf16_ref_matches_jax_ref():
    x = _inputs(3, *SHAPES[1])
    want = np.asarray(jax_ref(*[jnp.asarray(a, jnp.bfloat16)
                                for a in x[:3]],
                              *map(jnp.asarray, x[3:5]), x[5])
                      .astype(jnp.float32))
    bf = [torch.as_tensor(a).to(torch.bfloat16) for a in x[:3]]
    got = ops.paged_attention(*bf, *x[3:], device="cpu")
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the output apart
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


def test_cpu_tensors_never_launch_the_kernel():
    x = _inputs(4, *SHAPES[0])
    before = K.paged_attention_kernel.launches
    ops.paged_attention(*x, device="cpu")
    ops.paged_attention(*x, force="ref", device="cpu")
    assert K.paged_attention_kernel.launches == before


def test_force_kernel_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention(*_inputs(5, *SHAPES[0]), force="kernel",
                            device="cpu")


def test_unknown_force_raises():
    with pytest.raises(ValueError, match="force"):
        ops.paged_attention(*_inputs(5, *SHAPES[0]), force="interpret",
                            device="cpu")


def test_kernel_wrapper_rejects_cpu_tensors():
    x = _inputs(6, *SHAPES[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.paged_attention_kernel(*map(torch.as_tensor, x[:5]), x[5])


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.paged_attention(*_inputs(7, *SHAPES[0]))


def test_plain_version_keeps_q_dtype_and_shape():
    q, kp, vp, pm, ln, sc = _inputs(8, *SHAPES[2])
    out = paged_attention_ref(torch.as_tensor(q), torch.as_tensor(kp),
                              torch.as_tensor(vp), torch.as_tensor(pm),
                              torch.as_tensor(ln), sc)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()


def _split_then_combine(q, kp, vp, pm, lengths, scale, n_splits,
                        unmapped_reads_zero):
    """A plain model of the CUDA kernel's two launches: each request's
    pages cut into ``n_splits`` runs of ceil(n_pages / n_splits), a partial
    (m, l, acc) per run over its valid tokens (an empty run: -1e30, 0, 0),
    then out = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i,
    1e-20)."""
    q, kp, vp = (torch.as_tensor(x, dtype=torch.float64) for x in (q, kp, vp))
    B, H, hd = q.shape
    n_slots, page, KV = kp.shape[:3]
    G = H // KV
    n_pages = pm.shape[1]
    pps = -(-n_pages // n_splits)
    total = n_pages * page
    out = torch.zeros((B, H, hd), dtype=torch.float64)
    for b in range(B):
        length = int(lengths[b])
        uniform = bool(unmapped_reads_zero) and length <= 0
        tok_end = total if uniform else min(max(length, 0), total)
        steps = -(-tok_end // page)
        qs = (q[b] * scale).reshape(KV, G, hd)
        parts = []
        for s in range(n_splits):
            p0, p1 = s * pps, min(s * pps + pps, steps)
            if p0 >= p1:
                parts.append((torch.full((KV, G), -1e30),
                              torch.zeros((KV, G)),
                              torch.zeros((KV, G, hd))))
                continue
            t = torch.arange(p0 * page, min(p1 * page, tok_end))
            entry = torch.as_tensor(pm[b])[t // page].long()
            mapped = entry >= 0
            slot = entry.clamp(0, n_slots - 1)
            k = torch.where(mapped[:, None, None], kp[slot, t % page], 0.0)
            v = torch.where(mapped[:, None, None], vp[slot, t % page], 0.0)
            valid = mapped | bool(unmapped_reads_zero)
            sc = torch.einsum("kgd,tkd->kgt", qs, k)
            if uniform:
                sc = torch.zeros_like(sc)
            sc = torch.where(valid, sc, -1e30)
            m = sc.max(dim=-1).values.clamp(min=-1e30)
            p = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkd->kgd", p, v)))
        ms = torch.stack([x[0] for x in parts])
        big = ms.max(dim=0).values
        w = torch.exp(ms - big)
        den = (w * torch.stack([x[1] for x in parts])).sum(0).clamp(
            min=1e-20)
        acc = (w[..., None] * torch.stack([x[2] for x in parts])).sum(0)
        out[b] = (acc / den[..., None]).reshape(H, hd)
    return out.float()


@pytest.mark.parametrize("unmapped_reads_zero", [0, 1])
@pytest.mark.parametrize("n_splits", [1, 2, 7, "n_pages"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_split_then_combine_matches_refs(shape, n_splits,
                                         unmapped_reads_zero):
    """The split kernel's algorithm, modelled on the CPU: rows with holes,
    a row with every page unmapped and a row of length 0 (empty in every
    split), against the port's plain version and the JAX ref.  Without
    unmapped_reads_zero, rows with no valid token give zeros (the kernel's
    contract) where the refs give the uniform mean."""
    x = _inputs(sum(shape) + 11, *shape)
    n = shape[5] if n_splits == "n_pages" else n_splits
    got = _split_then_combine(*x, n, unmapped_reads_zero).numpy()
    want = ops.paged_attention(*x, device="cpu",
                               unmapped_reads_zero=unmapped_reads_zero)
    if unmapped_reads_zero:
        np.testing.assert_allclose(got, want.numpy(), atol=3e-5, rtol=3e-5)
        return
    rows = _valid_rows(x[3], x[4], shape[4])
    assert not rows[-1] and not rows[-2] and rows[:-2].all()
    jax_want = np.asarray(jax_ref(*map(jnp.asarray, x[:5]), x[5]))
    np.testing.assert_allclose(got[rows], want.numpy()[rows], atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_allclose(got[rows], jax_want[rows], atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_array_equal(got[~rows], 0.0)


@pytest.mark.parametrize("B,KV,page,n_pages", [
    (128, 4, 16, 256), (1, 4, 16, 256), (3, 2, 16, 6), (1, 8, 8, 3),
    (2, 1, 16, 10 ** 5), (1, 1, 1, 1), (4, 2, 8192, 3)])
def test_choose_splits_rule(B, KV, page, n_pages):
    """At least 64 tokens and at most 4096 tokens a split, within the page
    table and the grid; enough CTAs for 4 waves of 2 on 132 SMs where the
    tokens allow it."""
    n = K.choose_splits(B, KV, page, n_pages, 132)
    assert 1 <= n <= min(n_pages, K.MAX_GRID_Y)
    assert -(-n_pages // n) * page <= max(page, K.MAX_SPLIT_TOKENS)
    if n > 1 and n > -(-n_pages * page // K.MAX_SPLIT_TOKENS):
        assert n_pages * page // n >= K.MIN_SPLIT_TOKENS
    if n_pages * page >= 64 * 1056:
        assert B * KV * n >= K.WAVES * K.CTAS_PER_SM * 132
