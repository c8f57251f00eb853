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
