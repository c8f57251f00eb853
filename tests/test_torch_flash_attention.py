"""The port's causal flash attention against the JAX package's.

On the CPU the entry point runs the plain version (``ref.py``), held here
against the JAX ``flash_attention_ref`` and against the JAX Pallas kernel
in interpret mode (as ``tests/test_kernels.py`` runs it).  The CUDA
kernel is held against the plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# (B, S, H, KV, hd, window): the four shapes of
# tests/test_kernels.py::test_flash_attention_matches_ref, then hd = 120 at
# a ragged S, and the windows 1 and >= S; then RecurrentGemma's head layout
# (hd 256, KV 1, G 16) at a ragged S with a window edge inside a 32-key
# tile, hd 250 (the CUDA kernel's element loads at HDP 256) and hd 256 with
# a window at G 16 (in fp32 the SIMT kernel's shape on the card)
SHAPES = [(1, 64, 2, 1, 16, 0), (2, 128, 4, 2, 32, 0),
          (1, 128, 4, 4, 32, 32), (2, 256, 8, 2, 64, 0),
          (1, 100, 8, 2, 120, 32), (2, 40, 4, 2, 16, 1),
          (1, 48, 4, 1, 120, 48), (1, 30, 2, 2, 32, 1000),
          (1, 203, 16, 1, 256, 50), (2, 77, 4, 2, 250, 0),
          (1, 100, 16, 1, 256, 40)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, hd)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return q, k, v


def _both(x, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    _, jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(x, jdt)
    return j, torch.as_tensor(np.array(j.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ref_matches_jax_ref(shape, dtype):
    B, S, H, KV, hd, window = shape
    pairs = [_both(x, dtype) for x in _inputs(sum(shape), B, S, H, KV, hd)]
    want = jax_ref(*[p[0] for p in pairs], hd ** -0.5, window)
    got = ops.flash_attention(*[p[1] for p in pairs], hd ** -0.5, window)
    assert got.dtype == DTYPES[dtype][2] and got.shape == (B, S, H, hd)
    tol = DTYPES[dtype][3]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ref_matches_jax_kernel_interpret(shape, dtype):
    B, S, H, KV, hd, window = shape
    pairs = [_both(x, dtype) for x in _inputs(sum(shape) + 1, B, S, H, KV,
                                              hd)]
    want = jax_flash(*[p[0] for p in pairs], hd ** -0.5, window,
                     force="interpret")
    got = ops.flash_attention(*[p[1] for p in pairs], hd ** -0.5, window)
    tol = DTYPES[dtype][3]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_window_one_is_the_own_value():
    """window = 1: every query sees only its own key, so out = v."""
    q, k, v = (torch.as_tensor(x) for x in _inputs(3, 2, 20, 4, 2, 16))
    out = flash_attention_ref(q, k, v, 0.25, 1)
    torch.testing.assert_close(out, v.repeat_interleave(2, dim=2))


def test_window_at_least_s_is_plain_causal():
    q, k, v = (torch.as_tensor(x) for x in _inputs(4, 1, 33, 4, 2, 16))
    for w in (33, 34, 10_000):
        torch.testing.assert_close(flash_attention_ref(q, k, v, 0.25, w),
                                   flash_attention_ref(q, k, v, 0.25, 0))


def test_cpu_dispatch_makes_no_launch():
    q, k, v = _inputs(5, 1, 16, 2, 1, 16)
    n0 = K.flash_attention_kernel.launches
    out = ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), 0.25, force="ref")
    out2 = ops.flash_attention(q, k, v, 0.25, device="cpu")
    assert K.flash_attention_kernel.launches == n0
    assert out.device.type == "cpu"
    torch.testing.assert_close(out, out2)


def test_force_kernel_on_cpu_raises():
    q, k, v = (torch.as_tensor(x) for x in _inputs(6, 1, 16, 2, 1, 16))
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.flash_attention(q, k, v, 0.25, force="kernel")
    with pytest.raises(ValueError, match="force"):
        ops.flash_attention(q, k, v, 0.25, force="interpret")


def test_kernel_wrapper_rejects_cpu_tensors():
    """The wrapper takes only CUDA tensors: a CPU tensor raises before
    anything is built or launched."""
    q, k, v = (torch.as_tensor(x) for x in _inputs(7, 1, 16, 2, 1, 16))
    n0 = K.flash_attention_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.flash_attention_kernel(q, k, v, 0.25)
    assert K.flash_attention_kernel.launches == n0


def test_default_device_is_cuda():
    """Arrays (not tensors) go to ``cuda`` unless the CPU is asked for;
    with no card that raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default path is the kernel")
    q, k, v = _inputs(8, 1, 16, 2, 1, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention(q, k, v, 0.25)
