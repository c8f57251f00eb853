"""Wrapper of the CUDA causal flash attention (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``flash_attention_kernel``
(``src/repro/kernels/flash_attention/kernel.py:75``).  It is bound by
operations (4 * hd flops per query head and visible pair); one CTA per
(query tile, query head, batch row) walks only the key tiles its rows can
see (see the note in the CUDA source).

``flash_attention_kernel.launches`` counts the launches this process made;
the wrapper adds one where it launches the kernel and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def _lib():
    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] +
        [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(name, x, dtypes, device):
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in dtypes or x.ndim != 4:
        raise ValueError(f"{name} must be 4-d of {dtypes}, got {x.ndim}-d "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention_kernel(q, k, v, scale: float, window: int = 0):
    """CUDA launch; same contract as ``ref.flash_attention_ref``.

    q [B,S,H,hd]; k,v [B,S,KV,hd], contiguous, all fp32 or all bf16, with
    H % KV == 0 and hd <= 256 → [B,S,H,hd] in q's dtype."""
    dev = q.device
    _check("q", q, DTYPES, dev)
    _check("k", k, (q.dtype,), dev)
    _check("v", v, (q.dtype,), dev)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, hd) or v.shape != k.shape:
        raise ValueError(f"k and v must be [B,S,KV,hd] = {(B, S, KV, hd)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside [1, {MAX_HEAD_DIM}]")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    lib = _lib()
    smem = lib.flash_attention_smem_bytes(hd)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"hd={hd} needs {smem} B of shared memory per "
                         f"block, above {MAX_SMEM_BYTES}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        KV, hd, float(scale), int(window), int(q.dtype == torch.bfloat16),
        stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
