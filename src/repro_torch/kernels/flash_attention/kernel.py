"""Wrapper of the CUDA causal flash attention (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``flash_attention_kernel``
(``src/repro/kernels/flash_attention/kernel.py:75``).  It is bound by
operations (4 * hd flops per query head and visible pair); one CTA per
(query tile, query head, batch row) walks only the key tiles its rows can
see.  The dtype picks the kernel: bf16 inputs run on the tensor cores
(``mma.sync``, bf16 K/V in shared memory through ``cp.async``), fp32
inputs on the SIMT kernel, whose fp32 FMAs meet the 2e-5 tolerance that
TF32 tensor cores cannot (see the note in the CUDA source).

``flash_attention_kernel.launches`` counts the launches this process made;
the wrapper adds one where it launches the kernel and nowhere else.

The launch is bound as the custom op ``repro_torch::flash_attention``: on
CUDA tensors it launches the kernel; on fake tensors (the dry run's
``FakeTensorMode``) its fake implementation gives ``empty_like(q)`` and
launches nothing; on DTensors its sharding rule (``_sharding``) runs it
per batch row or per head group on each device's local tensors.
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
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
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
    _check_inputs(q, k, v, window)
    return _flash_op()(q, k, v, float(scale), int(window))


def _check_inputs(q, k, v, window):
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


def _launch(q, k, v, scale: float, window: int):
    """The launch itself (the custom op's CUDA implementation)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    dev = q.device
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    lib = _lib()
    is_bf16 = int(q.dtype == torch.bfloat16)
    smem = lib.flash_attention_smem_bytes(hd, is_bf16)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"hd={hd} needs {smem} B of shared memory per "
                         f"block, above {MAX_SMEM_BYTES}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        KV, hd, float(scale), int(window), is_bf16, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
_OP = []


def _flash_op():
    """``torch.ops.repro_torch.flash_attention``, defined on first use
    with its fake implementation and its DTensor sharding rule."""
    if _OP:
        return _OP[0]

    @torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
    def op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
           window: int) -> torch.Tensor:
        return _launch(q, k, v, scale, window)

    @op.register_fake
    def _(q, k, v, scale, window):
        return torch.empty_like(q)

    from torch.distributed.tensor.experimental import register_sharding
    register_sharding(torch.ops.repro_torch.flash_attention.default)(
        _sharding)
    _OP.append(op)
    return op


def _sharding(q, k, v, scale, window):
    """Acceptable placements on one mesh dimension: all replicated, the
    batch sharded, or (when every head count divides over the whole
    mesh, so each device keeps whole GQA groups) the heads sharded."""
    from torch.distributed.tensor import Replicate, Shard

    out = [([Replicate()], [Replicate()] * 3 + [None, None]),
           ([Shard(0)], [Shard(0)] * 3 + [None, None])]
    n = q.mesh.size()
    if q.shape[2] % n == 0 and k.shape[2] % n == 0:
        out.append(([Shard(2)], [Shard(2)] * 3 + [None, None]))
    return out
