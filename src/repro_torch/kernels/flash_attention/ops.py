"""Entry point of causal flash attention: CPU tensors → the plain version
(``ref.py``), CUDA tensors → the CUDA kernel (``kernel.py``).

There is no fallback: on the card the kernel launches or the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, scale: float, window: int = 0,
                    force: str = "auto", device=None):
    """Causal (``window > 0``: sliding-window) GQA attention.

    q [B,S,H,hd]; k,v [B,S,KV,hd] → [B,S,H,hd] in q's dtype, query and key
    positions ``arange(S)``.  Tensors stay where they are and pick the
    path by their device; other inputs (arrays) are placed on ``device``
    (default ``cuda``).  ``force``: ``auto`` (by device), ``ref`` (only
    valid on the CPU) or ``kernel`` (only valid on CUDA) — a forced path
    that does not match the device raises instead of falling back."""
    if force not in ("auto", "ref", "kernel"):
        raise ValueError(f"force must be auto|ref|kernel, got {force!r}")
    if isinstance(q, torch.Tensor) and device is None:
        dev = q.device
    else:
        dev = resolve(device)
    q, k, v = (torch.as_tensor(x, device=dev) for x in (q, k, v))
    if dev.type == "cuda":
        if force == "ref":
            raise ValueError("force='ref' is the CPU path; CUDA tensors "
                             "run the kernel")
        return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                      v.contiguous(), scale, window)
    if force == "kernel":
        raise ValueError(f"force='kernel' needs CUDA tensors, got {dev}")
    if type(q).__name__ == "DTensor":    # on a mesh: each device's shards
        from repro_torch.models.activation_sharding import by_heads
        return by_heads(lambda *a: flash_attention_ref(*a, scale, window),
                        q, k, v)
    return flash_attention_ref(q, k, v, scale, window)
