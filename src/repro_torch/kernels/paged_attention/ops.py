"""Entry point of paged decode attention: CPU tensors → the plain version
(``ref.py``), CUDA tensors → the CUDA kernel (``kernel.py``).

There is no fallback: on the card the kernel launches or the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, k_pool, v_pool, page_map, lengths, scale: float,
                    force: str = "auto", device=None, *,
                    unmapped_reads_zero: int = 0):
    """Decode attention of one query token per request over its pages.

    q [B,H,hd]; {k,v}_pool [slots, page, KV, hd]; page_map [B, n_pages]
    (host slots, -1 unmapped); lengths [B] → [B,H,hd] in q's dtype.
    Inputs (tensors or arrays) are placed on ``device`` (default
    ``cuda``).  ``force``: ``auto`` (by device), ``ref`` (only valid on
    the CPU) or ``kernel`` (only valid on CUDA) — a forced path that does
    not match the device raises instead of falling back.
    ``unmapped_reads_zero=1`` is the vmem decode path's contract (see
    ``ref.py``); the default 0 is the TPU kernel's."""
    if force not in ("auto", "ref", "kernel"):
        raise ValueError(f"force must be auto|ref|kernel, got {force!r}")
    dev = resolve(device)
    q, k_pool, v_pool = (torch.as_tensor(x, device=dev)
                         for x in (q, k_pool, v_pool))
    page_map, lengths = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                         for x in (page_map, lengths))
    if dev.type == "cuda":
        if force == "ref":
            raise ValueError("force='ref' is the CPU path; CUDA tensors "
                             "run the kernel")
        return paged_attention_kernel(
            *[x.contiguous() for x in (q, k_pool, v_pool, page_map,
                                       lengths)],
            scale, unmapped_reads_zero=unmapped_reads_zero)
    if force == "kernel":
        raise ValueError(f"force='kernel' needs CUDA tensors, got {dev}")
    return paged_attention_ref(q, k_pool, v_pool, page_map, lengths, scale,
                               unmapped_reads_zero=unmapped_reads_zero)
