"""Plain PyTorch version of paged decode attention — the CPU path of
``ops.paged_attention`` and the yardstick the CUDA kernel is held against
on the card.

With ``unmapped_reads_zero=0`` it is ``repro.kernels.paged_attention.ref``:
a token counts iff it lies below ``length`` on a mapped page, and a row in
which no token counts gets the softmax of an all -1e30 row — the uniform
mean of the V rows it gathered.  With ``unmapped_reads_zero=1`` it is the
decode attention of ``repro.core.vmem.kvcache.paged_decode_attention``: an
unmapped page reads K = V = 0 and its tokens below ``length`` still count.
Slots are gathered by JAX's rule: a negative one reads slot 0, one past
the pool reads the last slot.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pool, v_pool, page_map, lengths, scale,
                        unmapped_reads_zero: int = 0):
    """q [B,H,hd]; {k,v}_pool [slots, page, KV, hd]; page_map [B, n_pages]
    int32 (host slots, -1 unmapped); lengths [B] → out [B,H,hd] in q's
    dtype.  Computes in float32."""
    B, H, hd = q.shape
    n_slots, page, KV = k_pool.shape[:3]
    G = H // KV
    n_pages = page_map.shape[1]
    T = n_pages * page
    slots = page_map.long().clamp(0, n_slots - 1)
    k = k_pool[slots].reshape(B, T, KV, hd).float()
    v = v_pool[slots].reshape(B, T, KV, hd).float()
    mapped = (page_map >= 0).repeat_interleave(page, dim=1)      # [B, T]
    t_idx = torch.arange(T, device=q.device)
    mask = t_idx[None, :] < lengths.to(q.device)[:, None]
    if unmapped_reads_zero:
        k = torch.where(mapped[..., None, None], k, 0.0)
        v = torch.where(mapped[..., None, None], v, 0.0)
    else:
        mask = mask & mapped
    qg = q.reshape(B, KV, G, hd).float()
    scores = torch.einsum("bkgh,btkh->bkgt", qg, k) * scale
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", w, v)
    return out.reshape(B, H, hd).to(q.dtype)
