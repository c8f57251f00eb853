"""Plain PyTorch causal (optionally windowed) GQA attention: the CPU path
of ``ops.flash_attention`` and the yardstick of the CUDA kernel on the card.

It works in fp32 and materialises the [B, KV, G, S, S] scores, so it is
for test shapes (and, on the card, one KV head at a time).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, scale: float, window: int = 0):
    """q [B,S,H,hd]; k,v [B,S,KV,hd] → [B,S,H,hd] in q's dtype.  Causal;
    ``window > 0`` keeps the keys with ``kpos > qpos - window``."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > (pos[:, None] - window)
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
