"""GQA / MQA / MHA attention with full + sliding-window masking.

Two entry points sharing one weight set (training and cross attention
are not ported yet):
  attn_prefill  — causal self-attention over a whole prompt, also returns
                  the K/V cache slab; through the flash-attention kernel
                  (``kernels/flash_attention``) unless ``attn_softcap``
  attn_decode   — single-token step against a dense K/V cache (a ring
                  buffer for sliding-window slabs), through
                  ``attention_core``

``attention_core`` stays plain PyTorch, as the JAX package leaves it to
XLA: it rounds QK^T to the compute dtype before its fp32 softmax and casts
the weights back before P V, where the kernel keeps both in fp32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.indexing import wrap
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (apply_rope, dense_init, param,
                                       rmsnorm, softcap)

NEG_INF = -1e30


class Attention(nn.Module):
    """wq [d,H,hd], wk/wv [d,KV,hd], wo [H,hd,d] in ``dtype``; optional
    bq [H,hd], bk/bv [KV,hd] (``dtype``) and q_norm/k_norm [hd] (fp32)."""

    def __init__(self, cfg: ModelConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve(device)
        d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        self.wq = param(dense_init(generator, d, (H, hd), dtype,
                                   device=device))
        self.wk = param(dense_init(generator, d, (KV, hd), dtype,
                                   device=device))
        self.wv = param(dense_init(generator, d, (KV, hd), dtype,
                                   device=device))
        self.wo = param(dense_init(generator, H * hd, d, dtype,
                                   scale=1.0 / (H * hd) ** 0.5,
                                   device=device).reshape(H, hd, d))
        if cfg.qkv_bias:
            self.bq = param(torch.zeros((H, hd), dtype=dtype, device=device))
            self.bk = param(torch.zeros((KV, hd), dtype=dtype, device=device))
            self.bv = param(torch.zeros((KV, hd), dtype=dtype, device=device))
        if cfg.qk_norm:
            self.q_norm = param(torch.zeros(hd, device=device))
            self.k_norm = param(torch.zeros(hd, device=device))


def _proj(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    return torch.matmul(x, w.to(x.dtype).flatten(1)).unflatten(-1,
                                                                w.shape[1:])


def _project_qkv(p: Attention, cfg: ModelConfig, x):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if hasattr(p, "bq"):
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    if hasattr(p, "q_norm"):
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    return q, k, v


def _causal_mask(q_pos, k_pos, window: int):
    """mask[..., s, t] True where k-position t is visible from q-position s."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def attention_core(q, k, v, mask, scale: float, attn_softcap: float = 0.0):
    """q:[B,S,H,hd] k,v:[B,T,KV,hd] mask:[B,1,S,T] or broadcastable.

    GQA flat-head (K/V repeated to H); the QK^T product in the operands'
    dtype, then an fp32 softmax whose weights go back to v's dtype."""
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    scores = softcap(scores, attn_softcap)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", w, v)


def _out_proj(p: Attention, cfg: ModelConfig, out):
    return torch.matmul(out.flatten(-2), p.wo.to(out.dtype).flatten(0, 1))


def attn_prefill(p: Attention, cfg: ModelConfig, x, positions):
    """x [B,S,D], positions [1,S] = arange(S) → (y [B,S,D], (k, v)
    [B,S,KV,hd]).  The product goes through ``flash_attention`` (the CUDA
    kernel on the card, its plain version on the CPU), or with
    ``attn_softcap``, which the kernel does not cover, through
    ``attention_core``."""
    w = cfg.window
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    scale = cfg.resolved_head_dim ** -0.5
    if cfg.attn_softcap:
        mask = _causal_mask(positions, positions, w)[:, None]
        out = attention_core(q, k, v, mask, scale, cfg.attn_softcap)
    else:
        out = flash_attention(q, k, v, scale, w)
    return _out_proj(p, cfg, out), (k, v)


def _write_slot(cache, slot, rows):
    """``cache[b, slot[b]] = rows[b]`` in place, by JAX's scatter rule: a
    negative slot wraps once, and a slot still out of range drops the
    write (the old row is written back)."""
    B, T = cache.shape[:2]
    j = wrap(slot.long(), T)
    keep = (j >= 0) & (j < T)
    j = j.clamp(0, T - 1)
    b = torch.arange(B, device=cache.device)
    cache[b, j] = torch.where(keep[:, None, None], rows.to(cache.dtype),
                              cache[b, j])


def attn_decode(p: Attention, cfg: ModelConfig, x, cache_k, cache_v, pos):
    """Single-token decode.

    x: [B,1,D]; cache_{k,v}: [B,T,KV,hd]; pos: [B] current write position.
    When the cache slab is no longer than the window (sliding-window
    archs), it is a RING buffer: slot j holds the most recent position
    ≡ j (mod T).  The new K/V row is written into the caches in place;
    returns (y [B,1,D], cache_k, cache_v)."""
    w = cfg.window
    T = cache_k.shape[1]
    ring = bool(w) and T <= w
    q, k, v = _project_qkv(p, cfg, x)                      # [B,1,·,hd]
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    slot = (pos % T) if ring else pos
    _write_slot(cache_k, slot, k[:, 0])
    _write_slot(cache_v, slot, v[:, 0])
    j = torch.arange(T, device=pos.device)[None, :]
    if ring:
        k_pos = pos[:, None] - ((pos[:, None] - j) % T)    # [B,T]
        mask = (_causal_mask(pos[:, None], k_pos, w) &
                (k_pos >= 0)[:, None, :])[:, None]
    else:
        mask = _causal_mask(pos[:, None], j, w)[:, None]
    out = attention_core(q, cache_k, cache_v, mask,
                         cfg.resolved_head_dim ** -0.5, cfg.attn_softcap)
    return _out_proj(p, cfg, out), cache_k, cache_v
