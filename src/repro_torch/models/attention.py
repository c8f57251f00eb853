"""GQA / MQA / MHA attention with full + sliding-window masking.

Entry points sharing one weight set:
  attn_train    — causal (optionally windowed) self-attention over a full
                  sequence, through ``attention_core`` as JAX's
                  ``attn_train`` is (the kernel is forward only, and JAX
                  trains through XLA's autodiff of the plain product)
  attn_prefill  — causal self-attention over a whole prompt, also returns
                  the K/V cache slab; through the flash-attention kernel
                  (``kernels/flash_attention``) unless ``attn_softcap``
  attn_decode   — single-token step against a dense K/V cache (a ring
                  buffer for sliding-window slabs), through
                  ``attention_core``
  cross_kv, cross_attend — whisper's decoder against the encoder output
  bidir_attend  — whisper's encoder, unmasked
The last three go through ``attention_core``, as JAX leaves them to XLA
(the kernel is causal only).

``attention_core`` stays plain PyTorch, as the JAX package leaves it to
XLA: it rounds QK^T to the compute dtype before its fp32 softmax and casts
the weights back before P V, where the kernel keeps both in fp32.  It
contracts each KV head against its G query heads; JAX repeats K/V to H
heads first, which gives the same products.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.indexing import wrap
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import activation_sharding
from repro_torch.models.layers import (apply_rope, dense_init, param,
                                       rmsnorm, softcap)

NEG_INF = -1e30


def param_specs(cfg: ModelConfig) -> dict:
    """JAX's logical spec of each ``Attention`` leaf (``init_attention``)."""
    del cfg
    return {"wq": ("fsdp", "tp", None), "wk": ("fsdp", "tp", None),
            "wv": ("fsdp", "tp", None), "wo": ("tp", None, "fsdp"),
            "bq": ("tp", None), "bk": ("tp", None), "bv": ("tp", None),
            "q_norm": (None,), "k_norm": (None,)}


class Attention(nn.Module):
    """wq [d,H,hd], wk/wv [d,KV,hd], wo [H,hd,d] in ``dtype``; optional
    bq [H,hd], bk/bv [KV,hd] (``dtype``; never on a ``cross`` attention)
    and q_norm/k_norm [hd] (fp32)."""

    def __init__(self, cfg: ModelConfig, generator=None, dtype=torch.float32,
                 device=None, cross: bool = False):
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
        if cfg.qkv_bias and not cross:
            self.bq = param(torch.zeros((H, hd), dtype=dtype, device=device))
            self.bk = param(torch.zeros((KV, hd), dtype=dtype, device=device))
            self.bv = param(torch.zeros((KV, hd), dtype=dtype, device=device))
        if cfg.qk_norm:
            self.q_norm = param(torch.zeros(hd, device=device))
            self.k_norm = param(torch.zeros(hd, device=device))


def _proj(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    return activation_sharding.linear(x, w.to(x.dtype))


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

    GQA grouped over KV heads: q is viewed as [B,S,KV,G,hd] (head
    h = kv*G + g, the order JAX's repeat of K/V gives) and contracted
    against k/v as they are, with no copy of K/V per query head; the QK^T
    product in the operands' dtype, then an fp32 softmax whose weights go
    back to v's dtype.

    On a mesh it runs on each device's batch rows and heads, or its
    query rows where the heads cannot stay whole in their GQA groups
    (``activation_sharding.by_heads``: as DTensor ops, the grouped
    product would fold two sharded dimensions into one), except a decode
    step against a cache sharded along its keys, which runs as DTensor
    ops: the key dimension stays sharded, the softmax's max and sum and
    the product with V reduce partials over it (flash decoding), as
    JAX's decode scores hook asks."""
    if activation_sharding.is_dtensor(q):
        keys_sharded = activation_sharding.is_dtensor(k) and any(
            getattr(p, "dim", None) == 1 for p in k.placements)
        if not (q.shape[1] == 1 and keys_sharded):
            return activation_sharding.by_heads(
                lambda *a: _core(*a, scale, attn_softcap), q, k, v, mask,
                rows=True)
        # the one query row gathered over its heads (a few KB)
        q = activation_sharding.without(q, dims=(2,))
    return _core(q, k, v, mask, scale, attn_softcap)


def _core(q, k, v, mask, scale: float, attn_softcap: float = 0.0):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.view(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    # hook: JAX's [B,H,S,T] scores (h = kv*G + g), a view of these
    scores = activation_sharding.constrain(scores.flatten(1, 2),
                                           "scores").unflatten(1, (KV, -1))
    scores = softcap(scores, attn_softcap)
    scores = torch.where(mask.unsqueeze(2), scores, NEG_INF)
    if activation_sharding.is_dtensor(scores):
        # partial max and sum over a sharded key dimension (softmax
        # itself would gather the scores)
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        w = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    else:
        w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", w, v).reshape(B, S, H, hd)


def _out_proj(p: Attention, cfg: ModelConfig, out):
    return activation_sharding.linear(out, p.wo.to(out.dtype), k=2)


def attn_train(p: Attention, cfg: ModelConfig, x, positions, window=None):
    """x [B,S,D], positions [B,S] (or [1,S]) → [B,S,D].  Causal, with
    ``cfg.window`` (or ``window``) as a sliding window."""
    w = cfg.window if window is None else window
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    mask = _causal_mask(positions, positions, w)[:, None]   # [B,1,S,T]
    out = attention_core(q, k, v, mask, cfg.resolved_head_dim ** -0.5,
                         cfg.attn_softcap)
    return _out_proj(p, cfg, out)


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
    if activation_sharding.is_dtensor(cache):
        # on a mesh, a select over the slots (the slab may be sharded
        # along them): the same result, as DTensor ops
        hit = (torch.arange(T, device=cache.device)[None, :] == j[:, None]
               ) & keep[:, None]
        cache.copy_(torch.where(hit[:, :, None, None],
                                rows.to(cache.dtype)[:, None], cache))
        return
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


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder) and the bidirectional encoder
# ---------------------------------------------------------------------------

def cross_kv(p: Attention, cfg: ModelConfig, enc_out):
    """Precompute K,V from encoder output: [B,T,D] → ([B,T,KV,hd] ×2)."""
    return _proj(enc_out, p.wk), _proj(enc_out, p.wv)


def _unmasked(q, k):
    return torch.ones((1, 1, 1, k.shape[1]), dtype=torch.bool,
                      device=q.device)


def cross_attend(p: Attention, cfg: ModelConfig, x, k, v):
    """Decoder queries against precomputed encoder K/V (no mask, no rope)."""
    q = _proj(x, p.wq)
    out = attention_core(q, k, v, _unmasked(q, k),
                         cfg.resolved_head_dim ** -0.5)
    return _out_proj(p, cfg, out)


def bidir_attend(p: Attention, cfg: ModelConfig, x, positions):
    """Bidirectional self-attention (whisper encoder).  No rope (the
    sinusoid positions are already added), no mask."""
    q, k, v = _project_qkv(p, cfg, x)
    out = attention_core(q, k, v, _unmasked(q, k),
                         cfg.resolved_head_dim ** -0.5)
    return _out_proj(p, cfg, out)
