"""Model assembly: decoder-only dense LMs, the serving path (prefill and
decode over a dense K/V cache).

The JAX package stacks its layers into superblocks and scans them; the
port keeps them in a plain list (``LM.layers``) and loops.  Its cache is a
list with one ``{"k": [B,T,KV,hd], "v": [B,T,KV,hd]}`` per layer.

Computation is in bf16 (``COMPUTE_DTYPE``) with the projection and
embedding weights held in bf16, which is bit-identical to the JAX
package's fp32 weights cast at every use; norm weights stay fp32.

Not ported yet (each raises ``NotImplementedError``; ROADMAP queue 1
item 5 lists them in order): MoE blocks, RG-LRU and SSM blocks, the
encoder-decoder path, the frontend ``extra_embeds`` path, and training.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.indexing import take
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.layers import (apply_norm, embed_init, init_norm,
                                       param)

COMPUTE_DTYPE = torch.bfloat16
NOT_PORTED = "not ported yet (ROADMAP queue 1 item 5)"


def _pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    return cfg.block_pattern or ("attn",)


def check_supported(cfg: ModelConfig) -> None:
    """Raises ``NotImplementedError`` for a config the port cannot run."""
    if cfg.is_enc_dec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder path is "
                                  f"{NOT_PORTED}")
    if cfg.moe.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are {NOT_PORTED}")
    other = sorted(set(_pattern(cfg)) - {"attn"})
    if other:
        raise NotImplementedError(f"{cfg.name}: {'/'.join(other)} blocks are "
                                  f"{NOT_PORTED}")


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """An ``attn`` block with a dense MLP: norm1, attn, norm2, mlp."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        device = resolve(device)
        self.norm1 = init_norm(cfg.norm_type, cfg.d_model, device)
        self.attn = attn_mod.Attention(cfg, generator, COMPUTE_DTYPE, device)
        self.norm2 = init_norm(cfg.norm_type, cfg.d_model, device)
        self.mlp = mlp_mod.MLP(cfg, generator, COMPUTE_DTYPE, device)


class LM(nn.Module):
    """embed [V,d] (V = ``cfg.padded_vocab``), lm_head [V,d] unless tied,
    final_norm, and ``cfg.n_layers`` blocks, on ``device`` (default
    ``cuda``).  With no generator the weights are left uninitialised (to
    be loaded)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        check_supported(cfg)
        device = resolve(device)
        V, d, dt = cfg.padded_vocab, cfg.d_model, COMPUTE_DTYPE
        self.embed = param(embed_init(generator, V, d, dt, device))
        if not cfg.tie_embeddings:
            self.lm_head = param(embed_init(generator, V, d, dt, device))
        self.final_norm = init_norm(cfg.norm_type, d, device)
        self.layers = nn.ModuleList(
            [Block(cfg, generator, device)
             for _ in range(cfg.n_layers)])


def init_lm(cfg: ModelConfig, generator, device=None) -> LM:
    """Seeded weights of ``cfg`` on ``device`` (default ``cuda``).
    ``generator`` is a ``torch.Generator`` of that device or an int seed;
    on the ``meta`` device only the shapes are made."""
    dev = resolve(device)
    if dev.type == "meta":
        generator = None
    elif isinstance(generator, int):
        seed, generator = generator, torch.Generator(device=dev)
        generator.manual_seed(seed)
    return LM(cfg, generator, device=dev)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _res_scale(cfg: ModelConfig):
    if cfg.scale_depth:
        return cfg.scale_depth / (2.0 * cfg.n_layers) ** 0.5
    return 1.0


def apply_block(p: Block, cfg: ModelConfig, x, positions, mode: str,
                cache=None, pos=None):
    """mode: prefill | decode.  Returns (x, new_cache)."""
    rs = _res_scale(cfg)
    h = apply_norm(cfg.norm_type, p.norm1, x, cfg.norm_eps)
    if mode == "prefill":
        a, (k, v) = attn_mod.attn_prefill(p.attn, cfg, h, positions)
    elif mode == "decode":
        a, k, v = attn_mod.attn_decode(p.attn, cfg, h, cache["k"],
                                       cache["v"], pos)
    else:
        raise NotImplementedError(f"mode {mode!r}: training is {NOT_PORTED}")
    x = x + rs * a
    h2 = apply_norm(cfg.norm_type, p.norm2, x, cfg.norm_eps)
    m = mlp_mod.apply_mlp(p.mlp, cfg, h2)
    return x + rs * m, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(params: LM, cfg: ModelConfig, tokens):
    """JAX's gather rule on the ids: a negative id wraps once, then every
    id is clamped into the table."""
    x = take(params.embed, tokens).to(COMPUTE_DTYPE)
    return x * torch.tensor(cfg.scale_emb, dtype=COMPUTE_DTYPE,
                            device=x.device)


def unembed(params: LM, cfg: ModelConfig, x):
    x = apply_norm(cfg.norm_type, params.final_norm, x, cfg.norm_eps)
    table = getattr(params, "lm_head", params.embed)
    logits = torch.matmul(x, table.to(x.dtype).T)
    if cfg.dim_model_base:
        logits = logits / (cfg.d_model / cfg.dim_model_base)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:   # mask vocab-padding columns
        vmask = torch.arange(cfg.padded_vocab, device=x.device) \
            < cfg.vocab_size
        logits = torch.where(vmask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=x.device))
    return logits


# ---------------------------------------------------------------------------
# Caches: init / prefill / decode
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> List[dict]:
    """Per layer ``{"k": (shape, dtype), "v": (shape, dtype)}``;
    sliding-window archs keep a window-sized ring slab."""
    check_supported(cfg)
    T = min(max_seq, cfg.window) if cfg.window else max_seq
    ent = ((batch, T, cfg.n_kv_heads, cfg.resolved_head_dim), COMPUTE_DTYPE)
    return [{"k": ent, "v": ent} for _ in range(cfg.n_layers)]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> List[dict]:
    dev = resolve(device)
    return [{n: torch.zeros(s, dtype=dt, device=dev)
             for n, (s, dt) in layer.items()}
            for layer in cache_shapes(cfg, batch, max_seq)]


def _merge(slab, fresh):
    """Place prefill K/V into a cache slab in place: a window slab keeps
    the last T positions (in slots 0..T-1, position-congruent only when
    S % T == 0, as in the JAX package); a longer slab takes them at
    slots 0..S-1."""
    T, S = slab.shape[1], fresh.shape[1]
    if S >= T:
        slab.copy_(fresh[:, S - T:])
    else:
        slab[:, :S] = fresh


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, tokens, cache, extra_embeds=None):
    """Run the prompt tokens [B,S]; write its K/V into ``cache`` (in
    place) and return (logits of the last position [B,V], cache)."""
    if extra_embeds is not None:
        raise NotImplementedError(f"extra_embeds: the frontend path is "
                                  f"{NOT_PORTED}")
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    for blk, slab in zip(params.layers, cache, strict=True):
        x, fresh = apply_block(blk, cfg, x, positions, "prefill")
        _merge(slab["k"], fresh["k"])
        _merge(slab["v"], fresh["v"])
    logits = unembed(params, cfg, x[:, -1:])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, token, pos, cache):
    """token [B] int, pos [B] int → (logits [B,V], cache); the new K/V
    rows are written into ``cache`` in place."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, token[:, None])
    positions = pos[:, None]
    for i, blk in enumerate(params.layers):
        x, cache[i] = apply_block(blk, cfg, x, positions, "decode",
                                  cache=cache[i], pos=pos)
    logits = unembed(params, cfg, x)
    return logits[:, 0], cache
