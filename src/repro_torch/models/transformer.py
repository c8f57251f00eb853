"""Model assembly: decoder-only LMs (dense, MoE, hybrid RG-LRU, SSM), the
whisper encoder-decoder and a VLM with a stub frontend — the serving path
(prefill and decode over a cache).

The JAX package stacks its layers into superblocks (one period of
``cfg.block_pattern``) and scans them, then applies the remainder layers
(RecurrentGemma's 38 = 12 × (R, R, A) + R, R); the port keeps the same
layers in the same order in a plain list (``LM.layers``; layer i is of
kind ``pattern[i % len(pattern)]``) and loops.  Its cache is a list with
one entry a layer, by the layer's kind:
  attn  → {"k": [B,T,KV,hd], "v": [B,T,KV,hd]}
  rglru → {"h": [B,w] fp32, "conv": [B,W-1,w]}
  ssm   → {"h": [B,H,P,N] fp32, "conv": [B,W-1,d_inner+2N]}
and, for whisper, each layer's entry also holds its cross-attention
"cross_k"/"cross_v" [B,n_enc_ctx,KV,hd] (JAX's [L,B,...] stack, a layer
at a time).  ``prefill`` and ``decode_step`` write it in place.

Computation is in bf16 (``COMPUTE_DTYPE``) with the projection and
embedding weights (expert weights too) held in bf16, which is
bit-identical to the JAX package's fp32 weights cast at every use; norm
weights, the MoE router and the weights JAX uses in fp32 (the RG-LRU
gates, the SSM's A, dt bias, D and norm) stay fp32.  An MoE config's
blocks hold ``moe`` (``models/moe.py``) in place of ``mlp``, as JAX's do;
serving drops the MoE aux loss.

Not ported yet: training (``apply_block`` and ``check_supported`` raise
``NotImplementedError`` for it; ROADMAP queue 1 item 5.5).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.indexing import take
from repro_torch.models import activation_sharding
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, embed_init, init_norm,
                                       param, sinusoidal_positions)

COMPUTE_DTYPE = torch.bfloat16
NOT_PORTED = "not ported yet (ROADMAP queue 1 item 5)"
KINDS = ("attn", "rglru", "ssm")
MODES = ("prefill", "decode")


def _pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    return cfg.block_pattern or ("attn",)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The kind of each layer in JAX's order: the superblocks, then the
    remainder blocks (both are pattern[i % len(pattern)])."""
    pat = _pattern(cfg)
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def check_supported(cfg: ModelConfig, mode: str = "prefill") -> None:
    """Raises ``NotImplementedError`` for training (the one mode the port
    does not run) and ``ValueError`` for a block kind JAX has none of."""
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode!r}: training is {NOT_PORTED}")
    unknown = sorted(set(_pattern(cfg)) - set(KINDS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {unknown}")


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer, as JAX's ``init_block`` makes it: ``attn`` (norm1, attn,
    norm2, and ``moe`` for an MoE config or a dense ``mlp``), ``rglru``
    (norm1, rglru, norm2, mlp) or ``ssm`` (norm1, ssm)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None,
                 kind: str = "attn"):
        super().__init__()
        device = resolve(device)
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
        self.kind = kind
        self.norm1 = init_norm(cfg.norm_type, cfg.d_model, device)
        if kind == "ssm":
            self.ssm = ssm_mod.SSM(cfg, generator, COMPUTE_DTYPE, device)
            return
        if kind == "attn":
            self.attn = attn_mod.Attention(cfg, generator, COMPUTE_DTYPE,
                                           device)
        else:
            self.rglru = rglru_mod.RGLRU(cfg, generator, COMPUTE_DTYPE,
                                         device)
        self.norm2 = init_norm(cfg.norm_type, cfg.d_model, device)
        if kind == "attn" and cfg.moe.n_experts:
            self.moe = moe_mod.MoE(cfg, generator, COMPUTE_DTYPE, device)
        else:
            self.mlp = mlp_mod.MLP(cfg, generator, COMPUTE_DTYPE, device)


class EncoderBlock(nn.Module):
    """A whisper encoder layer: norm1, attn (bidirectional), norm2, mlp."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        device = resolve(device)
        self.norm1 = init_norm(cfg.norm_type, cfg.d_model, device)
        self.attn = attn_mod.Attention(cfg, generator, COMPUTE_DTYPE, device)
        self.norm2 = init_norm(cfg.norm_type, cfg.d_model, device)
        self.mlp = mlp_mod.MLP(cfg, generator, COMPUTE_DTYPE, device)


class Encoder(nn.Module):
    """``cfg.n_enc_layers`` encoder ``blocks`` and a ``final_norm``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.blocks = nn.ModuleList([EncoderBlock(cfg, generator, device)
                                     for _ in range(cfg.n_enc_layers)])
        self.final_norm = init_norm(cfg.norm_type, cfg.d_model,
                                    resolve(device))


class CrossBlock(nn.Module):
    """A whisper decoder layer's cross attention: norm, attn (no bias)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        device = resolve(device)
        self.norm = init_norm(cfg.norm_type, cfg.d_model, device)
        self.attn = attn_mod.Attention(cfg, generator, COMPUTE_DTYPE, device,
                                       cross=True)


class LM(nn.Module):
    """embed [V,d] (V = ``cfg.padded_vocab``), lm_head [V,d] unless tied,
    final_norm, and ``cfg.n_layers`` blocks in JAX's layer order; an
    encoder-decoder config also has ``encoder`` and one ``cross`` block a
    layer.  On ``device`` (default ``cuda``).  With no generator the
    weights are left uninitialised (to be loaded)."""

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
            [Block(cfg, generator, device, kind)
             for kind in layer_kinds(cfg)])
        if cfg.is_enc_dec:
            self.encoder = Encoder(cfg, generator, device)
            self.cross = nn.ModuleList([CrossBlock(cfg, generator, device)
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
    """mode: prefill | decode.  Returns (x, new_cache): an ``attn`` block's
    K/V (in decode, the cache slabs written in place), a recurrent block's
    state ``h`` and conv window ``conv`` (new tensors)."""
    check_supported(cfg, mode)
    rs = _res_scale(cfg)
    h = apply_norm(cfg.norm_type, p.norm1, x, cfg.norm_eps)
    # "inner" hook: under SP the carry is seq-sharded for memory; gather the
    # activation here (cheap) so TP weights stay sharded inside the block
    h = activation_sharding.constrain(h, "inner")
    if p.kind == "attn":
        if mode == "prefill":
            a, (k, v) = attn_mod.attn_prefill(p.attn, cfg, h, positions)
        else:
            a, k, v = attn_mod.attn_decode(p.attn, cfg, h, cache["k"],
                                           cache["v"], pos)
        new_cache = {"k": k, "v": v}
    else:
        h0 = cache["h"] if cache is not None else None
        cs = cache["conv"] if cache is not None else None
        apply = (rglru_mod.apply_rglru if p.kind == "rglru"
                 else ssm_mod.apply_ssm)
        a, (hn, csn) = apply(getattr(p, p.kind), cfg, h, h0=h0,
                             conv_state=cs, decode=(mode == "decode"))
        new_cache = {"h": hn, "conv": csn}
        if p.kind == "ssm":
            return x + rs * a, new_cache
    x = x + rs * a
    h2 = apply_norm(cfg.norm_type, p.norm2, x, cfg.norm_eps)
    h2 = activation_sharding.constrain(h2, "inner")
    if hasattr(p, "moe"):
        m, _ = moe_mod.apply_moe(p.moe, cfg, h2)
    else:
        m = mlp_mod.apply_mlp(p.mlp, cfg, h2)
    return x + rs * m, new_cache


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_tokens(params: LM, cfg: ModelConfig, tokens):
    """JAX's gather rule on the ids: a negative id wraps once, then every
    id is clamped into the table.  With the "embed_onehot" hook set, JAX's
    serving branch: a one-hot product over the vocabulary (an id outside
    the table gives a zero row there)."""
    if activation_sharding.enabled("embed_onehot"):
        table = params.embed.to(COMPUTE_DTYPE)
        oh = (tokens[..., None] == torch.arange(
            table.shape[0], device=tokens.device)).to(COMPUTE_DTYPE)
        x = torch.matmul(oh, table)
    else:
        x = take(params.embed, tokens).to(COMPUTE_DTYPE)
    x = activation_sharding.constrain(x, "embed")
    return x * torch.tensor(cfg.scale_emb, dtype=COMPUTE_DTYPE,
                            device=x.device)


def unembed(params: LM, cfg: ModelConfig, x):
    x = apply_norm(cfg.norm_type, params.final_norm, x, cfg.norm_eps)
    table = getattr(params, "lm_head", params.embed)
    logits = torch.matmul(x, table.to(x.dtype).T)
    if logits.ndim == 3:
        logits = activation_sharding.constrain(logits, "logits")
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

def _cache_entry_shapes(cfg: ModelConfig, kind: str, batch: int,
                        max_seq: int) -> dict:
    if kind == "attn":
        # sliding-window archs only keep a window-sized ring slab
        T = min(max_seq, cfg.window) if cfg.window else max_seq
        ent = ((batch, T, cfg.n_kv_heads, cfg.resolved_head_dim),
               COMPUTE_DTYPE)
        return {"k": ent, "v": ent}
    if kind == "rglru":
        w = cfg.rglru.lru_width or cfg.d_model
        return {"h": ((batch, w), torch.float32),
                "conv": ((batch, cfg.rglru.conv_width - 1, w),
                         COMPUTE_DTYPE)}
    d_inner, H, N = ssm_mod.ssm_dims(cfg)
    return {"h": ((batch, H, cfg.ssm.head_dim, N), torch.float32),
            "conv": ((batch, cfg.ssm.conv_width - 1, d_inner + 2 * N),
                     COMPUTE_DTYPE)}


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> List[dict]:
    """Per layer ``{name: (shape, dtype)}`` by the layer's kind (module
    docstring), with the cross-attention K/V of an encoder-decoder."""
    check_supported(cfg)
    out = [_cache_entry_shapes(cfg, kind, batch, max_seq)
           for kind in layer_kinds(cfg)]
    if cfg.is_enc_dec:
        ent = ((batch, cfg.n_enc_ctx, cfg.n_kv_heads,
                cfg.resolved_head_dim), COMPUTE_DTYPE)
        for layer in out:
            layer.update(cross_k=ent, cross_v=ent)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> List[dict]:
    dev = resolve(device)
    return [{n: torch.zeros(s, dtype=dt, device=dev)
             for n, (s, dt) in layer.items()}
            for layer in cache_shapes(cfg, batch, max_seq)]


def _merge(slab, fresh):
    """Place a prefill's cache entry into the cache in place, as JAX's
    ``merge``: a sequence slab ([B,T,·,·]) of another length than the
    prefill's keeps the last T positions (in slots 0..T-1,
    position-congruent only when S % T == 0) or, if longer, takes them
    at slots 0..S-1; any other entry (a recurrent state, a slab of the
    same length) is replaced whole."""
    if slab.ndim >= 4 and slab.shape[-3] != fresh.shape[-3]:
        T, S = slab.shape[-3], fresh.shape[-3]
        if S > T:
            slab.copy_(fresh[..., S - T:, :, :])
        else:
            slab[..., :S, :, :] = fresh
    else:
        slab.copy_(fresh)


def _store(layer_cache: dict, fresh: dict, mode: str) -> None:
    """Write a block's new cache entries into its layer's cache in place
    (decode's attention slabs already are)."""
    for n, x in fresh.items():
        if mode == "prefill":
            _merge(layer_cache[n], x)
        elif x is not layer_cache[n]:
            layer_cache[n].copy_(x)


def _run_blocks(params: LM, cfg: ModelConfig, x, positions, mode: str,
                cache, pos=None):
    """The layers in order, each writing its cache entry; the "block" hook
    at each superblock boundary."""
    period = len(_pattern(cfg))
    n_scanned = cfg.n_layers // period * period
    for i, blk in enumerate(params.layers):
        if i % period == 0 and i < n_scanned:
            x = activation_sharding.constrain(x)
        x, fresh = apply_block(blk, cfg, x, positions, mode,
                               cache=cache[i] if mode == "decode" else None,
                               pos=pos)
        _store(cache[i], fresh, mode)
    return x


def _encode(params: LM, cfg: ModelConfig, frames):
    """Whisper encoder: frames [B,T,D] (precomputed conv-frontend
    embeds)."""
    x = frames.to(COMPUTE_DTYPE)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(x.dtype)[None]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for bp in params.encoder.blocks:
        h = apply_norm(cfg.norm_type, bp.norm1, x, cfg.norm_eps)
        x = x + attn_mod.bidir_attend(bp.attn, cfg, h, positions)
        h = apply_norm(cfg.norm_type, bp.norm2, x, cfg.norm_eps)
        x = x + mlp_mod.apply_mlp(bp.mlp, cfg, h)
    return apply_norm(cfg.norm_type, params.encoder.final_norm, x,
                      cfg.norm_eps)


def _run_blocks_with_cross(params: LM, cfg: ModelConfig, x, positions,
                           enc_out, mode: str, cache, pos=None):
    """Whisper decoder: each layer's self-attention block, then its cross
    attention against the encoder's K/V (computed from ``enc_out`` in
    prefill and kept in the cache; read from it in decode)."""
    for i, (blk, cp) in enumerate(zip(params.layers, params.cross,
                                      strict=True)):
        if mode == "prefill":
            ck, cv = attn_mod.cross_kv(cp.attn, cfg, enc_out)
        else:
            ck, cv = cache[i]["cross_k"], cache[i]["cross_v"]
        x, fresh = apply_block(blk, cfg, x, positions, mode,
                               cache=cache[i] if mode == "decode" else None,
                               pos=pos)
        if mode == "prefill":
            fresh.update(cross_k=ck, cross_v=cv)
        _store(cache[i], fresh, mode)
        h = apply_norm(cfg.norm_type, cp.norm, x, cfg.norm_eps)
        x = x + attn_mod.cross_attend(cp.attn, cfg, h, ck, cv)
    return x


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, tokens, cache, extra_embeds=None):
    """Run the prompt tokens [B,S]; write each layer's cache entry into
    ``cache`` (in place) and return (logits of the last position [B,V],
    cache).  ``extra_embeds`` [B,F,D] are the stub frontends' output: a
    VLM's patch embeddings, prepended to the text (positions 0..F+S-1), or
    whisper's frames, the encoder's input (required there)."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens)
    if extra_embeds is not None:
        extra_embeds = torch.as_tensor(extra_embeds, device=x.device)
        if not cfg.is_enc_dec:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    if cfg.is_enc_dec:
        if extra_embeds is None:
            raise ValueError(f"{cfg.name}: the encoder needs its frames "
                             f"(extra_embeds)")
        enc_out = _encode(params, cfg, extra_embeds)
        x = x + sinusoidal_positions(S, cfg.d_model,
                                     x.device).to(x.dtype)[None]
        x = _run_blocks_with_cross(params, cfg, x, positions, enc_out,
                                   "prefill", cache)
    else:
        x = _run_blocks(params, cfg, x, positions, "prefill", cache)
    logits = unembed(params, cfg, x[:, -1:])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, token, pos, cache):
    """token [B] int, pos [B] int → (logits [B,V], cache); each layer's
    new cache entry is written into ``cache`` in place."""
    check_supported(cfg, "decode")
    x = embed_tokens(params, cfg, token[:, None])
    positions = pos[:, None]
    if cfg.is_enc_dec:
        table = sinusoidal_positions(cfg.max_seq, cfg.d_model, x.device)
        x = x + take(table.to(x.dtype), pos)[:, None]
        x = _run_blocks_with_cross(params, cfg, x, positions, None,
                                   "decode", cache, pos)
    else:
        x = _run_blocks(params, cfg, x, positions, "decode", cache, pos)
    logits = unembed(params, cfg, x)
    return logits[:, 0], cache
