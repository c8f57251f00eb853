"""Model assembly: decoder-only LMs (dense, MoE, hybrid RG-LRU, SSM), the
whisper encoder-decoder and a VLM with a stub frontend — training
(``forward_train``, ``lm_loss``, ``loss_fn``) and serving (prefill and
decode over a cache).

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

Computation is in bf16 (``COMPUTE_DTYPE``).  A serving model holds the
projection and embedding weights (expert weights too) in bf16, which is
bit-identical to the JAX package's fp32 weights cast at every use; norm
weights, the MoE router and the weights JAX uses in fp32 (the RG-LRU
gates, the SSM's A, dt bias, D and norm) stay fp32.  A training model
(``init_lm(..., dtype=torch.float32)``) holds every weight in fp32, as
JAX's ``init_lm`` does; the train step (``runtime/train_loop.py``) runs
``loss_fn`` on a bf16 copy of it through ``torch.func.functional_call``
(``LM.forward``).  An MoE config's blocks hold ``moe``
(``models/moe.py``) in place of ``mlp``, as JAX's do; training adds its
aux loss to the loss, serving drops it.

Remat (training only) follows ``cfg.remat`` over each superblock, as
JAX's ``_maybe_remat``: ``"none"``; ``"full"`` recomputes the whole
superblock in the backward; ``"dots"`` (JAX's
``dots_with_no_batch_dims_saveable``) keeps the outputs of the
projections (``aten.mm``/``addmm``) and recomputes the rest, the
attention and MoE batched products (``aten.bmm``) included.  Remat
changes memory only, never a number.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.indexing import take
from repro_torch.models import activation_sharding
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (EMBED_SPEC, NORM_SPECS, Norm,
                                       apply_norm, embed_init, init_norm,
                                       param, sinusoidal_positions)

COMPUTE_DTYPE = torch.bfloat16
KINDS = ("attn", "rglru", "ssm")
MODES = ("train", "prefill", "decode")


def _pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    return cfg.block_pattern or ("attn",)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The kind of each layer in JAX's order: the superblocks, then the
    remainder blocks (both are pattern[i % len(pattern)])."""
    pat = _pattern(cfg)
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def check_supported(cfg: ModelConfig, mode: str = "prefill") -> None:
    """Raises ``ValueError`` for a mode other than ``MODES`` and for a
    block kind JAX has none of."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: not one of {MODES}")
    unknown = sorted(set(_pattern(cfg)) - set(KINDS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {unknown}")


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer, as JAX's ``init_block`` makes it: ``attn`` (norm1, attn,
    norm2, and ``moe`` for an MoE config or a dense ``mlp``), ``rglru``
    (norm1, rglru, norm2, mlp) or ``ssm`` (norm1, ssm).  The weights the
    compute casts at every use are held in ``dtype`` (default
    ``COMPUTE_DTYPE``)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None,
                 kind: str = "attn", dtype=None):
        super().__init__()
        device = resolve(device)
        dtype = dtype or COMPUTE_DTYPE
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
        self.kind = kind
        self.norm1 = init_norm(cfg.norm_type, cfg.d_model, device)
        if kind == "ssm":
            self.ssm = ssm_mod.SSM(cfg, generator, dtype, device)
            return
        if kind == "attn":
            self.attn = attn_mod.Attention(cfg, generator, dtype, device)
        else:
            self.rglru = rglru_mod.RGLRU(cfg, generator, dtype, device)
        self.norm2 = init_norm(cfg.norm_type, cfg.d_model, device)
        if kind == "attn" and cfg.moe.n_experts:
            self.moe = moe_mod.MoE(cfg, generator, dtype, device)
        else:
            self.mlp = mlp_mod.MLP(cfg, generator, dtype, device)


class EncoderBlock(nn.Module):
    """A whisper encoder layer: norm1, attn (bidirectional), norm2, mlp."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None,
                 dtype=None):
        super().__init__()
        device = resolve(device)
        dtype = dtype or COMPUTE_DTYPE
        self.norm1 = init_norm(cfg.norm_type, cfg.d_model, device)
        self.attn = attn_mod.Attention(cfg, generator, dtype, device)
        self.norm2 = init_norm(cfg.norm_type, cfg.d_model, device)
        self.mlp = mlp_mod.MLP(cfg, generator, dtype, device)


class Encoder(nn.Module):
    """``cfg.n_enc_layers`` encoder ``blocks`` and a ``final_norm``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None,
                 dtype=None):
        super().__init__()
        self.blocks = nn.ModuleList([EncoderBlock(cfg, generator, device,
                                                  dtype)
                                     for _ in range(cfg.n_enc_layers)])
        self.final_norm = init_norm(cfg.norm_type, cfg.d_model,
                                    resolve(device))


class CrossBlock(nn.Module):
    """A whisper decoder layer's cross attention: norm, attn (no bias)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None,
                 dtype=None):
        super().__init__()
        device = resolve(device)
        dtype = dtype or COMPUTE_DTYPE
        self.norm = init_norm(cfg.norm_type, cfg.d_model, device)
        self.attn = attn_mod.Attention(cfg, generator, dtype, device,
                                       cross=True)


class LM(nn.Module):
    """embed [V,d] (V = ``cfg.padded_vocab``), lm_head [V,d] unless tied,
    final_norm, and ``cfg.n_layers`` blocks in JAX's layer order; an
    encoder-decoder config also has ``encoder`` and one ``cross`` block a
    layer.  On ``device`` (default ``cuda``).  With no generator the
    weights are left uninitialised (to be loaded).  ``dtype`` is that of
    the weights the compute casts at every use: ``COMPUTE_DTYPE`` (bf16)
    by default, to serve; fp32 for a training model (every weight fp32,
    JAX's ``init_lm``)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None,
                 dtype=None):
        super().__init__()
        check_supported(cfg)
        device = resolve(device)
        dtype = dtype or COMPUTE_DTYPE
        V, d = cfg.padded_vocab, cfg.d_model
        self.embed = param(embed_init(generator, V, d, dtype, device))
        if not cfg.tie_embeddings:
            self.lm_head = param(embed_init(generator, V, d, dtype, device))
        self.final_norm = init_norm(cfg.norm_type, d, device)
        self.layers = nn.ModuleList(
            [Block(cfg, generator, device, kind, dtype)
             for kind in layer_kinds(cfg)])
        if cfg.is_enc_dec:
            self.encoder = Encoder(cfg, generator, device, dtype)
            self.cross = nn.ModuleList([CrossBlock(cfg, generator, device,
                                                   dtype)
                                        for _ in range(cfg.n_layers)])

    def forward(self, fn, *args):
        """``fn(self, *args)``: so ``torch.func.functional_call`` can run
        any function of the model (``loss_fn``) with other tensors in
        place of its weights (the train step's bf16 copy)."""
        return fn(self, *args)


def init_lm(cfg: ModelConfig, generator, device=None,
            dtype=None, with_specs: bool = False):
    """Seeded weights of ``cfg`` on ``device`` (default ``cuda``), those
    the compute casts in ``dtype`` (``torch.float32`` for training).
    ``generator`` is a ``torch.Generator`` of that device or an int seed;
    on the ``meta`` device only the shapes are made.  Returns the ``LM``,
    or with ``with_specs`` the pair (``LM``, ``logical_specs(cfg)``), as
    JAX's ``init_lm`` returns its twin trees."""
    dev = resolve(device)
    if dev.type == "meta":
        generator = None
    elif isinstance(generator, int):
        seed, generator = generator, torch.Generator(device=dev)
        generator.manual_seed(seed)
    lm = LM(cfg, generator, device=dev, dtype=dtype)
    return (lm, module_specs(cfg, lm)) if with_specs else lm


def module_specs(cfg: ModelConfig, lm: nn.Module) -> dict:
    """JAX's logical spec of each parameter of ``lm`` (an ``LM`` of
    ``cfg``), keyed as ``lm.named_parameters()``: each module's
    ``param_specs`` table by leaf name.  A per-layer leaf has the spec of
    JAX's stacked leaf without its leading None."""
    tables = {attn_mod.Attention: attn_mod.param_specs(cfg),
              mlp_mod.MLP: mlp_mod.param_specs(cfg),
              moe_mod.MoE: moe_mod.param_specs(cfg),
              rglru_mod.RGLRU: rglru_mod.param_specs(cfg),
              ssm_mod.SSM: ssm_mod.param_specs(cfg),
              Norm: NORM_SPECS,
              LM: {"embed": EMBED_SPEC, "lm_head": EMBED_SPEC}}
    out = {}
    for prefix, mod in lm.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            out[f"{prefix}.{name}" if prefix else name] = \
                tables[type(mod)][name]
    return out


def logical_specs(cfg: ModelConfig) -> dict:
    """JAX's logical spec of every weight of ``cfg``'s ``LM``, keyed as
    its ``named_parameters()`` (a spec is a tuple of logical axes)."""
    return module_specs(cfg, LM(cfg, device="meta"))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _res_scale(cfg: ModelConfig):
    if cfg.scale_depth:
        return cfg.scale_depth / (2.0 * cfg.n_layers) ** 0.5
    return 1.0


def apply_block(p: Block, cfg: ModelConfig, x, positions, mode: str,
                cache=None, pos=None):
    """mode: train | prefill | decode.  Returns (x, new_cache, aux_loss):
    the cache entry is an ``attn`` block's K/V (in decode, the cache slabs
    written in place) or a recurrent block's state ``h`` and conv window
    ``conv`` (new tensors), and None in training; the aux loss is an MoE
    block's load-balance loss (an fp32 scalar), else the number 0.0 (no
    launch on the serving path)."""
    check_supported(cfg, mode)
    rs = _res_scale(cfg)
    aux = 0.0
    new_cache = None
    h = apply_norm(cfg.norm_type, p.norm1, x, cfg.norm_eps)
    # "inner" hook: under SP the carry is seq-sharded for memory; gather the
    # activation here (cheap) so TP weights stay sharded inside the block
    h = activation_sharding.constrain(h, "inner")
    if p.kind == "attn":
        if mode == "train":
            a = attn_mod.attn_train(p.attn, cfg, h, positions)
        elif mode == "prefill":
            a, (k, v) = attn_mod.attn_prefill(p.attn, cfg, h, positions)
            new_cache = {"k": k, "v": v}
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
        if mode != "train":
            new_cache = {"h": hn, "conv": csn}
        if p.kind == "ssm":
            return x + rs * a, new_cache, aux
    x = x + rs * a
    h2 = apply_norm(cfg.norm_type, p.norm2, x, cfg.norm_eps)
    h2 = activation_sharding.constrain(h2, "inner")
    if hasattr(p, "moe"):
        m, aux = moe_mod.apply_moe(p.moe, cfg, h2)
    else:
        m = mlp_mod.apply_mlp(p.mlp, cfg, h2)
    return x + rs * m, new_cache, aux


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
        x = activation_sharding.gather_rows(params.embed, tokens).to(
            COMPUTE_DTYPE)
    x = activation_sharding.constrain(x, "embed")
    return x * torch.tensor(cfg.scale_emb, dtype=COMPUTE_DTYPE,
                            device=x.device)


def unembed(params: LM, cfg: ModelConfig, x):
    # on a mesh, the sequence gathered (the "logits" hook's layout; as
    # DTensor ops the product would fold two sharded dimensions into one)
    x = activation_sharding.without(x, dims=(1,), partial=False)
    x = apply_norm(cfg.norm_type, params.final_norm, x, cfg.norm_eps)
    table = getattr(params, "lm_head", params.embed)
    logits = activation_sharding.linear(x, table.to(x.dtype).T)
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
# Training forward and loss
# ---------------------------------------------------------------------------

def forward_train(params: LM, cfg: ModelConfig, tokens, extra_embeds=None):
    """tokens [B,S] (+ optional frontend embeds [B,F,D]) → (logits
    [B,S(+F),V], aux loss).  ``extra_embeds``: a VLM's patch embeddings
    (prepended) or whisper's frame embeddings (the encoder's input)."""
    check_supported(cfg, "train")
    x = embed_tokens(params, cfg, tokens)
    if extra_embeds is not None:
        extra_embeds = torch.as_tensor(extra_embeds, device=x.device)
    if cfg.is_enc_dec:
        if extra_embeds is None:
            raise ValueError(f"{cfg.name}: the encoder needs its frames "
                             f"(extra_embeds)")
        enc_out = _encode(params, cfg, extra_embeds)
        S = x.shape[1]
        x = x + sinusoidal_positions(S, cfg.d_model,
                                     x.device).to(x.dtype)[None]
        positions = torch.arange(S, device=x.device)[None, :]
        x, aux = _run_blocks_with_cross(params, cfg, x, positions, enc_out,
                                        "train")
    else:
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, aux = _run_blocks(params, cfg, x, positions, "train")
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    return unembed(params, cfg, x), aux


def lm_loss(logits, labels, z_loss: float = 1e-4):
    """Masked cross entropy plus ``z_loss`` · lse², in fp32, over the
    positions whose label is >= 0, with the row max held out of the
    gradient as JAX's ``stop_gradient``.  The label's logit is picked by
    a select over the vocabulary, as JAX's iota-select (exact either way;
    the select has no scatter in its backward, so it is deterministic on
    the card); a label past the vocabulary picks 0, as there."""
    mask = (labels >= 0).float()
    labels = labels.clamp(min=0)
    lf = logits.float()
    # on a mesh (vocabulary-sharded logits) the row max is reduced here,
    # a partial max, before it meets the partial sums below
    m = activation_sharding.without(lf.amax(dim=-1, keepdim=True).detach())
    shifted = lf - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    vocab = torch.arange(lf.shape[-1], device=lf.device)
    picked = torch.where(vocab == labels[..., None], shifted,
                         0.0).sum(dim=-1)
    ll = picked + m[..., 0]
    ce = (lse - ll) * mask
    zl = z_loss * torch.square(lse) * mask
    denom = mask.sum().clamp(min=1.0)
    return (ce.sum() + zl.sum()) / denom


def loss_fn(params: LM, cfg: ModelConfig, batch):
    """batch: {"tokens": [B,S], "labels": [B,S], optional "frames" or
    "patches"} (tensors on the model's device) → (loss, {"ce", "aux"}).
    A VLM's logits are cut to the text positions; an MoE config adds
    ``aux_loss_weight`` · aux."""
    extra = batch.get("frames", batch.get("patches"))
    logits, aux = forward_train(params, cfg, batch["tokens"],
                                extra_embeds=extra)
    if extra is not None and not cfg.is_enc_dec:
        logits = logits[:, extra.shape[1]:]
    loss = lm_loss(logits, batch["labels"])
    if cfg.moe.n_experts:
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Caches: init / prefill / decode
# ---------------------------------------------------------------------------

def _cache_entry_shapes(cfg: ModelConfig, kind: str, batch: int,
                        max_seq: int) -> dict:
    if kind == "attn":
        # sliding-window archs only keep a window-sized ring slab
        T = min(max_seq, cfg.window) if cfg.window else max_seq
        ent = ((batch, T, cfg.n_kv_heads, cfg.resolved_head_dim),
               COMPUTE_DTYPE, ("dp", "sp", "tp", None))
        return {"k": ent, "v": ent}
    if kind == "rglru":
        w = cfg.rglru.lru_width or cfg.d_model
        return {"h": ((batch, w), torch.float32, ("dp", "tp")),
                "conv": ((batch, cfg.rglru.conv_width - 1, w),
                         COMPUTE_DTYPE, ("dp", None, "tp"))}
    d_inner, H, N = ssm_mod.ssm_dims(cfg)
    return {"h": ((batch, H, cfg.ssm.head_dim, N), torch.float32,
                  ("dp", "tp", None, None)),
            "conv": ((batch, cfg.ssm.conv_width - 1, d_inner + 2 * N),
                     COMPUTE_DTYPE, ("dp", None, "tp"))}


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> List[dict]:
    """Per layer ``{name: (shape, dtype, logical spec)}`` by the layer's
    kind (module docstring), with the cross-attention K/V of an
    encoder-decoder; each spec is JAX's (a stacked leaf's without its
    leading None)."""
    check_supported(cfg)
    out = [_cache_entry_shapes(cfg, kind, batch, max_seq)
           for kind in layer_kinds(cfg)]
    if cfg.is_enc_dec:
        ent = ((batch, cfg.n_enc_ctx, cfg.n_kv_heads,
                cfg.resolved_head_dim), COMPUTE_DTYPE,
               ("dp", None, "tp", None))
        for layer in out:
            layer.update(cross_k=ent, cross_v=ent)
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> List[dict]:
    """Per layer ``{name: logical spec}`` of ``cache_shapes``."""
    return [{n: t[2] for n, t in layer.items()}
            for layer in cache_shapes(cfg, batch, max_seq)]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> List[dict]:
    dev = resolve(device)
    return [{n: torch.zeros(s, dtype=dt, device=dev)
             for n, (s, dt, _) in layer.items()}
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


# ---------------------------------------------------------------------------
# Remat policy
# ---------------------------------------------------------------------------

# the products JAX's dots_with_no_batch_dims_saveable keeps: a projection
# ([B,S,D] @ [D,N] reaches the dispatcher as aten.mm); batched products
# (aten.bmm: attention, the MoE experts) are recomputed
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default,
                         torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat`` (module docstring).  The backward
    recomputes through the model's weights as they are then, so it must
    run while the train step's copy is in place (``train_loop`` takes
    the gradients inside ``functional_call``)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat != "dots":
        raise ValueError(f"remat {cfg.remat!r}: not none|dots|full")
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _dots_policy))


def _run_blocks(params: LM, cfg: ModelConfig, x, positions, mode: str,
                cache=None, pos=None):
    """The layers in order: the superblocks (one period of the pattern;
    the "block" hook at each one's start and, in training, ``cfg.remat``
    over each), then the remainder blocks; each serving block writes its
    cache entry.  Returns (x, aux loss: the sum of the blocks', 0.0 with
    no MoE block)."""
    period = len(_pattern(cfg))
    n_scanned = cfg.n_layers // period * period

    def run(x, aux, first, last):
        for i in range(first, last):
            x, fresh, a = apply_block(
                params.layers[i], cfg, x, positions, mode,
                cache=cache[i] if mode == "decode" else None, pos=pos)
            aux = aux + a
            if fresh is not None:
                _store(cache[i], fresh, mode)
        return x, aux

    aux = 0.0
    for first in range(0, n_scanned, period):
        x = activation_sharding.constrain(x)
        body = functools.partial(run, first=first, last=first + period)
        if mode == "train":
            body = _maybe_remat(body, cfg)
        x, aux = body(x, aux)
    return run(x, aux, n_scanned, cfg.n_layers)


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
                           enc_out, mode: str, cache=None, pos=None):
    """Whisper decoder: each layer's self-attention block, then its cross
    attention against the encoder's K/V (computed from ``enc_out`` in
    training and prefill, where prefill keeps them in the cache; read
    from it in decode).  In training each layer runs under ``cfg.remat``,
    its cross K/V outside it, as JAX's.  Returns (x, aux loss)."""
    def layer(x, aux, i, ck, cv):
        x, fresh, a = apply_block(
            params.layers[i], cfg, x, positions, mode,
            cache=cache[i] if mode == "decode" else None, pos=pos)
        if mode == "prefill":
            fresh.update(cross_k=ck, cross_v=cv)
        if fresh is not None:
            _store(cache[i], fresh, mode)
        cp = params.cross[i]
        h = apply_norm(cfg.norm_type, cp.norm, x, cfg.norm_eps)
        return x + attn_mod.cross_attend(cp.attn, cfg, h, ck, cv), aux + a

    body = _maybe_remat(layer, cfg) if mode == "train" else layer
    aux = 0.0
    for i, cp in enumerate(params.cross):
        if mode == "decode":
            ck, cv = cache[i]["cross_k"], cache[i]["cross_v"]
        else:
            ck, cv = attn_mod.cross_kv(cp.attn, cfg, enc_out)
        x, aux = body(x, aux, i, ck, cv)
    return x, aux


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
        x, _ = _run_blocks_with_cross(params, cfg, x, positions, enc_out,
                                      "prefill", cache)
    else:
        x, _ = _run_blocks(params, cfg, x, positions, "prefill", cache)
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
        x, _ = _run_blocks_with_cross(params, cfg, x, positions, None,
                                      "decode", cache, pos)
    else:
        x, _ = _run_blocks(params, cfg, x, positions, "decode", cache, pos)
    logits = unembed(params, cfg, x)
    return logits[:, 0], cache
