"""Model / run configuration system.

Every assigned architecture is expressed as a ``ModelConfig``. Configs are
plain frozen dataclasses so they can be hashed into jit static args and
serialized into checkpoints. ``reduced()`` derives the CPU-smoke-test version
of the same family (small widths/depths, same code paths).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff: int = 0                  # per-expert intermediate size
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    capacity_factor: float = 1.25  # used by dropping dispatch path
    dispatch: str = "dense"        # "dense" (einsum masked) | "gather" (cumsum capacity)
    pad_experts_to: int = 0        # round E up so EP divides tp (§Perf)
    ep_shard: bool = True          # False: replicate expert weights (small-
                                   # expert archs; zero MoE collectives)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 0
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64
    conv_width: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0             # recurrence width (defaults to d_model)
    conv_width: int = 4
    c: float = 8.0                 # RG-LRU gating exponent constant
    window: int = 2048             # local-attention window of hybrid blocks


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- attention ---
    attn_type: str = "full"        # full | swa
    window: int = 0                # swa window (tokens)
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    # --- mlp ---
    mlp_type: str = "swiglu"       # swiglu | squared_relu | gelu
    # --- norm / embedding ---
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- subconfigs ---
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    rglru: RGLRUConfig = field(default_factory=RGLRUConfig)
    # hybrid layout: pattern of block kinds, tiled to n_layers
    block_pattern: Tuple[str, ...] = ("attn",)
    # --- encoder/decoder (whisper) ---
    is_enc_dec: bool = False
    n_enc_layers: int = 0
    n_enc_ctx: int = 0             # encoder sequence length (frames)
    # --- modality frontend stubs ---
    frontend: str = "none"         # none | audio_stub | vit_stub
    n_frontend_tokens: int = 0     # tokens contributed by the frontend (vlm)
    # --- muP-ish scalings (minicpm) ---
    scale_emb: float = 1.0
    scale_depth: float = 0.0       # 0 = disabled; else residual *= scale_depth/sqrt(2L)
    dim_model_base: int = 0        # 0 = disabled; else logits /= d_model/dim_model_base
    # --- runtime knobs (overridable per run) ---
    max_seq: int = 4096
    remat: str = "dots"            # none | dots | full
    scan_layers: bool = True
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding table padded to 256 so vocab shards over tp=16 cleanly
        (padded logits are masked in unembed/loss)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs only (ssm / hybrid / swa)."""
        return self.family in ("ssm", "hybrid") or self.attn_type == "swa"

    @property
    def has_decode_step(self) -> bool:
        return True  # all assigned archs are (or contain) decoders

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.mlp_type == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.moe.n_experts:
            moe_ff = self.moe.d_ff or ff
            mlp = self.moe.n_experts * 3 * d * moe_ff + d * self.moe.n_experts
        per_kind = {"attn": attn + mlp, "rglru": 0, "ssm": 0}
        if "rglru" in self.block_pattern:
            w = self.rglru.lru_width or d
            per_kind["rglru"] = 2 * d * w + w * d + 3 * w + mlp
        if self.family == "ssm":
            d_in = self.ssm.expand * d
            per_kind["ssm"] = d * (2 * d_in + 2 * self.ssm.d_state) + d_in * d
        total = 0
        pat = self.block_pattern
        for i in range(self.n_layers):
            total += per_kind.get(pat[i % len(pat)], attn + mlp)
        total += V * d * (1 if self.tie_embeddings else 2)
        if self.is_enc_dec:
            total += self.n_enc_layers * (attn + mlp) + self.n_layers * attn  # cross-attn
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if not self.moe.n_experts:
            return self.n_params()
        d = self.d_model
        moe_ff = self.moe.d_ff or self.d_ff
        dense_total = self.n_params()
        all_experts = self.n_layers * self.moe.n_experts * 3 * d * moe_ff
        active = self.n_layers * self.moe.top_k * 3 * d * moe_ff
        return dense_total - all_experts + active

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: same family/code paths, tiny dims."""
        kw = dict(
            n_layers=min(self.n_layers, 2 * max(1, len(self.block_pattern))),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(1, self.n_heads))),
            d_ff=128,
            vocab_size=256,
            head_dim=16 if self.head_dim else 0,
            max_seq=64,
            window=min(self.window, 32) if self.window else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_enc_ctx=min(self.n_enc_ctx, 16) if self.n_enc_ctx else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 8) if self.n_frontend_tokens else 0,
            remat="none",
        )
        if self.moe.n_experts:
            kw["moe"] = dataclasses.replace(self.moe, n_experts=8, top_k=2, d_ff=32)
        if self.ssm.d_state:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk=16)
        if self.rglru.lru_width:
            kw["rglru"] = dataclasses.replace(self.rglru, lru_width=64, window=16)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shape sets (assigned to every LM arch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Return (applicable, reason_if_not) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k decode is quadratic (skip per spec)"
    if cfg.is_enc_dec and shape.name == "long_500k":
        return False, "enc-dec decoder positional range << 500k"
    return True, ""
