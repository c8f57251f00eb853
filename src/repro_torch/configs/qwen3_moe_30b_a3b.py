"""Qwen3-MoE-30B-A3B  [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) vocab=151936; MoE 128 experts top-8,
per-expert d_ff=768. Qwen3 uses explicit head_dim=128 and q/k RMSNorm.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                      # per-expert intermediate
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_type="swiglu",
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768, dispatch="gather"),
    tie_embeddings=False,
    notes="128e top-8 MoE; qk-norm; head_dim 128 per HF config.",
)
