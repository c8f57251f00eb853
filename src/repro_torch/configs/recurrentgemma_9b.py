"""RecurrentGemma-9B (Griffin)  [arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; RG-LRU + local
attention in a 2:1 pattern (R,R,A); lru_width=d_model; local window 2048.
38 = 12×(R,R,A) + (R,R) remainder.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    attn_type="swa",
    window=2048,
    rope_theta=10000.0,
    mlp_type="swiglu",
    block_pattern=("rglru", "rglru", "attn"),
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, window=2048),
    tie_embeddings=True,
    scale_emb=64.0,                # gemma-style sqrt(d_model) emb scaling
    notes="hybrid: RG-LRU blocks carry fixed-size state (no KV paging); "
          "local-attn blocks use windowed KV. Sub-quadratic → long_500k runs.",
)
