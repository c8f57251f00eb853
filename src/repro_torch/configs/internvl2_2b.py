"""InternVL2-2B  [arXiv:2404.16821].

LM backbone (InternLM2-like): 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553. InternViT frontend is a STUB — input_specs() provides
precomputed patch embeddings [B, 256, 2048] prepended to the text sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    mlp_type="swiglu",
    frontend="vit_stub",
    n_frontend_tokens=256,
    notes="ViT frontend stubbed per assignment; loss over text positions.",
)
