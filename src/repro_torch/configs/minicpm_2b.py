"""MiniCPM-2B  [arXiv:2404.06395].

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753, llama-like with
muP-style scalings (scale_emb=12, scale_depth=1.4, dim_model_base=256) and a
WSD (warmup-stable-decay) schedule — wired into repro.optim.schedule.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    rope_theta=10000.0,
    mlp_type="swiglu",
    tie_embeddings=True,
    scale_emb=12.0,
    scale_depth=1.4,
    dim_model_base=256,
    notes="muP scalings active; trained with WSD schedule.",
)
