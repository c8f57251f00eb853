"""Mamba2-130M  [arXiv:2405.21060].

24L d_model=768, attention-free SSD blocks, vocab=50280, ssm_state=128,
expand=2 (d_inner=1536), head_dim=64 → 24 SSD heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,            # unused (attention-free); kept valid for shared code
    n_kv_heads=12,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk=64, conv_width=4),
    tie_embeddings=True,
    norm_type="rmsnorm",
    notes="attention-free: paper's paged-KV technique inapplicable "
          "(DESIGN.md §Arch-applicability); constant-size SSD state instead.",
)
