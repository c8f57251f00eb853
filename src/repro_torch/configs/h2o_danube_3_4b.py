"""H2O-Danube-3-4B  [arXiv:2401.16818].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000; llama+mistral mix
with sliding-window attention (window 4096 — mistral default; the assignment
does not pin a window).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    attn_type="swa",
    window=4096,
    rope_theta=10000.0,
    mlp_type="swiglu",
    notes="SWA(4096) → sub-quadratic; long_500k cell runs with windowed KV.",
)
