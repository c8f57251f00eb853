"""Qwen1.5-32B  [hf:Qwen family].

64L d_model=5120 40H (MHA: kv=40) d_ff=27392 vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_type="swiglu",
    notes="MHA with QKV bias (qwen1.5 signature).",
)
