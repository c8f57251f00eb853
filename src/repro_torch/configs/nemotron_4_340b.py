"""Nemotron-4-340B  [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000, squared-ReLU MLP,
no gating (2-matrix FFN). The heaviest assigned architecture.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    rope_theta=10000.0,
    mlp_type="squared_relu",
    notes="squared-ReLU FFN; GQA kv=8; 340B params.",
)
