"""Granite-MoE-3B-A800M  [hf:ibm-granite family].

32L d_model=1536 24H (GQA kv=8) vocab=49155; MoE top-8, per-expert d_ff=512.
Assignment lists "MoE 40e top-8" in the structured field and "32 experts" in
the free text; we follow the structured field (40 experts — matches the 3b
granite MoE). Discrepancy noted here per instructions.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    rope_theta=10000.0,
    mlp_type="swiglu",
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512, dispatch="gather",
              pad_experts_to=48),  # §Perf: EP divides tp=16
    tie_embeddings=True,           # granite ties embeddings
    notes="40e top-8 (structured field; free text said 32e).",
)
