"""Whisper-base  [arXiv:2212.04356].

Enc-dec: 6+6L d_model=512 8H (MHA) d_ff=2048 vocab=51865, GELU MLP,
LayerNorm. Conv audio frontend is a STUB — input_specs() provides
precomputed frame embeddings [B, 1500, 512].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    is_enc_dec=True,
    n_enc_layers=6,
    n_enc_ctx=1500,
    frontend="audio_stub",
    notes="decode_32k lowered shape-faithfully with sinusoidal positions "
          "(real whisper caps decoder at 448 positions); long_500k skipped.",
)
