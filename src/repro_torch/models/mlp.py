"""Feed-forward blocks: SwiGLU (llama/qwen), squared-ReLU (nemotron-4),
GELU (whisper; tanh approximation, ``jax.nn.gelu``'s default)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.layers import dense_init, param, squared_relu


class MLP(nn.Module):
    """``w_gate`` (SwiGLU only) and ``w_up`` [d, ff], ``w_down`` [ff, d]."""

    def __init__(self, cfg: ModelConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve(device)
        d, ff = cfg.d_model, cfg.d_ff
        names = (("w_gate", d, ff), ("w_up", d, ff), ("w_down", ff, d)) \
            if cfg.mlp_type == "swiglu" else (("w_up", d, ff),
                                              ("w_down", ff, d))
        for name, d_in, d_out in names:
            setattr(self, name, param(dense_init(generator, d_in, d_out,
                                                 dtype, device=device)))


def apply_mlp(p: MLP, cfg: ModelConfig, x):
    if cfg.mlp_type == "swiglu":
        g = torch.matmul(x, p.w_gate.to(x.dtype))
        u = torch.matmul(x, p.w_up.to(x.dtype))
        h = F.silu(g) * u
    else:
        h = torch.matmul(x, p.w_up.to(x.dtype))
        h = squared_relu(h) if cfg.mlp_type == "squared_relu" else \
            F.gelu(h, approximate="tanh")
    return torch.matmul(h, p.w_down.to(x.dtype))
