"""Foundational layers: norms, RoPE, activations and seeded initialisers.

The JAX package keeps a logical sharding spec beside every weight; the
port holds plain tensors (sharding waits for the multi-GPU slice).  Every
function and module here that makes a tensor takes ``device=None``, which
is ``cuda`` (``repro_torch.device.resolve``); the CPU is used only when
it is asked for.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def param(x: torch.Tensor) -> nn.Parameter:
    """A weight: serving only, so no gradient."""
    return nn.Parameter(x, requires_grad=False)


def _truncated_normal(shape, scale, generator, device, dtype):
    """Normal truncated to [-2, 2], times ``scale``, drawn in fp32 from
    ``generator``.  With no generator, or on the meta device, the tensor
    is left uninitialised (weights that are loaded afterwards)."""
    device = resolve(device)
    if generator is None or device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * scale).to(dtype)


def dense_init(generator, d_in: int, d_out, dtype=torch.float32,
               scale=None, device=None) -> torch.Tensor:
    """Fan-in scaled init for a [d_in, *d_out] projection."""
    shape = (d_in,) + (d_out if isinstance(d_out, tuple) else (d_out,))
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _truncated_normal(shape, scale, generator, device, dtype)


def embed_init(generator, vocab: int, d: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return _truncated_normal((vocab, d), 1.0, generator, device, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, weight, eps: float = 1e-6):
    """``weight`` stores (scale - 1), so zeros are the identity; computed
    in fp32, returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def layernorm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


class Norm(nn.Module):
    """fp32 norm weights: ``w`` (rmsnorm: scale - 1) and, for layernorm,
    ``b``."""

    def __init__(self, norm_type: str, d: int, device=None):
        super().__init__()
        device = resolve(device)
        self.norm_type = norm_type
        if norm_type == "rmsnorm":
            self.w = param(torch.zeros(d, device=device))
        else:
            self.w = param(torch.ones(d, device=device))
            self.b = param(torch.zeros(d, device=device))


def init_norm(norm_type: str, d: int, device=None) -> Norm:
    return Norm(norm_type, d, device)


def apply_norm(norm_type: str, p: Norm, x, eps: float):
    if norm_type == "rmsnorm":
        return rmsnorm(x, p.w, eps)
    return layernorm(x, p.w, p.b, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=resolve(device)) /
                            head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  Split
    halves, fp32 angles, returned in x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)             # [hd/2]
    angles = positions[..., None].float() * freqs       # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]               # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_ctx: int, d: int, device=None):
    """Whisper-style fixed sinusoidal embeddings [n_ctx, d]."""
    device = resolve(device)
    pos = torch.arange(n_ctx, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-math.log(10000.0) *
                    torch.arange(d // 2, dtype=torch.float32, device=device)
                    / max(d // 2 - 1, 1))
    ang = pos * div[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def squared_relu(x):
    r = F.relu(x)
    return r * r


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x
