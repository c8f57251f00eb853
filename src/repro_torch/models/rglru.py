"""RG-LRU recurrent block (RecurrentGemma / Griffin — arXiv:2402.19427).

Block: x → {gate branch: GeLU(W_gate x)} ⊙ {main: conv1d → RG-LRU} → W_out.
RG-LRU recurrence (per channel):
    r_t = σ(W_a x_t + b_a)            recurrence gate
    i_t = σ(W_x x_t + b_x)            input gate
    a_t = exp(-c · r_t · softplus(Λ))
    h_t = a_t h_{t-1} + √(1 - a_t²) · (i_t ⊙ x_t)

Prefill runs the linear recurrence as a log-depth scan over the sequence
in fp32 (``linear_scan``; JAX's ``jax.lax.associative_scan``, which XLA
lowers, so there is no TPU kernel to port); decode is one step.  The
scan's sums come in another order than JAX's tree, which the CPU tests
hold within 1e-4 in fp32.

Weights: ``w_main``, ``w_gate``, ``w_out``, ``conv_w`` and ``conv_b`` in the
compute dtype (every JAX use casts them to it), ``wa``, ``wx``, ``ba``,
``bx`` and ``lam`` in fp32 (JAX computes the gates in fp32).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.activation_sharding import linear
from repro_torch.models.layers import _truncated_normal, dense_init, param


def param_specs(cfg: ModelConfig) -> dict:
    """JAX's logical spec of each ``RGLRU`` leaf (``init_rglru``)."""
    del cfg
    return {"w_main": ("fsdp", "tp"), "w_gate": ("fsdp", "tp"),
            "conv_w": (None, "tp"), "conv_b": ("tp",),
            "wa": ("tp", None), "ba": (None,), "wx": ("tp", None),
            "bx": (None,), "lam": ("tp",), "w_out": ("tp", "fsdp")}


class RGLRU(nn.Module):
    """w_main/w_gate [d,w], conv_w [W,w], conv_b [w], w_out [w,d] in
    ``dtype``; wa/wx [w,w], ba/bx/lam [w] in fp32."""

    def __init__(self, cfg: ModelConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve(device)
        d = cfg.d_model
        w = cfg.rglru.lru_width or d
        self.w_main = param(dense_init(generator, d, w, dtype, device=device))
        self.w_gate = param(dense_init(generator, d, w, dtype, device=device))
        self.conv_w = param(_truncated_normal((cfg.rglru.conv_width, w), 0.3,
                                              generator, device, dtype))
        self.conv_b = param(torch.zeros(w, dtype=dtype, device=device))
        self.wa = param(dense_init(generator, w, w, scale=1.0 / math.sqrt(w),
                                   device=device))
        self.ba = param(torch.zeros(w, device=device))
        self.wx = param(dense_init(generator, w, w, scale=1.0 / math.sqrt(w),
                                   device=device))
        self.bx = param(torch.zeros(w, device=device))
        # Λ so that a^c spans (0.9, 0.999): the standard Griffin init
        lam = torch.log(torch.expm1(-torch.log(torch.linspace(
            0.9, 0.999, w, device=device)) / cfg.rglru.c))
        self.lam = param(lam)
        self.w_out = param(dense_init(generator, w, d, dtype, device=device))


def _conv1d(x, w, b, state=None):
    """Depthwise causal conv of width W along dim 1 in x's dtype: x
    [B,S,C], w [W,C], b [C], state [B,W-1,C] (zeros if None) → (y,
    new_state = the last W-1 rows of [state, x])."""
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros(x.shape[:1] + (W - 1,) + x.shape[2:])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = 0
    for i in range(W):      # JAX's sum(): 0 + term 0 + term 1 + ...
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    return y + b.to(x.dtype), xp[:, xp.shape[1] - (W - 1):]


def _rglru_coeffs(p: RGLRU, cfg: ModelConfig, u):
    """u [B,S,w] → (a, b), fp32, of the recurrence h = a·h_prev + b."""
    uf = u.float()
    r = torch.sigmoid(uf @ p.wa.float() + p.ba.float())
    i = torch.sigmoid(uf @ p.wx.float() + p.bx.float())
    log_a = -cfg.rglru.c * r * F.softplus(p.lam.float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    return a, b


def linear_scan(a, b):
    """All prefixes of h_t = a_t·h_{t-1} + b_t (h_{-1} = 0) along dim 1:
    a Hillis–Steele scan, ceil(log2 S) rounds of the associative combine
    (a1, b1) ∘ (a2, b2) = (a1·a2, b1·a2 + b2) at distance 1, 2, 4, ..."""
    S, d = a.shape[1], 1
    while d < S:
        # each round is written out of place, so autograd can run
        # backward through it (an in-place round overwrites what the
        # previous round saved)
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], dim=1)
        if 2 * d < S:       # the last round needs no product of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def apply_rglru(p: RGLRU, cfg: ModelConfig, x, h0=None, conv_state=None,
                decode: bool = False):
    """x [B,S,D] → (y [B,S,D], (h [B,w] fp32, conv_state [B,W-1,w]))."""
    gate = F.gelu(linear(x, p.w_gate.to(x.dtype)).float(),
                  approximate="tanh")
    u = linear(x, p.w_main.to(x.dtype))
    u, conv_state = _conv1d(u, p.conv_w, p.conv_b, conv_state)
    a, b = _rglru_coeffs(p, cfg, u)
    if decode:
        h_prev = torch.zeros_like(b[:, 0]) if h0 is None else h0
        h = a[:, 0] * h_prev + b[:, 0]
        hs = h[:, None]
    else:
        if h0 is not None:  # fold the initial state into the first b
            b[:, 0] = b[:, 0] + a[:, 0] * h0
        hs = linear_scan(a, b)
        h = hs[:, -1]
    y = (hs * gate).to(x.dtype)
    y = linear(y, p.w_out.to(x.dtype))
    return y, (h, conv_state)
