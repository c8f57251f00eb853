"""Mamba-2 SSD (state-space duality) block — arXiv:2405.21060.

Chunked SSD for prefill (quadratic within chunks, linear across), and a
constant-memory recurrent step for decode.  Single group (G=1) of B/C
shared across heads, scalar-per-head A — the mamba2-130m configuration.
JAX leaves both to XLA, so there is no TPU kernel to port; the
inter-chunk ``jax.lax.scan`` is a loop over the chunks here.

Shapes (prefill): x [B,S,D] → y [B,S,D]
State (decode):   h [B,H,P,N]  (H = ssm heads, P = head_dim, N = d_state)
                  conv [B,W-1,d_inner + 2N]

Weights: ``w_in``, ``w_out``, ``conv_w`` and ``conv_b`` in the compute
dtype (every JAX use casts them to it); ``A_log``, ``dt_bias``, ``D`` and
``norm_w`` in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.activation_sharding import linear, on_rows
from repro_torch.models.layers import _truncated_normal, dense_init, param
from repro_torch.models.rglru import _conv1d


def ssm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    n_heads = d_inner // cfg.ssm.head_dim
    return d_inner, n_heads, cfg.ssm.d_state


def param_specs(cfg: ModelConfig) -> dict:
    """JAX's logical spec of each ``SSM`` leaf (``init_ssm``)."""
    del cfg
    return {"w_in": ("fsdp", "tp"), "conv_w": (None, "tp"),
            "conv_b": ("tp",), "A_log": ("tp",), "dt_bias": ("tp",),
            "D": ("tp",), "norm_w": ("tp",), "w_out": ("tp", "fsdp")}


class SSM(nn.Module):
    """w_in [d, 2·d_inner + 2N + H], conv_w [W, d_inner + 2N], conv_b,
    w_out [d_inner, d] in ``dtype``; A_log, dt_bias, D [H] and norm_w
    [d_inner] in fp32."""

    def __init__(self, cfg: ModelConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve(device)
        d = cfg.d_model
        d_inner, H, N = ssm_dims(cfg)
        conv_ch = d_inner + 2 * N       # x, B, C all pass through the conv
        # in_proj → [z, x, B, C, dt]
        self.w_in = param(dense_init(generator, d, 2 * d_inner + 2 * N + H,
                                     dtype, device=device))
        self.conv_w = param(_truncated_normal((cfg.ssm.conv_width, conv_ch),
                                              0.3, generator, device, dtype))
        self.conv_b = param(torch.zeros(conv_ch, dtype=dtype, device=device))
        self.A_log = param(torch.log(torch.arange(
            1, H + 1, dtype=torch.float32, device=device)))
        # inverse softplus of dt spread over [dt_min, dt_max]
        self.dt_bias = param(torch.log(torch.exp(torch.linspace(
            cfg.ssm.dt_min, cfg.ssm.dt_max, H, device=device)) - 1.0))
        self.D = param(torch.ones(H, device=device))
        self.norm_w = param(torch.zeros(d_inner, device=device))
        self.w_out = param(dense_init(generator, d_inner, d, dtype,
                                      device=device))


def _split_proj(cfg: ModelConfig, zxbcdt):
    d_inner, H, N = ssm_dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)


def _causal_conv(xBC, w, b, state=None):
    """Depthwise causal conv, width W, then SiLU in fp32.  xBC [B,S,C];
    w [W,C].  Returns (y [B,S,C], new_state [B,W-1,C])."""
    y, new_state = _conv1d(xBC, w, b, state)
    return F.silu(y.float()).to(xBC.dtype), new_state


def _segsum(x):
    """x [..., L] → lower-triangular pairwise sums: out[..., i, j] =
    sum_{j<m<=i} x[m]; -inf above the diagonal."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, -torch.inf)


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int, h0=None):
    """Chunked SSD scan.

    x  [B,S,H,P]  inputs per head
    dt [B,S,H]    softplus'd timestep
    A  [H]        negative decay rate
    Bm [B,S,N], Cm [B,S,N]  (single group broadcast over heads)
    Returns (y [B,S,H,P], h_final [B,H,P,N]).

    JAX's 3- and 4-operand einsums are written as broadcast products and
    one batched matmul each, so nothing larger than [B,nc,H,L,L] or the
    per-chunk states [B,nc,H,P,N] is made."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S) if S % chunk else chunk
    pad = (-S) % L
    if pad:
        # zero-dt padding is a no-op on the recurrence (decay=1, input=0)
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // L
    xc = x.reshape(Bsz, nc, L, H, Pd)
    dtc = dt.reshape(Bsz, nc, L, H)
    Bc = Bm.reshape(Bsz, nc, L, N)
    Cc = Cm.reshape(Bsz, nc, L, N)

    dA = dtc * A                                       # [B,nc,L,H] (A<0)
    dA_cum = torch.cumsum(dA, dim=2)                   # within-chunk
    # 1) diagonal (intra-chunk) term: "bclm,bchlm,bcmh,bcmhp->bclhp"
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # [B,nc,H,L,L]
    scores = torch.matmul(Cc, Bc.transpose(-1, -2))    # [B,nc,L,L]
    w = scores[:, :, None] * Lmat * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.matmul(w, xc.permute(0, 1, 3, 2, 4))   # [B,nc,H,L,P]
    del w, Lmat
    # 2) chunk states: "bcln,bclh,bclhp->bchpn"
    decay_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # [B,nc,L,H]
    wx = (dtc * decay_end)[..., None] * xc                # [B,nc,L,H,P]
    states = torch.matmul(wx.permute(0, 1, 3, 4, 2),
                          Bc[:, :, None])                 # [B,nc,H,P,N]
    del wx
    # 3) inter-chunk recurrence h_c = h_{c-1} * exp(sum dA_c) + states_c
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])          # [B,nc,H]
    h = (x.new_zeros((Bsz, H, Pd, N)) if h0 is None else h0.to(x.dtype))
    h_prev = torch.empty_like(states)
    for c in range(nc):
        h_prev[:, c] = h
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    # 4) off-diagonal term, the prior state read at each position:
    #    "bcln,bchpn,bclh->bclhp"
    state_decay = torch.exp(dA_cum).permute(0, 1, 3, 2)[..., None]
    y_off = torch.matmul(Cc[:, :, None], h_prev.transpose(-1, -2)) \
        * state_decay                                     # [B,nc,H,L,P]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(Bsz, S + pad, H, Pd)
    y = y + D[None, None, :, None] * x
    return y[:, :S], h


def ssd_decode_step(x, dt, A, Bm, Cm, D, h):
    """Single-token recurrence.  x [B,H,P]; dt [B,H]; Bm, Cm [B,N];
    h [B,H,P,N] → (y [B,H,P], h)."""
    dA = torch.exp(dt * A)                                     # [B,H]
    dBx = (dt[:, :, None] * x)[..., None] * Bm[:, None, None, :]
    h = h * dA[..., None, None] + dBx
    y = torch.matmul(h, Cm[:, None, :, None])[..., 0] + D[None, :, None] * x
    return y, h


def apply_ssm(p: SSM, cfg: ModelConfig, x, h0=None, conv_state=None,
              decode: bool = False):
    """Full mamba2 block.  Prefill: x [B,S,D]; decode: x [B,1,D].

    Returns (y, (h [B,H,P,N] fp32, conv_state))."""
    d_inner, H, N = ssm_dims(cfg)
    Pd = cfg.ssm.head_dim
    zxbcdt = linear(x, p.w_in.to(x.dtype))
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    dt = F.softplus(dt.float() + p.dt_bias.float())            # [B,S,H]
    xBC, conv_state = _causal_conv(xBC, p.conv_w, p.conv_b, conv_state)
    xin, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    A = -torch.exp(p.A_log.float())                            # [H]
    Bsz, S = x.shape[0], x.shape[1]
    xh = xin.reshape(Bsz, S, H, Pd)
    # on a mesh, each device's batch rows (``on_rows``)
    if decode:
        y, h = on_rows(
            ssd_decode_step, xh[:, 0].float(), dt[:, 0], A,
            Bm[:, 0].float(), Cm[:, 0].float(), p.D.float(),
            (x.new_zeros((Bsz, H, Pd, N), dtype=torch.float32)
             if h0 is None else h0.float()))
        y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    else:
        y, h = on_rows(
            lambda x_, dt_, A_, B_, C_, D_, h_: ssd_chunked(
                x_, dt_, A_, B_, C_, D_, cfg.ssm.chunk, h0=h_),
            xh.float(), dt, A, Bm.float(), Cm.float(), p.D.float(), h0)
        y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.float()).to(x.dtype)
    dtp = y.dtype
    yf = y.float()
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    y = (yf * (1.0 + p.norm_w.float())).to(dtp)
    y = linear(y, p.w_out.to(x.dtype))
    return y, (h, conv_state)
