"""Mixture-of-Experts block (qwen3-moe, granite-moe), serving path.

Dispatch paths, as in the JAX package:

* ``dense``  — every expert computes every token, masked combine (tiny
  configs only).
* ``gather`` — capacity-bounded cumsum dispatch (GShard semantics, no
  argsort): tokens are grouped (one group per batch row unless
  ``n_groups``); a running per-expert count gives each (token, k)
  assignment a capacity slot; an assignment past capacity drops.

Three choices keep the gather path equal to JAX's and deterministic on
the card:

* the top-k is a stable descending sort, so ties keep JAX's
  lower-index-first order (``torch.topk`` does not), and the order of
  the k picks is part of the capacity ranks;
* kept rows reach the dispatch buffer by a gather from a slot → token map
  with one writer a slot, and all groups run as one batched product a
  matrix, ``[E, G*C, d] @ [E, d, ff]`` (each expert's weights read once);
* the combine is k adds in k order in the compute dtype, which equals
  JAX's ``zeros.at[token].add(contrib)`` bit for bit and uses no atomics.

Expert weights are held in the compute dtype (bf16), bit-identical to
JAX's fp32 masters cast at every use in the gather path; the router stays
fp32.  ``pad_experts_to`` rounds E up (granite: 40 → 48); padded experts
are masked out of routing and receive no tokens, and the capacity divides
by the real expert count.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.activation_sharding import (is_dtensor, linear,
                                                    replicated, without)
from repro_torch.models.layers import _truncated_normal, dense_init, param

NEG_INF = -1e30


def _padded_experts(cfg: ModelConfig) -> int:
    return max(cfg.moe.n_experts, cfg.moe.pad_experts_to)


def param_specs(cfg: ModelConfig) -> dict:
    """JAX's logical spec of each ``MoE`` leaf (``init_moe``): experts on
    tp when ``ep_shard``, else replicated."""
    e_ax = "tp" if cfg.moe.ep_shard else None
    return {"router": (None, None), "w_gate": (e_ax, None, None),
            "w_up": (e_ax, None, None), "w_down": (e_ax, None, None)}


class MoE(nn.Module):
    """``router`` [d, E] (fp32), ``w_gate``/``w_up`` [E, d, ff] and
    ``w_down`` [E, ff, d] in ``dtype``; E = ``_padded_experts(cfg)``."""

    def __init__(self, cfg: ModelConfig, generator=None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve(device)
        d, E = cfg.d_model, _padded_experts(cfg)
        ff = cfg.moe.d_ff or cfg.d_ff
        self.router = param(dense_init(generator, d, E, torch.float32,
                                       scale=0.02, device=device))
        for name, shape, scale in (("w_gate", (E, d, ff), d ** -0.5),
                                   ("w_up", (E, d, ff), d ** -0.5),
                                   ("w_down", (E, ff, d), ff ** -0.5)):
            setattr(self, name, param(_truncated_normal(
                shape, scale, generator, device, dtype)))


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def router_logits(p: MoE, cfg: ModelConfig, x):
    """x [..., d] → fp32 logits [..., E], padded experts at -1e30."""
    logits = linear(x.float(), p.router.float())
    E = logits.shape[-1]
    if E != cfg.moe.n_experts:   # mask padded experts out of routing
        emask = torch.arange(E, device=x.device) < cfg.moe.n_experts
        logits = torch.where(emask, logits, NEG_INF)
    return logits


def route_logits(cfg: ModelConfig, logits, dtype):
    """fp32 logits [..., E] → (gates [..., k] in ``dtype``, experts
    [..., k], aux loss scalar)."""
    E_real, k = cfg.moe.n_experts, cfg.moe.top_k
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: on ties the lower index first, as
    # jax.lax.top_k
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[..., :k], experts[..., :k]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)  # norm_topk_prob
    # Switch-style load-balance aux loss: E·mean_e(frac_tokens_e·mean_prob_e)
    # assignments per expert (whole numbers: exact in any order of the
    # adds; no host sync, as bincount would make on the card)
    flat = experts.reshape(-1)
    count = torch.zeros(E, device=probs.device).scatter_add_(
        0, flat, torch.ones(flat.shape, device=probs.device))
    frac = count / (probs.numel() // E) / k
    mp = torch.mean(probs.reshape(-1, E), dim=0)
    aux = E_real * torch.sum(frac * mp)
    return gates.to(dtype), experts, aux


def _route(p: MoE, cfg: ModelConfig, x):
    """x: [..., d] → (gates [..., k], experts [..., k], aux_loss scalar).
    On a mesh the routing runs on the full logits (``replicated``)."""
    return replicated(lambda lg: route_logits(cfg, lg, x.dtype),
                      router_logits(p, cfg, x))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def capacity(cfg: ModelConfig, T: int) -> int:
    """Capacity slots per expert and group of T tokens; divides by the
    real expert count (granite: 40, not the padded 48)."""
    return int(max(1, (T * cfg.moe.top_k * cfg.moe.capacity_factor) //
                   max(cfg.moe.n_experts, 1)))


def dispatch(experts, E: int, C: int):
    """experts [G, T, k] → (rank, keep), each [G, T*k]: the rank of each
    assignment among the earlier ones to its expert in flat (token, k)
    order within its group, and whether it fits in capacity C."""
    G = experts.shape[0]
    flat_e = experts.reshape(G, 1, -1)
    # one-hot [G, E, T*k], so that the running count is a scan along the
    # innermost dimension (along an outer one, the card scans each
    # expert's column serially)
    counts = torch.zeros((G, E, flat_e.shape[-1]), dtype=torch.int32,
                         device=experts.device)
    counts.scatter_(1, flat_e, 1)
    counts.cumsum_(dim=2)
    rank = counts.gather(1, flat_e)[:, 0] - 1
    del counts
    return rank, rank < C


def _dense_moe(x, gates, experts, w_gate, w_up, w_down):
    """All-experts einsum path (smoke configs)."""
    E = w_gate.shape[0]
    xf = x.float()
    g = torch.einsum("...d,edf->...ef", xf, w_gate.float())
    u = torch.einsum("...d,edf->...ef", xf, w_up.float())
    h = F.silu(g) * u
    y_all = torch.einsum("...ef,efd->...ed", h, w_down.float())
    onehot = F.one_hot(experts, E).float()                      # [...,k,E]
    w = torch.einsum("...k,...ke->...e", gates.float(), onehot)
    return torch.einsum("...ed,...e->...d", y_all, w).to(x.dtype)


def _slots(experts, E: int, C: int):
    """experts [G, T, k] → (rows [E*G*C]: the row of x [G*T, d] each
    dispatch slot reads, G*T for an empty one; slot [G, T, k]: the slot of
    each assignment, 0 for an overflow one; keep [G, T*k])."""
    G, T, k = experts.shape
    dev = experts.device
    rank, keep = dispatch(experts, E, C)
    flat_e = experts.reshape(G, T * k)
    grp = torch.arange(G, device=dev)[:, None]
    # slot of each kept assignment in the [E, G*C] buffer; an overflow
    # one writes the spare slot E*G*C, which is never read
    dst = torch.where(keep, flat_e * (G * C) + grp * C + rank, E * G * C)
    src = grp * T + torch.arange(T * k, device=dev) // k   # row of x
    # slot → row of x (G*T: the zero row), one writer per kept slot
    rows = torch.full((E * G * C + 1,), G * T, dtype=torch.long, device=dev)
    rows.scatter_(0, dst.reshape(-1), src.reshape(-1))
    # JAX reads an overflow assignment at slot 0, with gate 0
    slot = torch.where(keep, dst, 0).view(G, T, k)
    return rows[:-1], slot, keep


def _dispatch_rows(x, rows, E: int):
    """The [E, G*C, d] dispatch buffer: row ``rows[s]`` of x [G, T, d] in
    slot s (the zero row for G*T)."""
    G, T, d = x.shape
    xz = torch.cat([x.reshape(G * T, d), x.new_zeros((1, d))])
    return xz.index_select(0, rows).view(E, -1, d)


def _gather_moe(p: MoE, cfg: ModelConfig, x, gates, experts):
    """Cumsum capacity dispatch: x [G, T, d], gates/experts [G, T, k] →
    [G, T, d].  On a mesh the slot math, the dispatch gather and the
    combine run on full values (``replicated``); the expert products are
    DTensor ops on the expert weights' placements."""
    E = p.router.shape[-1]
    k = cfg.moe.top_k
    G, T, d = x.shape
    C = capacity(cfg, T)
    dt = x.dtype
    rows, slot, keep = replicated(lambda e: _slots(e, E, C), experts)
    xe = replicated(lambda xl, r: _dispatch_rows(xl, r, E), x, rows)
    del rows
    g = torch.bmm(xe, p.w_gate.to(dt))
    u = torch.bmm(xe, p.w_up.to(dt))
    del xe
    h = F.silu(g.float()).to(dt) * u
    del g, u
    ye = torch.bmm(h, p.w_down.to(dt)).view(E * G * C, d)
    del h
    w = (gates.reshape(G, T * k) * keep).to(dt).view(G, T, k)
    return replicated(combine, ye, slot, w)


def combine(ye, slot, w):
    """ye [N, d] expert outputs, slot and w [G, T, k] → [G, T, d]: each
    token's k contributions ``ye[slot] * w`` added in k order, from zero,
    in ye's dtype; equal to JAX's ``zeros.at[token].add(contrib)`` and
    free of atomics."""
    G, T, k = slot.shape
    y = ye.new_zeros((G, T, ye.shape[-1]))
    for j in range(k):
        y = y + ye.index_select(0, slot[:, :, j].reshape(-1)).view(
            G, T, -1) * w[:, :, j, None]
    return y


def apply_moe(p: MoE, cfg: ModelConfig, x, n_groups: int = 0):
    """x: [B,S,d] → ([B,S,d], aux loss)."""
    B, S, d = x.shape
    gates, experts, aux = _route(p, cfg, x)
    if cfg.moe.dispatch == "dense":
        y = replicated(_dense_moe, x, gates, experts, p.w_gate, p.w_up,
                       p.w_down)
    else:
        # group tokens: one group per batch row unless n_groups
        G = n_groups or max(1, B)
        xg = x.reshape(G, (B * S) // G, d)
        gg = gates.reshape(G, (B * S) // G, -1)
        eg = experts.reshape(G, (B * S) // G, -1)
        y = _gather_moe(p, cfg, xg, gg, eg).reshape(B, S, d)
    if is_dtensor(x):   # back to the tokens' placements
        y = y.redistribute(x.device_mesh, without(x).placements)
    return y, aux
