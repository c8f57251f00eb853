"""Analytic (napkin-math) compute & memory models for the roofline, as
the JAX package's ``repro.launch.analytic`` (the same arithmetic on the
same config).

The dry run takes its compute and memory terms from this model (standard
6·N·D accounting + attention/KV terms, with a remat multiplier), matching
what the deployed system executes (flash-attention kernels: no S² HBM
traffic), and its collective term from the collectives the traced step
issued (``roofline.CollectiveCounter``).  The traced FLOPs are kept beside
``exec_flops`` as a check.

Formulas (per step, GLOBAL):
  train   : exec_flops = 3·(2·N·T + A_fwd)·r      (fwd+bwd, r = remat factor)
  prefill : exec_flops = 2·N·T + A_fwd
  decode  : exec_flops = 2·N·B + A_dec
  A_fwd   = Σ_attn_layers 4·B·S·W_eff·H·hd        (W_eff = min(S, window)/2
            causal, or S/2 full)
  A_dec   = Σ_attn_layers 4·B·T_cache·KV_... (score+AV reads ≈ 4·B·T·H·hd)

  train HBM bytes   = 3·P_b (read fwd/bwd + opt rw) + 2·P_b(m,v rw)·2
                      + act_bytes (saved layer inputs, rw)
  prefill HBM bytes = P_b + KV_write + act_stream
  decode HBM bytes  = P_b + KV_read (the classic decode bound)
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _attn_layers(cfg: ModelConfig) -> int:
    pat = cfg.block_pattern or ("attn",)
    n_super = cfg.n_layers // len(pat)
    n = sum(1 for k in pat if k == "attn") * n_super
    n += sum(1 for i, k in enumerate(pat[:cfg.n_layers - n_super * len(pat)])
             if k == "attn")
    if cfg.is_enc_dec:
        n += cfg.n_enc_layers + cfg.n_layers  # enc self + dec cross
    return n


def param_bytes(cfg: ModelConfig, dtype_bytes: int) -> float:
    return cfg.n_params() * dtype_bytes


def exec_flops(cfg: ModelConfig, shape: ShapeConfig, mode: str,
               remat: str = "dots") -> float:
    N = cfg.n_active_params() if cfg.moe.n_experts else cfg.n_params()
    H, hd = max(cfg.n_heads, 1), cfg.resolved_head_dim
    L_attn = _attn_layers(cfg)
    B, S = shape.global_batch, shape.seq_len
    if mode in ("train", "prefill"):
        W_eff = (min(S, cfg.window) if cfg.window else S) / 2
        a_fwd = L_attn * 4.0 * B * S * W_eff * H * hd
        fwd = 2.0 * N * B * S + a_fwd
        if mode == "prefill":
            return fwd
        r = {"none": 1.0, "dots": 1.05, "full": 4.0 / 3.0}.get(remat, 1.05)
        return 3.0 * fwd * r
    # decode
    T_eff = min(S, cfg.window) if cfg.window else S
    a_dec = L_attn * 4.0 * B * T_eff * H * hd
    return 2.0 * N * B + a_dec


def useful_flops(cfg: ModelConfig, shape: ShapeConfig, mode: str) -> float:
    N = cfg.n_active_params() if cfg.moe.n_experts else cfg.n_params()
    if mode == "train":
        return 6.0 * N * shape.global_batch * shape.seq_len
    if mode == "prefill":
        return 2.0 * N * shape.global_batch * shape.seq_len
    return 2.0 * N * shape.global_batch


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig,
                   dtype_bytes: int = 2) -> float:
    T_eff = min(shape.seq_len, cfg.window) if cfg.window else shape.seq_len
    kv = (_attn_layers(cfg) * shape.global_batch * T_eff *
          max(cfg.n_kv_heads, 1) * cfg.resolved_head_dim * 2 * dtype_bytes)
    if cfg.family == "ssm":
        d_inner = cfg.ssm.expand * cfg.d_model
        hs = cfg.n_layers * shape.global_batch * \
            (d_inner // cfg.ssm.head_dim) * cfg.ssm.head_dim * \
            cfg.ssm.d_state * 4
        kv += hs
    if "rglru" in (cfg.block_pattern or ()):
        w = cfg.rglru.lru_width or cfg.d_model
        kv += cfg.n_layers * shape.global_batch * w * 4
    return kv


def hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, mode: str,
              param_dtype_bytes: int = 4) -> float:
    P_b = param_bytes(cfg, param_dtype_bytes)
    B, S = shape.global_batch, shape.seq_len
    act_unit = B * S * cfg.d_model * 2          # one layer activation, bf16
    if mode == "train":
        # params: fwd read + bwd read + grad write + opt read/write m,v,p
        p_traffic = P_b * (2 + 1) + P_b * 2 * 2 + P_b
        acts = cfg.n_layers * act_unit * 2 * 2  # save w + read r (fwd+bwd)
        logits = B * S * cfg.padded_vocab * 2 * 2
        return p_traffic + acts + logits
    if mode == "prefill":
        return P_b / 2 + kv_cache_bytes(cfg, shape) + \
            cfg.n_layers * act_unit * 2
    # decode: read every param + the whole KV cache once per token
    return P_b / 2 * (2 / param_dtype_bytes) + kv_cache_bytes(cfg, shape)
