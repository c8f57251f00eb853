"""Abstract parameter/input construction for the dry run, as the JAX
package's ``repro.launch.specs``.

``abstract_params`` builds the ``LM`` on the ``meta`` device (zero
allocation: nemotron's 340B parameters stay abstract) and returns each
parameter as a meta tensor, keyed as ``LM.named_parameters()``, beside
its logical spec (``transformer.logical_specs``).

The input builders give meta tensors of JAX's shapes and dtypes for every
model input of an (arch × shape × mode) cell, beside their logical specs
(tuples of logical axes, JAX's ``PartitionSpec``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.train_loop import opt_state_specs


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_params(cfg: ModelConfig, dtype=None
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """→ (meta tensors, logical specs), both keyed by parameter name.
    Every leaf is fp32, as JAX's ``init_lm`` makes it; ``dtype``
    overrides the floating ones (serving uses bf16)."""
    lm, specs = tf.init_lm(cfg, None, device="meta", dtype=torch.float32,
                           with_specs=True)
    shapes = {n: _sd(p.shape, dtype if dtype is not None
                     and p.dtype.is_floating_point else p.dtype)
              for n, p in lm.named_parameters()}
    return shapes, specs


def abstract_opt_state(param_shapes, param_specs, dtype=torch.float32):
    m = {k: _sd(s.shape, dtype) for k, s in param_shapes.items()}
    shapes = AdamWState(step=_sd((), torch.int32), m=m,
                        v={k: _sd(s.shape, dtype) for k, s in m.items()})
    return shapes, opt_state_specs(param_specs)


def train_inputs(cfg: ModelConfig, shape: ShapeConfig):
    """→ (batch meta tensors, batch logical specs)."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _sd((B, S), torch.int32),
             "labels": _sd((B, S), torch.int32)}
    specs = {"tokens": ("dp", None), "labels": ("dp", None)}
    if cfg.frontend == "vit_stub":
        batch["patches"] = _sd((B, cfg.n_frontend_tokens, cfg.d_model),
                               torch.bfloat16)
        specs["patches"] = ("dp", None, None)
    if cfg.frontend == "audio_stub":
        batch["frames"] = _sd((B, cfg.n_enc_ctx, cfg.d_model),
                              torch.bfloat16)
        specs["frames"] = ("dp", None, None)
    return batch, specs


def cache_abstract(cfg: ModelConfig, batch: int, max_seq: int):
    """→ (per-layer dicts of meta tensors, per-layer dicts of specs)."""
    shp = tf.cache_shapes(cfg, batch, max_seq)
    shapes = [{n: _sd(s, dt) for n, (s, dt, _) in layer.items()}
              for layer in shp]
    specs = [{n: t[2] for n, t in layer.items()} for layer in shp]
    return shapes, specs


def _extra(cfg: ModelConfig, B: int):
    if cfg.frontend == "vit_stub":
        return (_sd((B, cfg.n_frontend_tokens, cfg.d_model),
                    torch.bfloat16), ("dp", None, None))
    if cfg.frontend == "audio_stub":
        return (_sd((B, cfg.n_enc_ctx, cfg.d_model), torch.bfloat16),
                ("dp", None, None))
    return None, None


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    tokens = _sd((B, S), torch.int32)
    cache_shapes_, cache_specs_ = cache_abstract(cfg, B, S)
    extra, extra_specs = _extra(cfg, B)
    return ((tokens, cache_shapes_, extra),
            (("dp", None), cache_specs_, extra_specs))


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    token = _sd((B,), torch.int32)
    pos = _sd((B,), torch.int32)
    cache_shapes_, cache_specs_ = cache_abstract(cfg, B, S)
    return ((token, pos, cache_shapes_),
            (("dp",), ("dp",), cache_specs_))
