"""The train step, as the JAX package's ``repro.runtime.train_loop``:
a bf16 compute copy of the fp32 masters, microbatched gradient
accumulation, remat per ``cfg.remat`` (``models/transformer.py``) and
AdamW on the masters.

The step takes the ``LM`` whose parameters are the fp32 masters (JAX's
``params``), and writes them and the optimizer state in place:

* once a step, every fp32 leaf of JAX rank >= 2 (``weights.jax_ranks``;
  JAX's ``_cast_params`` by ``ndim``) is copied to the policy's
  ``grad_compress_dtype`` (bf16 by default), the rest is used as it is;
* the loss and the gradients are taken with respect to that copy, as
  JAX's are (so they are bf16 for the cast leaves), by
  ``torch.func.functional_call`` over the ``LM``; the backward runs inside
  the call, so remat's recomputation reads the copy too;
* with ``M = policy.microbatches`` > 1 the batch's rows are cut into M
  consecutive microbatches, whose gradients are summed in ``accum_dtype``
  (fp32) and divided by M, and the loss likewise;
* then ``adamw_update`` on the masters, decaying by JAX rank.

Metrics: ``loss``, ``grad_norm`` (before clipping) and ``lr``, fp32
scalar tensors.  Sharding the state over a mesh (JAX's
``opt_state_specs``) waits for the multi-GPU slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.weights import jax_ranks
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.runtime.sharding import ShardingPolicy


def _cast_params(params: Dict[str, torch.Tensor], dtype,
                 ranks: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """The compute copy: each fp32 leaf of JAX rank >= 2 in ``dtype``,
    every other leaf as it is (detached); each a leaf of autograd."""
    def c(k, x):
        if x.dtype == torch.float32 and ranks[k] >= 2:
            x = x.detach().to(dtype)
        return x.detach().requires_grad_(True)
    return {k: c(k, x) for k, x in params.items()}


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``SyntheticLMData.batch_at``) or tensors
    on ``device``; integer arrays as int64."""
    out = {}
    for k, x in batch.items():
        if isinstance(x, np.ndarray) and x.dtype.kind in "iu":
            x = x.astype(np.int64)
        out[k] = torch.as_tensor(x, device=device)
    return out


def _value_and_grad(lm, pb, loss_fn, batch):
    """(loss, gradients keyed as ``pb``) of ``loss_fn(lm, batch)`` with
    the tensors of ``pb`` in place of the model's weights.  A weight the
    loss does not reach gets a zero gradient."""
    def run(model, batch):
        with torch.enable_grad():
            loss, _ = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, list(pb.values()),
                                        allow_unused=True)
        return loss.detach(), grads

    loss, grads = torch.func.functional_call(lm, pb, (run, batch))
    return loss, {k: torch.zeros_like(x) if g is None else g
                  for (k, x), g in zip(pb.items(), grads)}


def _average(grads, loss, M: int):
    """The accumulated microbatch gradients and loss, each divided by M."""
    return {k: g / M for k, g in grads.items()}, loss / M


def build_train_step(cfg: ModelConfig, policy: ShardingPolicy,
                     lr_fn: Callable, loss_fn: Optional[Callable] = None,
                     accum_dtype=torch.float32):
    """Returns ``train_step(lm, opt_state, batch, step)`` → (lm, opt_state,
    metrics); ``lm`` (fp32 masters) and the state's tensors are updated in
    place.  ``loss_fn(model, batch)`` → (loss, aux) defaults to the
    model's ``loss_fn``; ``batch`` may hold numpy arrays."""
    loss_fn = loss_fn or (lambda p, b: tf.loss_fn(p, cfg, b))
    M = policy.microbatches
    gdtype = (torch.bfloat16 if policy.grad_compress_dtype == "bfloat16"
              else torch.float32)

    def train_step(lm, opt_state, batch, step):
        params = dict(lm.named_parameters())
        ranks = jax_ranks(cfg, lm)
        dev = next(iter(params.values())).device
        batch = to_device(batch, dev)
        # cast once outside the microbatch loop
        pb = _cast_params(params, gdtype, ranks)
        if M > 1:
            n = next(iter(batch.values())).shape[0] // M
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype, device=dev)
                     for k, p in params.items()}
            loss = 0.0
            for i in range(M):
                mb = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
                mb_loss, g = _value_and_grad(lm, pb, loss_fn, mb)
                for k, acc in grads.items():
                    grads[k] = (acc + g[k].to(accum_dtype)).to(accum_dtype)
                del g
                loss = loss + mb_loss
            grads, loss = _average(grads, loss, M)
        else:
            loss, grads = _value_and_grad(lm, pb, loss_fn, batch)
        del pb
        lr = lr_fn(step)
        _, opt_state, gn = adamw_update(params, grads, opt_state, lr,
                                        ranks=ranks)
        metrics = {"loss": loss.float(), "grad_norm": gn,
                   "lr": torch.as_tensor(lr, dtype=torch.float32)}
        return lm, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, generator, device=None):
    """(a training ``LM``: every weight fp32 from ``generator`` (a
    ``torch.Generator`` or an int seed) on ``device`` (default ``cuda``),
    its ``adamw_init`` state)."""
    lm = tf.init_lm(cfg, generator, device=device, dtype=torch.float32)
    return lm, adamw_init(dict(lm.named_parameters()))
