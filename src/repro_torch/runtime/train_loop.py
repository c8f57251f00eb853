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
scalar tensors.

On a mesh the masters and the moments are DTensors (placed by
``ShardingPolicy.tree_shardings`` of ``logical_specs`` and
``opt_state_specs``) and so is the batch (``batch_specs``).  The step is
the same code: the compute copy, the forward and the backward run as
DTensor ops (plain tensors made inside the model count as replicated),
and ``grad_shardings`` (each parameter's placements) redistributes each
gradient, and the microbatch accumulator, to its parameter's placements,
as JAX's ``_constrain``.  A gradient comes back ``Partial`` over the data
axes; that redistribution is its reduce-scatter, made in the gradient's
dtype (bf16 for the cast leaves, as JAX's is).  A microbatch is JAX's:
the rows i*B/M .. (i+1)*B/M - 1 of the global batch, re-placed as the
batch is.  The metrics come back as plain (replicated) tensors.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.activation_sharding import is_dtensor
from repro_torch.models.weights import jax_ranks
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
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
        if is_dtensor(x):
            out[k] = x
            continue
        if isinstance(x, np.ndarray) and x.dtype.kind in "iu":
            x = x.astype(np.int64)
        out[k] = torch.as_tensor(x, device=device)
    return out


def _mesh_context(params):
    """DTensor's implicit replication of the plain tensors the model makes
    (positions, masks, constants) when the weights are on a mesh."""
    if not any(is_dtensor(p) for p in params.values()):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _plain(x):
    """A metric as a plain tensor (a DTensor's full value)."""
    return x.full_tensor() if is_dtensor(x) else x


def _microbatch(x, i: int, n: int):
    """Rows i*n .. (i+1)*n - 1 of a batch leaf; a DTensor's are placed as
    the batch is."""
    mb = x[i * n:(i + 1) * n]
    if is_dtensor(x):
        mb = mb.redistribute(x.device_mesh, x.placements)
    return mb


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
                     grad_shardings: Optional[Dict[str, list]] = None,
                     accum_dtype=torch.float32):
    """Returns ``train_step(lm, opt_state, batch, step)`` → (lm, opt_state,
    metrics); ``lm`` (fp32 masters) and the state's tensors are updated in
    place.  ``loss_fn(model, batch)`` → (loss, aux) defaults to the
    model's ``loss_fn``; ``batch`` may hold numpy arrays (or DTensors, on
    a mesh).  ``grad_shardings``: each parameter's DTensor placements, by
    name (``policy.tree_shardings(mesh, specs)``); the gradients and the
    accumulator are redistributed to them (module docstring)."""
    loss_fn = loss_fn or (lambda p, b: tf.loss_fn(p, cfg, b))
    M = policy.microbatches
    gdtype = (torch.bfloat16 if policy.grad_compress_dtype == "bfloat16"
              else torch.float32)

    def constrain(g):
        if grad_shardings is None:
            return g
        return {k: x.redistribute(x.device_mesh, grad_shardings[k])
                if is_dtensor(x) else x for k, x in g.items()}

    def train_step(lm, opt_state, batch, step):
        params = dict(lm.named_parameters())
        ranks = jax_ranks(cfg, lm)
        dev = next(iter(params.values())).device
        batch = to_device(batch, dev)
        with _mesh_context(params):
            # cast once outside the microbatch loop
            pb = _cast_params(params, gdtype, ranks)
            if M > 1:
                n = next(iter(batch.values())).shape[0] // M
                grads = {k: torch.zeros_like(p, dtype=accum_dtype)
                         for k, p in params.items()}
                loss = 0.0
                for i in range(M):
                    mb = {k: _microbatch(x, i, n) for k, x in batch.items()}
                    mb_loss, g = _value_and_grad(lm, pb, loss_fn, mb)
                    g = constrain(g)
                    for k, acc in grads.items():
                        grads[k] = (acc + g[k].to(accum_dtype)
                                    ).to(accum_dtype)
                    grads = constrain(grads)
                    del g
                    loss = loss + mb_loss
                grads, loss = _average(grads, loss, M)
            else:
                loss, grads = _value_and_grad(lm, pb, loss_fn, batch)
                grads = constrain(grads)
            del pb
            lr = lr_fn(step)
            _, opt_state, gn = adamw_update(params, grads, opt_state, lr,
                                            ranks=ranks)
        metrics = {"loss": _plain(loss).float(), "grad_norm": _plain(gn),
                   "lr": torch.as_tensor(lr, dtype=torch.float32)}
        return lm, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, generator, device=None):
    """(a training ``LM``: every weight fp32 from ``generator`` (a
    ``torch.Generator`` or an int seed) on ``device`` (default ``cuda``),
    its ``adamw_init`` state)."""
    lm = tf.init_lm(cfg, generator, device=device, dtype=torch.float32)
    return lm, adamw_init(dict(lm.named_parameters()))


def opt_state_specs(param_specs: Dict[str, tuple]) -> AdamWState:
    """AdamW state specs mirror the parameters' (ZeRO: the same sharding);
    the step is replicated."""
    return AdamWState(step=(), m=dict(param_specs), v=dict(param_specs))


def distribute_state(lm, opt_state: AdamWState, mesh, param_placements):
    """Places a training state on ``mesh`` in place: every parameter of
    ``lm`` and its moments become DTensors on its placements (a dict by
    name, ``tree_shardings`` of the specs), the step a replicated one.
    Returns (lm, opt_state)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    for name, p in list(lm.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = lm.get_submodule(mod_name) if mod_name else lm
        d = distribute_tensor(p.detach(), mesh, param_placements[name])
        setattr(mod, leaf, torch.nn.Parameter(d,
                                              requires_grad=p.requires_grad))

    def put(tree):
        return {k: distribute_tensor(x, mesh, param_placements[k])
                for k, x in tree.items()}

    step = distribute_tensor(opt_state.step, mesh,
                             [Replicate()] * mesh.ndim)
    return lm, AdamWState(step=step, m=put(opt_state.m),
                          v=put(opt_state.v))
