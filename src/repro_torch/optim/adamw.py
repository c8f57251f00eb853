"""AdamW (decoupled weight decay) with global-norm clipping, as the JAX
package's ``repro.optim.adamw``.

The JAX package's trees are the port's flat dicts keyed by parameter
name (``dict(lm.named_parameters())``); the optimizer state mirrors them.
The update math is JAX's step for step in fp32, bias corrections
``1 - b**step`` included.  Two things differ in form, not in number:

* the update is made in place under ``torch.no_grad()`` (the parameters
  and the moments are overwritten; JAX returns new arrays), and one
  leaf at a time, so no fp32 copy of the whole gradient tree is made;
* JAX decays a leaf whose rank is >= 2.  A leaf's rank in JAX's tree is
  not always its rank in the port (JAX stacks the layers of its scanned
  superblocks), so ``adamw_update`` takes the JAX rank of each leaf in
  ``ranks`` (``models.weights.jax_ranks``); without it, each tensor's own.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32 scalar
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def adamw_init(params: Dict[str, torch.Tensor],
               dtype=torch.float32) -> AdamWState:
    """Zero moments beside each parameter, on its device.
    ``dtype=torch.bfloat16`` halves the optimizer's memory (the update
    math stays fp32; the moments are cast on store)."""
    m = {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
    v = {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
    dev = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=m, v=v)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in fp32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(gn, max_norm: float):
    return torch.minimum(torch.ones_like(gn), max_norm / (gn + 1e-9))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {k: g * scale for k, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 ranks: Optional[Dict[str, int]] = None):
    """One step: the gradients (any dtype) in fp32, clipped to
    ``max_grad_norm`` by their global norm; m and v; bias-corrected; the
    decay ``weight_decay`` on leaves of JAX rank >= 2.  ``params``, m and
    v are written in place.  Returns (params, the new state, the global
    norm of the gradients before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_grad_norm)
    step = state.step + 1
    b1c = 1.0 - b1 ** step.float()
    b2c = 1.0 - b2 ** step.float()
    lr = torch.as_tensor(lr, dtype=torch.float32)
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = state.m[k], state.v[k]
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * torch.square(g)
        del g
        mh = m32 / b1c
        vh = v32 / b2c
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        # decay only matrices (norms and biases are 1-D in JAX's tree)
        rank = p.ndim if ranks is None else ranks[k]
        wd = weight_decay if rank >= 2 else 0.0
        p32 = p.float()
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + eps) + wd * p32)
        p.copy_(p32)
    return params, AdamWState(step=step, m=state.m, v=state.v), gn
