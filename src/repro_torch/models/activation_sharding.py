"""Injection points for activation sharding constraints (sequence/tensor
parallelism): a runtime installs constraint functions, and the model calls
them at well-known points.  With no hook installed every call is a no-op,
which is how the single-card port runs.

The same hook table and API as the JAX package's
``models/activation_sharding.py``; the port calls ``constrain`` where JAX's
model code does (``transformer.apply_block``'s "inner", a superblock's
"block", ``embed_tokens``' "embed", ``unembed``'s "logits",
``attention_core``'s "scores"), and ``embed_tokens`` takes the one-hot
product when "embed_onehot" is set.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

_HOOKS: Dict[str, Optional[Callable]] = {
    "block": None,    # superblock boundary [B,S,D] (SP: seq-sharded carry)
    "inner": None,    # post-norm activation [B,S,D] (SP: gathered for TP)
    "embed": None,    # embedding output   [B,S,D]
    "logits": None,   # unembed output     [B,S,V]
    "scores": None,   # attention scores   [B,H,S,T]
    "moe": None,      # MoE dispatch buffers [G,E,C,d] (EP sharding)
    "moe_rep": None,  # MoE dispatch buffers, replicated-expert variant
    "embed_onehot": None,  # truthy → one-hot matmul embedding (serving:
                           # gather from a vocab-sharded table replicates it)
}


def enabled(name: str) -> bool:
    return _HOOKS.get(name) is not None


def set_constraint(fn: Optional[Callable], name: str = "block") -> None:
    _HOOKS[name] = fn


def clear() -> None:
    for k in _HOOKS:
        _HOOKS[k] = None


def constrain(x, name: str = "block"):
    fn = _HOOKS.get(name)
    return x if fn is None else fn(x)
