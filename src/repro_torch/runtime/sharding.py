"""Logical-axis → mesh-axis resolution, as the JAX package's
``repro.runtime.sharding``.

Models annotate weights and activations with *logical* axes:
  "fsdp" — weight sharding over the data-parallel axes (ZeRO-3)
  "tp"   — tensor parallel (heads / ffn / vocab / experts)
  "dp"   — batch data parallel
  "sp"   — sequence parallel (long-context decode caches)

A ``ShardingPolicy`` maps logical names to physical mesh axes and carries
the train step's knobs (``microbatches``, ``grad_compress_dtype``).  A
spec is a tuple of logical axes (JAX's ``PartitionSpec``): each entry
None, a name, or a tuple of names; a resolved entry is canonical as a
``PartitionSpec``'s is (a one-name tuple is the name, an empty one None).  Placing tensors on a mesh (JAX's
``shard``, ``tree_shardings`` and ``batch_specs`` on ``NamedSharding``)
waits for the multi-GPU slice; one card needs only the knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Logical→physical axis mapping + runtime knobs."""
    rules: Dict[str, Axis]
    microbatches: int = 1           # grad-accumulation steps per train step
    zero_opt_state: bool = True     # shard optimizer state like params (ZeRO)
    grad_compress_dtype: Optional[str] = "bfloat16"  # DP-reduce compression
    name: str = "default"

    def resolve(self, spec: Sequence[Axis]) -> Tuple[Axis, ...]:
        out = []
        for ax in tuple(spec):
            if ax is None:
                out.append(None)
            elif isinstance(ax, str):
                out.append(_canonical(self.rules.get(ax, None)))
            else:  # tuple of logical names
                phys: list = []
                for a in ax:
                    r = self.rules.get(a)
                    if r is None:
                        continue
                    phys.extend(r if isinstance(r, tuple) else (r,))
                out.append(_canonical(tuple(phys)))
        return tuple(out)


def _canonical(ax: Axis) -> Axis:
    if isinstance(ax, tuple):
        return ax[0] if len(ax) == 1 else (ax or None)
    return ax


def default_policy(axis_names: Sequence[str], **kw) -> ShardingPolicy:
    """The production policy over a mesh with these axis names."""
    names = tuple(axis_names)
    dp_axes = tuple(a for a in ("pod", "data") if a in names) or None
    rules = {
        "fsdp": dp_axes,
        "dp": dp_axes,
        "tp": "model" if "model" in names else None,
        "sp": "model" if "model" in names else None,
    }
    return ShardingPolicy(rules=rules, **kw)


def single_device_policy(**kw) -> ShardingPolicy:
    return ShardingPolicy(rules={}, name="single", **kw)


def tp_only_policy(axis_names: Sequence[str], **kw) -> ShardingPolicy:
    """No FSDP: weights replicated over data axes, TP over model."""
    p = default_policy(axis_names, **kw)
    rules = dict(p.rules)
    rules["fsdp"] = None
    return dataclasses.replace(p, rules=rules, name="tp_only")


def seq_shard_policy(axis_names: Sequence[str], **kw) -> ShardingPolicy:
    """Long-context decode: shard cache sequence dim over the data axes
    (batch too small to occupy them)."""
    p = default_policy(axis_names, **kw)
    rules = dict(p.rules)
    rules["sp"] = rules["dp"]       # sequence rides the data axes
    rules["dp"] = None              # batch=1: replicate
    return dataclasses.replace(p, rules=rules, name="seq_shard")
