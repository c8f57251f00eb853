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
``PartitionSpec``'s is (a one-name tuple is the name, an empty one None).

On a ``torch.distributed`` ``DeviceMesh`` a resolved spec becomes DTensor
placements (JAX's ``NamedSharding``): ``shard(mesh, spec)`` gives one
placement per mesh dimension, ``Shard(i)`` where the spec names that mesh
axis on tensor dimension i and ``Replicate()`` elsewhere.  A dimension
sharded over several mesh axes (``("pod", "data")``) is split by them in
the mesh's order, major first, as JAX splits it.  Trees of specs are
dicts, lists and named tuples whose leaves are specs (plain tuples).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]


def is_spec(x) -> bool:
    """A spec leaf: a plain tuple (a named tuple is a tree node)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def map_specs(fn: Callable, tree, *rest):
    """``fn`` over the spec leaves of ``tree`` (dicts, lists, named tuples;
    None stays None), with the matching leaves of the trees ``rest``."""
    if tree is None:
        return None
    if is_spec(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):            # a named tuple
        return type(tree)(*(map_specs(fn, v, *(getattr(r, f) for r in rest))
                            for f, v in zip(tree._fields, tree)))
    return type(tree)(map_specs(fn, v, *(r[i] for r in rest))
                      for i, v in enumerate(tree))


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of a sequence of names."""
    names = getattr(mesh, "mesh_dim_names", mesh)
    return tuple(names or ())


def fit_spec(mesh, resolved: Sequence[Axis], shape: Sequence[int]
             ) -> Tuple[Axis, ...]:
    """A resolved spec with every entry dropped (None) whose mesh axes do
    not divide its dimension of ``shape``, or that has no dimension: the
    JAX dry run's rule for vocabulary, expert and head remainders.  An
    entry whose mesh axes an earlier kept entry already uses is dropped
    too (a cache's "sp" and "tp" are both ``model``; JAX would refuse such
    a spec, and at the production meshes no dimension keeps both)."""
    sizes = dict(zip(axis_names(mesh), tuple(mesh.shape)))
    out, used = [], set()
    for i, ax in enumerate(tuple(resolved)):
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        if not axes or i >= len(shape) or used & set(axes):
            out.append(None)
            continue
        n = 1
        for a in axes:
            n *= sizes[a]
        keep = n and shape[i] % n == 0
        out.append(ax if keep else None)
        used |= set(axes) if keep else set()
    return tuple(out)


def placements(mesh, resolved: Sequence[Axis]) -> list:
    """DTensor placements on ``mesh`` of a resolved spec."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for i, ax in enumerate(tuple(resolved)):
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            j = names.index(a)
            if out[j] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dimensions "
                                 f"of {tuple(resolved)}")
            out[j] = Shard(i)
    return out


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

    def shard(self, mesh, spec: Sequence[Axis], shape=None) -> list:
        """The DTensor placements of a logical spec on ``mesh``; with a
        ``shape``, by ``fit_spec``'s rule."""
        resolved = self.resolve(spec)
        if shape is not None:
            resolved = fit_spec(mesh, resolved, shape)
        return placements(mesh, resolved)

    def tree_shardings(self, mesh, spec_tree, shape_tree=None) -> Any:
        """Placements of every spec of the tree; with a tree of shapes
        (or tensors) of the same structure, by ``fit_spec``'s rule."""
        if shape_tree is None:
            return map_specs(lambda s: self.shard(mesh, s), spec_tree)
        return map_specs(lambda s, x: self.shard(mesh, s, tuple(
            getattr(x, "shape", x))), spec_tree, shape_tree)

    def tree_specs(self, spec_tree) -> Any:
        return map_specs(self.resolve, spec_tree)


def _canonical(ax: Axis) -> Axis:
    if isinstance(ax, tuple):
        return ax[0] if len(ax) == 1 else (ax or None)
    return ax


def default_policy(mesh, **kw) -> ShardingPolicy:
    """The production policy over a ``DeviceMesh`` (or a mesh with these
    axis names)."""
    names = axis_names(mesh)
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


def batch_specs(policy: ShardingPolicy, batch_tree_specs) -> Any:
    return map_specs(policy.resolve, batch_tree_specs)


def tp_only_policy(mesh, **kw) -> ShardingPolicy:
    """No FSDP: weights replicated over data axes, TP over model."""
    p = default_policy(mesh, **kw)
    rules = dict(p.rules)
    rules["fsdp"] = None
    return dataclasses.replace(p, rules=rules, name="tp_only")


def seq_shard_policy(mesh, **kw) -> ShardingPolicy:
    """Long-context decode: shard cache sequence dim over the data axes
    (batch too small to occupy them)."""
    p = default_policy(mesh, **kw)
    rules = dict(p.rules)
    rules["sp"] = rules["dp"]       # sequence rides the data axes
    rules["dp"] = None              # batch=1: replicate
    return dataclasses.replace(p, rules=rules, name="seq_shard")
