"""Weights carried across from the JAX package.

``from_jax_params`` takes the parameter tree of the JAX package's
``transformer.init_lm`` (its leaves as numpy arrays) and loads it into the
port's ``LM``: the superblock stack ``params["layers"]["b{i}_{kind}"]`` is
unstacked along its leading axis and the remainder blocks
``params["rem{j}_{kind}"]`` follow, in layer order; every kind's subtree
(``attn`` with ``mlp`` or ``moe``, ``rglru``, ``ssm``) loads into its
``Block``.  A whisper tree's ``encoder`` (stacked ``blocks``,
``final_norm``) and ``cross`` stack are unstacked into ``LM.encoder`` and
``LM.cross``.  A leaf missing on either side, or of another shape, raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import LM, _pattern


def load_tree(module: torch.nn.Module, tree: dict, index, where: str,
          skip=()) -> None:
    """Copy every leaf of ``tree`` (``[index]`` of it, if given) into the
    parameter of the same name; every parameter must be named once
    (submodules in ``skip`` are left alone)."""
    own = dict(module.named_parameters(recurse=False))
    subs = {n: m for n, m in module.named_children() if n not in skip}
    for name, val in tree.items():
        if isinstance(val, dict):
            if name not in subs:
                raise KeyError(f"{where}.{name}: no such submodule")
            load_tree(subs.pop(name), val, index, f"{where}.{name}")
            continue
        if name not in own:
            raise KeyError(f"{where}.{name}: no such parameter")
        arr = np.asarray(val)
        if index is not None:
            arr = arr[index]
        param = own.pop(name)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{where}.{name}: shape {arr.shape}, the port "
                             f"has {tuple(param.shape)}")
        param.data.copy_(torch.from_numpy(np.array(arr, copy=True)))
    if own or subs:
        raise KeyError(f"{where}: not in the JAX tree: "
                       f"{sorted(own) + sorted(subs)}")


def _rem_names(cfg):
    pat = _pattern(cfg)
    n_rem = cfg.n_layers % len(pat)
    return [f"rem{j}_{pat[j]}" for j in range(n_rem)]


def _block_trees(cfg, params):
    """(tree, index) of each layer of the JAX tree, in layer order."""
    pat = _pattern(cfg)
    n_super = cfg.n_layers // len(pat)
    for s in range(n_super):
        for i, kind in enumerate(pat):
            yield params["layers"][f"b{i}_{kind}"], s
    for name in _rem_names(cfg):
        yield params[name], None


def from_jax_params(cfg, params, device=None) -> LM:
    """The port's ``LM`` (bf16 projections, fp32 norms) holding the JAX
    package's ``init_lm`` parameters, on ``device`` (default ``cuda``)."""
    lm = LM(cfg, device=device)
    stacked = {"layers", *_rem_names(cfg)}
    if cfg.is_enc_dec:
        stacked |= {"encoder", "cross"}
    top = {k: v for k, v in params.items() if k not in stacked}
    load_tree(lm, top, None, "params", skip=("layers", "encoder", "cross"))
    for i, (tree, index) in enumerate(_block_trees(cfg, params)):
        load_tree(lm.layers[i], tree, index, f"layer {i}")
    if cfg.is_enc_dec:
        enc = params["encoder"]
        load_tree(lm.encoder, {k: v for k, v in enc.items() if k != "blocks"},
                  None, "encoder", skip=("blocks",))
        for i, blk in enumerate(lm.encoder.blocks):
            load_tree(blk, enc["blocks"], i, f"encoder block {i}")
        for i, blk in enumerate(lm.cross):
            load_tree(blk, params["cross"], i, f"cross {i}")
    return lm
