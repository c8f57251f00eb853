"""Weights carried across from the JAX package.

``from_jax_params`` takes the parameter tree of the JAX package's
``transformer.init_lm`` (its leaves as numpy arrays) and loads it into the
port's ``LM``: the superblock stack ``params["layers"]["b{i}_{kind}"]`` is
unstacked along its leading axis and the remainder blocks
``params["rem{j}_{kind}"]`` follow, in layer order.  An MoE block's
``moe`` subtree (router, w_gate, w_up, w_down) is unstacked like the rest
into ``Block.moe``; a leaf missing on either side, or of another shape,
raises.
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


def _block_trees(cfg, params):
    """(tree, index) of each layer of the JAX tree, in layer order."""
    pat = _pattern(cfg)
    n_super = cfg.n_layers // len(pat)
    for s in range(n_super):
        for i, kind in enumerate(pat):
            yield params["layers"][f"b{i}_{kind}"], s
    for j in range(cfg.n_layers - n_super * len(pat)):
        yield params[f"rem{j}_{pat[j]}"], None


def from_jax_params(cfg, params, device=None) -> LM:
    """The port's ``LM`` (bf16 projections, fp32 norms) holding the JAX
    package's ``init_lm`` parameters, on ``device`` (default ``cuda``)."""
    lm = LM(cfg, device=device)
    top = {k: v for k, v in params.items()
           if k != "layers" and not k.startswith("rem")}
    load_tree(lm, top, None, "params", skip=("layers",))
    for i, (tree, index) in enumerate(_block_trees(cfg, params)):
        load_tree(lm.layers[i], tree, index, f"layer {i}")
    return lm
