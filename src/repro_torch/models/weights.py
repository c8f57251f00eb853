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
The port's ``LM`` holds its projections in bf16 by default (serving);
``dtype=torch.float32`` loads JAX's fp32 tree without rounding (a
training model, every leaf fp32).  A bf16 leaf (an ``ml_dtypes`` array)
loads through fp32, which is exact.

Training needs two more things of JAX's tree:

* ``from_jax_opt_state`` carries a JAX ``AdamWState`` (step, m, v) across
  into the port's (``optim/adamw.py``), m and v keyed by the ``LM``'s
  parameter names and loaded as the parameters are;
* ``jax_ranks`` records the rank each parameter has in JAX's tree: a leaf
  of the scanned superblocks (``layers``), of whisper's encoder blocks
  and of the ``cross`` stack has one more dimension there than in the
  port's per-layer modules.  JAX's train step casts every fp32 leaf of
  rank >= 2 to bf16 and ``adamw_update`` decays every leaf of rank >= 2,
  so the stacked norm weights, biases and recurrent gates are trained in
  bf16 and decayed, and ``final_norm`` and the remainder blocks' 1-D
  leaves are not (ROADMAP R11).  The port decides both by this rank.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.transformer import LM, _pattern
from repro_torch.optim.adamw import AdamWState


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
        if arr.dtype.name == "bfloat16":    # numpy has no bf16 of its own
            arr = arr.astype(np.float32)
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


def from_jax_params(cfg, params, device=None, dtype=None) -> LM:
    """The port's ``LM`` holding the JAX package's ``init_lm`` parameters
    (or any tree of that structure: gradients, optimizer moments), on
    ``device`` (default ``cuda``): the projections in ``dtype`` (default
    ``COMPUTE_DTYPE``, bf16, to serve; fp32 keeps JAX's fp32 leaves
    exactly), norms in fp32."""
    lm = LM(cfg, device=device, dtype=dtype)
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



def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree)


def from_jax_opt_state(cfg, opt_state, device=None) -> AdamWState:
    """A JAX ``AdamWState`` (step, m, v over the ``init_lm`` tree, numpy
    leaves) as the port's: m and v keyed by the ``LM``'s parameter names
    in the moments' dtype (fp32, or bf16 for ``adamw_init(dtype=bf16)``),
    the step an int32 scalar, on ``device`` (default ``cuda``)."""
    dtype = (torch.bfloat16 if _first_leaf(opt_state.m).dtype.name
             == "bfloat16" else torch.float32)

    def moments(tree):
        lm = from_jax_params(cfg, tree, device, dtype=torch.float32)
        return {n: p.detach().to(dtype) for n, p in lm.named_parameters()}

    m = moments(opt_state.m)
    step = torch.tensor(int(np.asarray(opt_state.step)), dtype=torch.int32,
                        device=next(iter(m.values())).device)
    return AdamWState(step=step, m=m, v=moments(opt_state.v))


def jax_ranks(cfg, lm: LM) -> Dict[str, int]:
    """Each parameter's rank in JAX's tree, by the ``LM``'s name: its own
    rank, plus one where JAX stacks it (the scanned superblocks, the
    encoder blocks, the cross stack)."""
    period = len(_pattern(cfg))
    n_scanned = cfg.n_layers // period * period
    out = {}
    for name, p in lm.named_parameters():
        parts = name.split(".")
        stacked = ((parts[0] == "layers" and int(parts[1]) < n_scanned)
                   or parts[0] == "cross" or parts[:2] == ["encoder",
                                                           "blocks"])
        out[name] = p.ndim + int(stacked)
    return out
