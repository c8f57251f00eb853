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

On a ``torch.distributed`` mesh (the weights and inputs DTensors) the
hooks are ``redistribute`` calls (``launch/dryrun.py`` installs them),
and the model reaches the mesh through the routes below, each of which
runs the single-card code on every device's local tensors and states
the placements of its result and of its inputs' gradients (the partial
sums it leaves); with plain tensors each is the single-card code:

* ``linear`` — every projection (batch-like, column- or row-parallel);
* ``gather_rows`` — the embedding lookup (a vocabulary-sharded table
  gathers the rows it holds);
* ``by_heads`` — attention, on each device's batch rows and GQA groups;
* ``on_rows`` — the SSD scans, on each device's batch rows;
* ``replicated`` — MoE routing, dispatch and combine (a sort, a one-hot
  scatter and a cumsum that DTensor has no strategy for), on the full
  values;
* ``without`` — a partial sum or a sharded dimension made replicated.

DTensor's own strategies for these ops fold two sharded dimensions into
one and fail, or differ between releases.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

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


def is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def replicated(fn: Callable, *args):
    """``fn(*args)`` where every DTensor argument is first redistributed
    to ``Replicate()`` on its mesh and passed as its local (full) tensor;
    the tensors ``fn`` returns (one, or a tuple) come back as replicated
    DTensors on that mesh.  Differentiable: each rank computes the same
    full gradient.  With no DTensor argument it is ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * mesh.ndim
    out = fn(*(a.redistribute(mesh, rep).to_local() if is_dtensor(a)
               else a for a in args))

    def wrap(t):
        return (DTensor.from_local(t, mesh, rep, run_check=False)
                if isinstance(t, torch.Tensor) else t)
    return tuple(wrap(t) for t in out) if isinstance(out, tuple) \
        else wrap(out)


def on_rows(fn: Callable, *args):
    """``fn(*args)`` on each device's batch rows: the first argument's
    batch dimension (0) stays sharded where it is (a mesh dimension that
    divides it), every other mesh dimension is replicated; each tensor
    argument of 2 or more dimensions whose leading size is the batch's
    follows it, the others are replicated.  The tensors ``fn`` returns
    are batched the same way.  With no DTensor argument it is
    ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    B = args[0].shape[0]
    rep = [Replicate()] * mesh.ndim
    rows = [Shard(0) if p == Shard(0) and B % mesh.size(i) == 0
            else Replicate()
            for i, p in enumerate(getattr(args[0], "placements", rep))]

    # an unbatched argument's gradient, taken on each device's rows, is
    # a partial sum over the mesh dimensions that split the rows
    partial = [Partial() if p == Shard(0) else Replicate() for p in rows]

    def local(a):
        if not isinstance(a, torch.Tensor):
            return a
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, rep, run_check=False)
        if a.ndim >= 2 and a.shape[0] == B:
            return a.redistribute(mesh, rows).to_local()
        return a.redistribute(mesh, rep).to_local(grad_placements=partial)

    out = fn(*(local(a) for a in args))

    def wrap(t):
        return (DTensor.from_local(t.contiguous(), mesh, rows,
                                   run_check=False)
                if isinstance(t, torch.Tensor) else t)
    return tuple(wrap(t) for t in out) if isinstance(out, tuple) \
        else wrap(out)


def without(x, dims=(), partial: bool = True):
    """A DTensor redistributed so that no mesh dimension shards one of
    ``dims`` (nor, with ``partial``, holds a partial sum): those become
    replicated.  Anything else passes."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if (getattr(p, "dim", None) in dims or
                          (partial and p.is_partial())) else p
          for p in x.placements]
    return x if list(pl) == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def _matmul(x, w, k: int):
    """x [..., *w.shape[:k]] contracted with w → [..., *w.shape[k:]], as
    one matmul over the flattened dimensions."""
    xm = x.flatten(-k) if k > 1 else x
    wm = w.flatten(0, k - 1) if k > 1 else w
    rest = wm.shape[1:]
    if len(rest) > 1:
        return torch.matmul(xm, wm.flatten(1)).unflatten(-1, rest)
    return torch.matmul(xm, wm)


def linear(x, w, k: int = 1):
    """The projection x [..., *w.shape[:k]] · w → [..., *w.shape[k:]]
    (one matmul).  On a mesh it runs on each device's shards (the
    placements of x and w are kept, no DTensor matmul strategy is asked
    for, which would fold sharded dimensions together), per mesh
    dimension:

    * x sharded on a leading dimension (batch, sequence): kept, w
      gathered (FSDP), the output sharded alike, w's gradient a partial
      sum;
    * else w sharded on an output dimension (column parallel: heads,
      ffn, vocabulary): kept, x replicated, its gradient a partial sum;
    * else w sharded on a contracted dimension (row parallel): x sharded
      to match, the output a partial sum;
    * else replicated."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return _matmul(x, w, k)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = (x if is_dtensor(x) else w).device_mesh
    rep = [Replicate()] * mesh.ndim
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    if not is_dtensor(w):
        w = DTensor.from_local(w, mesh, rep, run_check=False)
    x = without(x)
    nb = x.ndim - k
    px, gx, pw, gw, py = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        ad, bd = getattr(a, "dim", None), getattr(b, "dim", None)
        if ad is not None and ad < nb:              # batch-like
            px.append(a), gx.append(a), pw.append(Replicate())
            gw.append(Partial()), py.append(a)
        elif bd is not None and bd >= k:            # column parallel
            px.append(Replicate()), gx.append(Partial()), pw.append(b)
            gw.append(b), py.append(Shard(nb + bd - k))
        elif bd is not None:                        # row parallel
            px.append(Shard(nb + bd)), gx.append(Shard(nb + bd))
            pw.append(b), gw.append(b), py.append(Partial())
        else:
            px.append(Replicate()), gx.append(Replicate())
            pw.append(Replicate()), gw.append(Replicate())
            py.append(Replicate())
    xl = x.redistribute(mesh, px).to_local(grad_placements=gx)
    wl = w.redistribute(mesh, pw).to_local(grad_placements=gw)
    return DTensor.from_local(_matmul(xl, wl, k).contiguous(), mesh, py,
                              run_check=False)


def by_heads(fn: Callable, q, k, v, *rest, rows: bool = False):
    """``fn(q, k, v, *rest)`` (an attention: q [B,S,H,hd], k/v
    [B,T,KV,hd]) on each device's batch rows and heads: a mesh dimension
    that shards q's batch keeps it, one that shards its heads keeps them
    where whole GQA groups stay together (KV divides over it, or KV is
    1); with ``rows`` (the caller's mask [..., S, T] carries the query
    positions) any other shards q's query rows where S divides over it,
    K/V whole on each device (JAX's "scores" layout: [B,H,S,T] on the
    query dimension, the softmax over keys local); any other is
    replicated.  K/V follow q's batch and heads, and each further
    argument (a mask, broadcast over heads) follows q's batch where its
    leading size is q's and its query rows where its size there is S.
    Returns q's layout."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, S, KV = q.device_mesh, q.shape[1], k.shape[2]
    pq, pk, gk = [], [], []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p == Shard(0):
            pq.append(p), pk.append(p), gk.append(p)
        elif p == Shard(2) and (KV == 1 or KV % n == 0):
            pq.append(p)
            # one K/V head shared by every device's query heads: its
            # gradient is a partial sum over them
            pk.append(p if KV > 1 else Replicate())
            gk.append(p if KV > 1 else Partial())
        elif rows and S > 1 and S % n == 0:
            # every device's query rows read all keys: K/V's gradient is
            # a partial sum over the rows
            pq.append(Shard(1)), pk.append(Replicate()), gk.append(Partial())
        else:
            pq.append(Replicate()), pk.append(Replicate())
            gk.append(Replicate())
    rep = [Replicate()] * mesh.ndim

    def local(x, pl, grad=None):
        if not isinstance(x, torch.Tensor):
            return x
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, rep, run_check=False)
        return x.redistribute(mesh, pl).to_local(grad_placements=grad)

    def follow(x):
        """A further argument's placements: q's batch and query rows."""
        if not isinstance(x, torch.Tensor) or x.ndim < 2:
            return rep
        return [p if p == Shard(0) and x.shape[0] == q.shape[0] else
                Shard(x.ndim - 2) if p == Shard(1) and x.shape[-2] == S
                else Replicate() for p in pq]
    out = fn(local(q, pq), local(k, pk, gk), local(v, pk, gk),
             *(local(x, follow(x)) for x in rest))
    # contiguous: DTensor's views assume a contiguous local tensor
    return DTensor.from_local(out.contiguous(), mesh, pq, run_check=False)


def gather_rows(table, ids):
    """``indexing.take(table, ids)``: the rows of ``table`` [V, d] at
    ``ids`` by JAX's gather rule.  On a mesh it runs on each device's
    shards (DTensor's own gather strategies differ between releases, and
    one breaks in the backward), per mesh dimension: the ids' batch
    sharding kept, the table gathered there (its gradient a partial
    sum); else a table sharded on its rows (the vocabulary) kept, each
    device gathering the rows it holds and zeros elsewhere (a partial
    sum); else a table sharded on d kept (the output sharded on d); else
    replicated."""
    from repro_torch.indexing import gather_index, take

    if not (is_dtensor(table) or is_dtensor(ids)):
        return take(table, ids)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = (table if is_dtensor(table) else ids).device_mesh
    rep = [Replicate()] * mesh.ndim
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, rep, run_check=False)
    if not is_dtensor(table):
        table = DTensor.from_local(table, mesh, rep, run_check=False)
    pt, gt, pi, py = [], [], [], []
    for a, b in zip(table.placements, ids.placements):
        if getattr(b, "dim", None) is not None:         # batch-like ids
            pt.append(Replicate()), gt.append(Partial())
            pi.append(b), py.append(b)
        elif a == Shard(0):                              # vocabulary rows
            pt.append(a), gt.append(a), pi.append(Replicate())
            py.append(Partial())
        elif a == Shard(1):
            pt.append(a), gt.append(a), pi.append(Replicate())
            py.append(Shard(ids.ndim))
        else:
            pt.append(Replicate()), gt.append(Replicate())
            pi.append(Replicate()), py.append(Replicate())
    tl = table.redistribute(mesh, pt).to_local(grad_placements=gt)
    il = gather_index(ids.redistribute(mesh, pi).to_local(), table.shape[0])
    n, off = tl.shape[0], 0
    for i, p in enumerate(pt):
        if p == Shard(0):
            off = off * mesh.size(i) + mesh.get_local_rank(i) * n
    if n == table.shape[0]:
        out = tl[il]
    else:       # the rows this device holds; zeros for the others
        j = il - off
        hit = (j >= 0) & (j < n)
        out = tl[j.clamp(0, n - 1)] * hit[..., None].to(tl.dtype)
    return DTensor.from_local(out.contiguous(), mesh, py, run_check=False)
