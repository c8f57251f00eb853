"""JAX's indexing rules, for the port's tables, pools and table walks.

The reference keeps its tables and pools in JAX arrays, and JAX never
faults on an index:

* a gather (``x[i]``) wraps a negative index once (``i + n``), then clamps
  it into ``[0, n - 1]``;
* a scatter (``x.at[i].set(v)`` / ``.add(v)``) wraps a negative index once
  and drops the write when the index is still out of range.

PyTorch raises on both (and device-asserts on CUDA).  ``wrap`` is the one
place the wrap-once rule lives; ``gather_index``, ``take`` and ``put``
build on it and give the reference's result for every index, without a
host sync.  Plain Python ints (the control plane's coordinates) are
resolved on the host, so they cost no index tensors.
"""
from __future__ import annotations

import math

import torch


def wrap(i, n: int):
    """A negative index into a dimension of size ``n`` wraps once; an int
    stays an int, a tensor stays a tensor."""
    if isinstance(i, int):
        return i + n if i < 0 else i
    return torch.where(i < 0, i + n, i)


def gather_index(i, n: int):
    """JAX's gather rule: wrap once, then clamp into ``[0, n - 1]`` (a
    tensor comes back as int64)."""
    if isinstance(i, int):
        return min(max(wrap(i, n), 0), n - 1)
    return wrap(i.long(), n).clamp(0, n - 1)


def _all_ints(idx) -> bool:
    return all(type(i) is int for i in idx)


def take(x: torch.Tensor, *idx) -> torch.Tensor:
    """``x[idx]`` by the gather rule; the indices broadcast against each
    other and the dimensions they do not name are kept."""
    if _all_ints(idx):
        return x[tuple(gather_index(i, n) for i, n in zip(idx, x.shape))]
    return x[tuple(gather_index(torch.as_tensor(i, device=x.device), n)
                   for i, n in zip(idx, x.shape))]


def put(x: torch.Tensor, idx, val, add: bool = False) -> torch.Tensor:
    """``x.at[idx].set(val)`` (``.add(val)`` with ``add``) by the scatter
    rule, as a new tensor; ``idx`` is a tuple of indices of the leading
    dimensions."""
    if _all_ints(idx):
        js = [wrap(i, n) for i, n in zip(idx, x.shape)]
        out = x.clone()
        if all(0 <= j < n for j, n in zip(js, x.shape)):
            if add:
                out[tuple(js)] += val
            else:
                out[tuple(js)] = val
        return out
    lead, trail = x.shape[:len(idx)], x.shape[len(idx):]
    rows = math.prod(lead)
    ii = [torch.as_tensor(i, device=x.device).long() for i in idx]
    shape = torch.broadcast_shapes(*(i.shape for i in ii))
    flat = torch.zeros(shape, dtype=torch.long, device=x.device)
    keep = torch.ones(shape, dtype=torch.bool, device=x.device)
    for i, n in zip(ii, lead):
        j = wrap(i, n)
        keep = keep & (j >= 0) & (j < n)
        flat = flat * n + j.clamp(0, n - 1)
    # a dropped write lands in a spare row that is cut off afterwards
    flat = torch.where(keep, flat, rows)
    buf = torch.cat([x.reshape(rows, *trail), x.new_zeros((1, *trail))])
    v = torch.as_tensor(val, dtype=x.dtype, device=x.device)
    buf.index_put_((flat,), v.expand((*shape, *trail)), accumulate=add)
    return buf[:rows].reshape(x.shape)
