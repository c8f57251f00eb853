"""Roofline terms of a traced dry-run step, as the JAX package's
``repro.launch.roofline``, for an NVIDIA H100 SXM.

Hardware model (per device, the H100 SXM data sheet):
  PEAK_FLOPS   = 989e12  dense bf16 FLOP/s (tensor cores, no sparsity)
  HBM_BW       = 3.35e12 B/s HBM3
  LINK_BW      = 450e9   B/s NVLink 4, each direction (900 GB/s both)
  HBM_PER_CHIP = 80e9    B of HBM

Terms (per train/serve step, seconds):
  compute    = FLOPs / (chips × peak)
  memory     = HBM bytes / (chips × hbm_bw)
  collective = collective bytes per device / link_bw

The JAX package reads its collectives off the compiled HLO text, with
trip-count multipliers for the ``while`` loops its scans lower to.  The
port has no HLO: ``CollectiveCounter`` is a dispatch mode that sees every
``_c10d_functional`` collective a traced step issues (DTensor's
redistributions and reductions) and sums the bytes of each result, by
kind, for the device it runs as.  The port's layers and microbatches are
Python loops that issue every collective they run, so no trip-count
correction is needed.  The same mode counts the FLOPs of every local
(per-device) op with ``FlopCounterMode``'s formulas
(``torch.utils.flop_counter.flop_registry``): per device, where
``FlopCounterMode`` itself, which sees the global DTensor ops, would count
the global work.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
HBM_PER_CHIP = 80e9

# the collective kinds, by the JAX package's names
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


_PROPAGATING = [0]


def _watch_propagation() -> None:
    """Marks (in ``_PROPAGATING``) the ops DTensor runs on global-shape
    fake tensors to propagate shapes, which are no device's work.
    Installed once, a pass-through wrapper."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(orig, "_marks_propagation", False):
        return

    def wrapped(self, op_schema):
        _PROPAGATING[0] += 1
        try:
            return orig(self, op_schema)
        finally:
            _PROPAGATING[0] -= 1
    wrapped._marks_propagation = True
    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped


class LocalOps(TorchDispatchMode):
    """A dispatch mode that hands each op one device runs to ``local_op``:
    a DTensor op is let through to DTensor (``NotImplemented``), so the
    mode sees the local ops and the collectives DTensor issues for it; the
    ops of DTensor's shape propagation are not handed on."""

    def __enter__(self):
        _watch_propagation()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _PROPAGATING[0]:
            self.local_op(func, args, kwargs, out)
        return out

    def local_op(self, func, args, kwargs, out) -> None:
        raise NotImplementedError


class CollectiveCounter(LocalOps):
    """Counts, while it is active, the result bytes of every collective by
    kind (``by_kind``: "all-gather", "reduce-scatter", "all-reduce",
    "all-to-all", "collective-permute") and the FLOPs of every local op
    (``flops``), both for this rank's device."""

    def __init__(self):
        super().__init__()
        self.by_kind: Dict[str, int] = {}
        self.flops = 0

    def local_op(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        name = func.overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "_dtensor", "c10d") \
                and name in _KINDS:
            kind = _KINDS[name]
            self.by_kind[kind] = self.by_kind.get(kind, 0) + _nbytes(out)
        elif func.overloadpacket in flop_registry:
            self.flops += int(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))


def roofline_terms(cost: dict, coll: Dict[str, int], chips: int,
                   model_flops: float) -> dict:
    """cost: per-device {"flops", "bytes accessed"}; coll: per-device
    collective bytes by kind; model_flops: 6·N·D useful FLOPs (global)."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll_dev = float(sum(coll.values()))
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    hlo_flops_global = flops_dev * chips
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "hlo_flops_per_dev": flops_dev,
        "hlo_bytes_per_dev": bytes_dev,
        "collective_bytes_per_dev": coll_dev,
        "collective_by_kind": coll,
        "model_flops": model_flops,
        "useful_flops_fraction": (model_flops / hlo_flops_global
                                  if hlo_flops_global else 0.0),
        # roofline fraction: useful compute time over the achievable step
        # time (max of the three terms) — the score we hillclimb
        "roofline_fraction": (
            (model_flops / (chips * PEAK_FLOPS)) /
            max(t_compute, t_memory, t_coll, 1e-12)),
    }


def model_flops_for(cfg, shape, mode: str) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode counts one token per seq."""
    n = cfg.n_active_params() if cfg.moe.n_experts else cfg.n_params()
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: 2·N per token + attention reads (memory-bound; FLOPs small)
    return 2.0 * n * shape.global_batch
