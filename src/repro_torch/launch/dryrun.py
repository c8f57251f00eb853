"""Multi-pod dry run: trace every (arch × shape × mesh) cell once, in one
process, on a ``fake`` process group with ``FakeTensorMode`` tensors (no
allocation, no data), and report the bytes a device holds, the FLOPs, the
collective bytes and the roofline terms, as the JAX package's
``repro.launch.dryrun``.

Where JAX lowers and compiles the jitted step, the port runs its own step
once on fake tensors:

* ``dist.init_process_group("fake", ...)`` as rank 0 of a world as large
  as the mesh (256 or 512); the mesh is ``launch/mesh.py``'s;
* the parameters, the optimizer state and the inputs are DTensors placed
  by ``_fb_shardings`` (JAX's rule: a mesh axis that does not divide its
  dimension is dropped), the activation hooks of ``_install_seq_shard``
  are ``redistribute`` calls;
* the train step (``runtime/train_loop.build_train_step`` with
  ``grad_shardings``), ``prefill`` or ``decode_step`` runs once under
  ``LiveBytes`` (the peak of the live bytes of this rank's device, as
  ``MemTracker`` counts them, ``memory.per_device_live_bytes``) and
  ``roofline.CollectiveCounter`` (collective bytes by kind and the FLOPs
  of the local ops, ``traced_flops_per_dev``).

The roofline terms are ``analytic``'s, exactly as JAX's (``exec_flops``,
``hbm_bytes``), with the H100 constants of ``roofline.py``; the collective
term is the traced collectives'.  ``t_compute_traced_s`` is the compute
term of the port's own step, its traced FLOPs a device over the peak:
where it exceeds ``t_compute_s`` the port repeats work that JAX's
layout splits.  Records go to ``--out`` (default
``dryrun_out/``), one JSON file a cell; a failing cell is recorded as
``status: "error"`` and the sweep goes on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm_2b \\
      --shape train_4k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Optional, Sequence

import torch
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import analytic
from repro_torch.launch import specs as SPECS
from repro_torch.launch.roofline import (HBM_BW, HBM_PER_CHIP, LINK_BW,
                                         PEAK_FLOPS, CollectiveCounter,
                                         LocalOps)
from repro_torch.models import activation_sharding
from repro_torch.models import transformer as tf
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.runtime.sharding import (ShardingPolicy, default_policy,
                                          fit_spec, map_specs, placements,
                                          tp_only_policy)
from repro_torch.runtime.train_loop import build_train_step

# Per-arch dry-run overrides: dtype/microbatching, as the JAX package's.
ARCH_OVERRIDES = {
    "nemotron_4_340b": {"param_dtype": "bfloat16", "microbatches": 16,
                        "seq_shard": True, "remat": "full",
                        "low_mem_opt": True},   # bf16 m/v + bf16 grad accum
    "qwen15_32b": {"microbatches": 8, "seq_shard": True},      # 40 heads
    "qwen3_moe_30b_a3b": {"microbatches": 8},
    "recurrentgemma_9b": {"microbatches": 8},
    "minicpm_2b": {"microbatches": 8},  # 36 heads: query-row attention
    "granite_moe_3b_a800m": {"microbatches": 8},  # 24 heads
    "h2o_danube_3_4b": {"microbatches": 8},
    "internvl2_2b": {"microbatches": 8},
    "whisper_base": {"microbatches": 4},  # 8 heads
    "mamba2_130m": {"microbatches": 2},
}

MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _fb_specs(mesh, pol: ShardingPolicy, spec_tree, shape_tree):
    """Logical specs → resolved specs, dropping any axis that does not
    divide its dimension (vocab/expert/head remainders)."""
    return map_specs(lambda s, x: fit_spec(mesh, pol.resolve(s),
                                           tuple(x.shape)),
                     spec_tree, shape_tree)


def _fb_shardings(mesh, pol: ShardingPolicy, spec_tree, shape_tree):
    """``_fb_specs`` as DTensor placements on ``mesh``."""
    return map_specs(lambda s: placements(mesh, s),
                     _fb_specs(mesh, pol, spec_tree, shape_tree))


def _policy_for(mesh, mode: str, arch: str,
                policy_name: str = "default") -> ShardingPolicy:
    ov = ARCH_OVERRIDES.get(arch, {})
    mb = ov.get("microbatches", 8) if mode == "train" else 1
    if policy_name == "tp_only":
        return tp_only_policy(mesh, microbatches=mb)
    return default_policy(mesh, microbatches=mb)


def _redistribute_to(mesh, spec, when):
    """An activation hook: a DTensor ``x`` for which ``when(x)`` holds is
    redistributed to the resolved ``spec``; anything else passes."""
    pl = placements(mesh, spec)

    def c(x):
        if activation_sharding.is_dtensor(x) and when(x):
            return x.redistribute(mesh, pl)
        return x
    return c


def _install_seq_shard(mesh, pol, on: bool):
    """Sequence-parallel activation hooks (large archs): the JAX
    package's, with each ``with_sharding_constraint`` a ``redistribute``.
    Two of JAX's have no counterpart here.  Its train/prefill "scores"
    hook (archs whose head count does not divide tp would otherwise
    replicate S×T score buffers) is the port's attention's own layout:
    ``activation_sharding.by_heads`` shards the query rows where the heads
    cannot stay whole.  The port's MoE places its dispatch buffers by the
    expert weights (``models/moe.py``), so the "moe" hooks have no call
    site."""
    dp = pol.rules.get("dp")
    tp = pol.rules.get("tp")
    hook = activation_sharding.set_constraint
    hook(_redistribute_to(mesh, (dp, tp, None), lambda x: x.ndim == 3)
         if on else None, "block")
    hook(_redistribute_to(mesh, (dp, None, None), lambda x: x.ndim == 3)
         if on else None, "inner")
    hook(_redistribute_to(mesh, (dp, tp, None) if on else (dp, None, None),
                          lambda x: x.ndim == 3 and x.shape[1] % 16 == 0),
         "embed")
    hook(_redistribute_to(mesh, (dp, None, tp), lambda x: x.ndim == 3),
         "logits")
    hook(None, "scores")


def _fake_world(n: int, device_type: str):
    """The fake process group, as rank 0 of ``n`` ranks (made once a
    process; a later mesh may be as large or smaller)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    if dist.get_world_size() < n:
        raise RuntimeError(f"the process group has {dist.get_world_size()} "
                           f"ranks, the mesh {n}")
    if device_type == "cuda":
        torch.cuda.set_device(0)


def _mesh(mesh_shape: Sequence[int], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    _fake_world(math.prod(mesh_shape), device_type)
    return init_device_mesh(device_type, tuple(mesh_shape),
                            mesh_dim_names=MESH_AXES[len(mesh_shape)])


def _distribute(mesh, tree, pl_tree):
    """Each tensor of ``tree`` (dicts, lists, named tuples; None stays)
    as a DTensor on its placements, made from local shards (no global
    tensor is materialised)."""
    from torch.distributed.tensor import empty as dt_empty

    def one(x, pl):
        return dt_empty(tuple(x.shape), dtype=x.dtype, device_mesh=mesh,
                        placements=pl)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return one(tree, pl_tree)
    if isinstance(tree, dict):
        return {k: _distribute(mesh, v, pl_tree[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_distribute(mesh, v, getattr(pl_tree, f))
                            for f, v in zip(tree._fields, tree)))
    return type(tree)(_distribute(mesh, v, p) for v, p in zip(tree, pl_tree))


def _lm_on(mesh, cfg, pdtype, pl) -> tf.LM:
    """The ``LM`` with each parameter a DTensor on its placements."""
    lm = tf.LM(cfg, device="meta", dtype=pdtype)
    for name, p in list(lm.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = lm.get_submodule(mod_name) if mod_name else lm
        d = _distribute(mesh, p, pl[name])
        setattr(mod, leaf, torch.nn.Parameter(d, requires_grad=False))
    return lm


class LiveBytes(LocalOps):
    """The peak, while it is active, of the bytes this device holds: every
    storage a local op makes is counted from its creation until it is
    freed, each storage once; ``track`` counts tensors made before.  As
    ``MemTracker`` counts, without its per-module bookkeeping (which
    refuses a module called twice in one step, as microbatches call
    it)."""

    def __init__(self):
        super().__init__()
        self._seen = WeakIdKeyDictionary()
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def track(self, t) -> None:
        if activation_sharding.is_dtensor(t):
            t = t.to_local()
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def local_op(self, func, args, kwargs, out) -> None:
        # a wait's result is its input (a fake wait makes a new tensor)
        if func is not torch.ops._c10d_functional.wait_tensor.default:
            for t in tree_flatten(out)[0]:
                self.track(t)


def _traced(fn, external):
    """Runs ``fn()`` once under ``LiveBytes`` (``external``: the tensors
    and modules made before it, counted from the start) and
    ``CollectiveCounter``; returns (peak live bytes of this device, the
    counter)."""
    live = LiveBytes()
    for x in external:
        for t in (x.parameters() if isinstance(x, torch.nn.Module)
                  else [x]):
            live.track(t)
    counter = CollectiveCounter()
    with live, counter:
        fn()
    return live.peak, counter


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             policy_name: str = "default", seq_shard: Optional[bool] = None,
             microbatches: Optional[int] = None,
             param_dtype: Optional[str] = None, *,
             mesh_shape: Optional[Sequence[int]] = None,
             shape: Optional[ShapeConfig] = None, reduced: bool = False,
             device: Optional[str] = None) -> dict:
    """One cell.  ``mesh_shape`` (2 or 3 axes: data, model / pod, data,
    model) replaces the production mesh, ``shape`` the named
    ``SHAPES`` entry, ``reduced`` the full config; ``device`` is the fake
    tensors' device type (default ``cuda``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch, reduced=reduced)
    ov = ARCH_OVERRIDES.get(arch, {})
    if "remat" in ov:
        cfg = dataclasses.replace(cfg, remat=ov["remat"])
    shape = shape or SHAPES[shape_name]
    mode = shape.kind
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mode": mode,
           "multi_pod": multi_pod, "policy": policy_name}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    device_type = torch.device(device or "cuda").type
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod
                                      else (16, 16)))
    t0 = time.time()
    try:
        mesh = _mesh(mesh_shape, device_type)
        chips = mesh.size()
        rec["mesh"] = list(mesh_shape)
        pol = _policy_for(mesh, mode, arch, policy_name)
        if microbatches is not None and mode == "train":
            pol = dataclasses.replace(pol, microbatches=microbatches)
        pdtype = param_dtype or ov.get("param_dtype")
        seq_on = ov.get("seq_shard", False) if seq_shard is None \
            else seq_shard
        _install_seq_shard(mesh, pol, seq_on and mode == "train")
        if mode == "decode":
            # flash-decode sharding: scores stay sharded on the KEY dim
            activation_sharding.set_constraint(_redistribute_to(
                mesh, (pol.rules.get("dp"), None, None, pol.rules.get("tp")),
                lambda x: x.ndim == 4 and x.shape[-1] % 16 == 0), "scores")
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, external = _build(cfg, shape, mode, mesh, pol, pdtype, ov)
            t_build = time.time() - t0
            peak, counter = _traced(step, external)
        t_trace = time.time() - t0 - t_build
        coll = dict(sorted(counter.by_kind.items()))
        remat = cfg.remat
        pbytes = 2 if (pdtype == "bfloat16" or mode != "train") else 4
        ex_flops = analytic.exec_flops(cfg, shape, mode, remat)
        us_flops = analytic.useful_flops(cfg, shape, mode)
        hbm = analytic.hbm_bytes(cfg, shape, mode, pbytes)
        t_compute = ex_flops / (chips * PEAK_FLOPS)
        t_memory = hbm / (chips * HBM_BW)
        coll_dev = float(sum(coll.values()))
        t_coll = coll_dev / LINK_BW
        t_max = max(t_compute, t_memory, t_coll, 1e-12)
        dominant = {t_compute: "compute", t_memory: "memory",
                    t_coll: "collective"}[t_max]
        terms = {
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "dominant": dominant,
            "exec_flops": ex_flops,
            "model_flops": us_flops,
            "useful_flops_fraction": us_flops / max(ex_flops, 1.0),
            "analytic_hbm_bytes": hbm,
            "collective_bytes_per_dev": coll_dev,
            "collective_by_kind": coll,
            "traced_flops_per_dev": float(counter.flops),
            "t_compute_traced_s": float(counter.flops) / PEAK_FLOPS,
            "roofline_fraction": (us_flops / (chips * PEAK_FLOPS)) / t_max,
            "memory_bound_fraction": t_memory / t_max,
        }
        rec.update(
            status="ok",
            chips=chips,
            build_s=round(t_build, 1),
            trace_s=round(t_trace, 1),
            memory={
                "per_device_live_bytes": int(peak),
                "fits_h100_80g": bool(peak <= HBM_PER_CHIP),
            },
            roofline=terms,
            microbatches=pol.microbatches,
            seq_shard=bool(seq_on and mode == "train"),
            param_dtype=pdtype or "float32",
        )
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    finally:
        activation_sharding.clear()
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def _build(cfg, shape, mode, mesh, pol, pdtype, ov):
    """(the step to trace, the tensors made before it) of one cell, on
    fake tensors."""
    if mode == "train":
        dtype = torch.bfloat16 if pdtype == "bfloat16" else torch.float32
        low_mem = ov.get("low_mem_opt", False)
        mdtype = torch.bfloat16 if low_mem else torch.float32
        pshapes, pspecs = SPECS.abstract_params(cfg, dtype=dtype)
        oshapes, ospecs = SPECS.abstract_opt_state(pshapes, pspecs,
                                                   dtype=mdtype)
        bshapes, bspecs = SPECS.train_inputs(cfg, shape)
        psh = _fb_shardings(mesh, pol, pspecs, pshapes)
        lm = _lm_on(mesh, cfg, dtype, psh)
        opt = _distribute(mesh, oshapes,
                          _fb_shardings(mesh, pol, ospecs, oshapes))
        batch = _distribute(mesh, bshapes,
                            _fb_shardings(mesh, pol, bspecs, bshapes))
        step = build_train_step(cfg, pol, cosine_schedule(3e-4, 100, 10000),
                                grad_shardings=psh, accum_dtype=mdtype)
        return (lambda: step(lm, opt, batch, 0),
                [lm, *opt.m.values(), *opt.v.values(), opt.step,
                 *batch.values()])
    pshapes, pspecs = SPECS.abstract_params(cfg, dtype=torch.bfloat16)
    lm = _lm_on(mesh, cfg, torch.bfloat16,
                _fb_shardings(mesh, pol, pspecs, pshapes))
    if mode == "prefill":
        (tokens, cache_s, extra), (tsp, csp, esp) = \
            SPECS.prefill_inputs(cfg, shape)
        args = [tokens, cache_s, extra]
        specs = [tsp, csp, esp]
    else:
        (token, pos, cache_s), (ksp, psp, csp) = \
            SPECS.decode_inputs(cfg, shape)
        args = [token, pos, cache_s]
        specs = [ksp, psp, csp]
    args = [None if a is None else _distribute(
        mesh, a, _fb_shardings(mesh, pol, s, a))
        for a, s in zip(args, specs)]
    from torch.distributed.tensor.experimental import implicit_replication

    def step():
        # the plain tensors the model makes count as replicated
        with implicit_replication():
            if mode == "prefill":
                tokens, cache, extra = args
                tf.prefill(lm, cfg, tokens, cache, extra_embeds=extra)
            else:
                tf.decode_step(lm, cfg, *args)
    return step, [lm, *[x for a in args if a is not None
                        for x in (_leaves(a) if isinstance(a, list)
                                  else [a])]]


def _leaves(cache):
    return [x for layer in cache for x in layer.values()]


def _print(rec: dict) -> None:
    if rec["status"] == "ok":
        r = rec["roofline"]
        print(f"  ok: trace {rec['trace_s']}s  "
              f"mem/dev {rec['memory']['per_device_live_bytes'] / 1e9:.2f}GB "
              f"terms(c/m/x) {r['t_compute_s']:.3e}/"
              f"{r['t_memory_s']:.3e}/{r['t_collective_s']:.3e} "
              f"dom={r['dominant']} frac={r['roofline_fraction']:.3f}",
              flush=True)
    else:
        print(f"  {rec['status']}: {rec.get('reason', rec.get('error'))}",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--policy", default="default")
    ap.add_argument("--out", default="dryrun_out")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs (a quick sweep)")
    ap.add_argument("--mesh", default="",
                    help="a mesh shape in place of the production one, "
                    "e.g. 2,4 (data, model) or 2,2,2 (pod, data, model)")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default: cuda)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        cells.append((args.arch, args.shape))
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    mesh_shape = tuple(int(n) for n in args.mesh.split(",")) \
        if args.mesh else None
    # one fake world for every mesh of the sweep
    _fake_world(math.prod(mesh_shape) if mesh_shape else
                (512 if any(meshes) else 256),
                torch.device(args.device or "cuda").type)

    records = []
    for multi_pod in meshes:
        for arch, shape in cells:
            tag = f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}"
            if args.policy != "default":
                tag += f"__{args.policy}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip existing] {tag}")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            rec = run_cell(arch, shape, multi_pod, policy_name=args.policy,
                           mesh_shape=mesh_shape, reduced=args.reduced,
                           device=args.device)
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
            _print(rec)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
