"""The mesh half of the port against the JAX package: the logical specs
(``transformer.logical_specs``, ``cache_specs``, ``launch/specs``), their
resolution under every policy, the dry run's divide rule, and the sharded
train step (DTensor on a ``DeviceMesh``) in 4 gloo processes against
JAX's jitted step on 4 host devices, with a restore onto the shardings.

Every many-process or many-device run is a subprocess: the JAX one with
``XLA_FLAGS`` forcing 4 (or 512) host devices, the port's 4 gloo ranks
spawned from one script and joined through a ``FileStore`` under the
test's ``tmp_path``.  Nothing here initialises a process group in the
test process.

Tolerances: the sharded steps run in fp32 (``COMPUTE_DTYPE`` switched on
both sides, ``grad_compress_dtype=None``) and are held within
``tests/test_torch_train.py``'s ``FP32`` dict: losses and gradient norms
1e-5 relative, each parameter's update since the start 2e-4 by relative
norm.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.data.pipeline import SyntheticLMData as JData
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro.runtime import sharding as jsharding
from repro_torch import configs
from repro_torch.launch import specs as SPECS
from repro_torch.launch.dryrun import _fb_specs
from repro_torch.models import transformer as TF
from repro_torch.runtime import sharding

ROOT = Path(__file__).resolve().parents[1]
FP32 = dict(loss=1e-5, update=2e-4)
MESHES = {"sp": (("data", "model"), (16, 16)),
          "mp": (("pod", "data", "model"), (2, 16, 16))}
POLICIES = ("default_policy", "tp_only_policy", "seq_shard_policy")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spec(s):
    """A spec as a tuple of axes, a one-name tuple as the name (JAX's
    ``PartitionSpec`` and JSON lists alike)."""
    out = []
    for ax in tuple(s):
        if isinstance(ax, (list, tuple)):
            ax = tuple(ax)
            ax = ax[0] if len(ax) == 1 else (ax or None)
        out.append(ax)
    return tuple(out)


def _is_leaf(x):
    return not isinstance(x, dict)


def _walk(tree, prefix=""):
    """(dotted path, leaf) of a nested dict."""
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if _is_leaf(v):
            yield path, v
        else:
            yield from _walk(v, path)


def _by_port_name(cfg, tree):
    """A tree of JAX's ``init_lm`` structure keyed by the port's parameter
    names: {name: (leaf, stacked)}; a stacked leaf is JAX's superblock,
    encoder-block or cross stack."""
    pat = cfg.block_pattern or ("attn",)
    n_super = cfg.n_layers // len(pat)
    out = {}
    for k, v in tree.items():
        if k == "layers":
            for s in range(n_super):
                for i, kind in enumerate(pat):
                    for sub, x in _walk(v[f"b{i}_{kind}"]):
                        out[f"layers.{s * len(pat) + i}.{sub}"] = (x, True)
        elif k.startswith("rem"):
            j = int(k[3:].split("_")[0])
            for sub, x in _walk(v):
                out[f"layers.{n_super * len(pat) + j}.{sub}"] = (x, False)
        elif k == "encoder":
            for sub, x in _walk(v["blocks"]):
                for i in range(cfg.n_enc_layers):
                    out[f"encoder.blocks.{i}.{sub}"] = (x, True)
            for sub, x in _walk(v["final_norm"]):
                out[f"encoder.final_norm.{sub}"] = (x, False)
        elif k == "cross":
            for sub, x in _walk(v):
                for i in range(cfg.n_layers):
                    out[f"cross.{i}.{sub}"] = (x, True)
        elif _is_leaf(v):
            out[k] = (v, False)
        else:
            for sub, x in _walk(v):
                out[f"{k}.{sub}"] = (x, False)
    return out


def _unstacked(spec, stacked):
    spec = _spec(spec)
    if stacked:
        assert spec[0] is None
        return spec[1:]
    return spec


def _jax_cache_layers(cfg, jtree):
    """JAX's cache tree (of specs) as the port's per-layer list."""
    pat = cfg.block_pattern or ("attn",)
    n_scanned = cfg.n_layers // len(pat) * len(pat)
    out = []
    for i, kind in enumerate(TF.layer_kinds(cfg)):
        if i < n_scanned:
            ent = {n: _unstacked(s, True) for n, s in
                   jtree["layers"][f"b{i % len(pat)}_{kind}"].items()}
        else:
            ent = {n: _spec(s) for n, s in
                   jtree[f"rem{i - n_scanned}_{kind}"].items()}
        if cfg.is_enc_dec:
            ent.update(cross_k=_unstacked(jtree["cross_k"], True),
                       cross_v=_unstacked(jtree["cross_v"], True))
        out.append(ent)
    return out


def _configs(arch):
    return configs.get_config(arch), jconfigs.get_config(arch)


# ---------------------------------------------------------------------------
# 1. spec trees
# ---------------------------------------------------------------------------

def _jax_trees(arch):
    cfg, jcfg = _configs(arch)
    _, jparams = jspecs.abstract_params(jcfg)
    return cfg, jcfg, _by_port_name(cfg, jparams)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_logical_specs_match_jax(arch):
    """Every parameter's spec is JAX's (a stacked leaf's without its
    leading None), keyed as ``named_parameters()``; ``init_lm(...,
    with_specs=True)`` and ``launch/specs.abstract_params`` give the same
    tree, with JAX's shapes and dtypes."""
    cfg, jcfg = _configs(arch)
    captured = {}

    def build(key):
        params, specs = jtf.init_lm(jcfg, key)
        captured["specs"] = specs
        return params
    jshapes = _by_port_name(cfg, jax.eval_shape(build,
                                                jax.random.PRNGKey(0)))
    jspec = _by_port_name(cfg, captured["specs"])
    mine = TF.logical_specs(cfg)
    assert mine.keys() == jspec.keys()
    for name, (s, stacked) in jspec.items():
        assert mine[name] == _unstacked(s, stacked), name
    lm, specs = TF.init_lm(cfg, 0, device="meta", with_specs=True)
    assert specs == mine
    assert list(specs) == [n for n, _ in lm.named_parameters()]
    shapes, aspecs = SPECS.abstract_params(cfg, dtype=torch.bfloat16)
    assert aspecs == mine
    for name, (sds, stacked) in jshapes.items():
        want = sds.shape[1:] if stacked else sds.shape
        assert tuple(shapes[name].shape) == tuple(want), name
        assert shapes[name].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cache_and_input_specs_match_jax(arch):
    """``cache_specs`` for every layer kind, and ``train_inputs``,
    ``prefill_inputs`` and ``decode_inputs``: JAX's shapes, dtypes and
    specs."""
    cfg, jcfg = _configs(arch)
    for B, S in ((3, 64), (2, 8192)):
        want = _jax_cache_layers(cfg, jtf.cache_specs(jcfg, B, S))
        assert TF.cache_specs(cfg, B, S) == want
    for name, shape in configs.SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        ok, _ = configs.shape_applicable(cfg, shape)
        if not ok:
            continue
        batch, bspec = SPECS.train_inputs(cfg, shape)
        jbatch, jbspec = jspecs.train_inputs(jcfg, jshape)
        assert batch.keys() == jbatch.keys()
        for k in batch:
            assert tuple(batch[k].shape) == jbatch[k].shape
            assert str(batch[k].dtype) == f"torch.{jbatch[k].dtype}"
            assert bspec[k] == _spec(jbspec[k])
        (tok, cache, extra), (tsp, csp, esp) = SPECS.prefill_inputs(cfg,
                                                                    shape)
        (jtok, jcache, jextra), (jtsp, jcsp, jesp) = \
            jspecs.prefill_inputs(jcfg, jshape)
        assert tuple(tok.shape) == jtok.shape and tsp == _spec(jtsp)
        assert csp == _jax_cache_layers(cfg, jcsp)
        assert (extra is None) == (jextra is None)
        if extra is not None:
            assert tuple(extra.shape) == jextra.shape
            assert esp == _spec(jesp)
        (t1, p1, cache), (s1, s2, csp) = SPECS.decode_inputs(cfg, shape)
        (jt1, jp1, jcache), (js1, js2, jcsp) = jspecs.decode_inputs(jcfg,
                                                                    jshape)
        assert tuple(t1.shape) == jt1.shape and tuple(p1.shape) == jp1.shape
        assert (s1, s2) == (_spec(js1), _spec(js2))
        assert csp == _jax_cache_layers(cfg, jcsp)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_resolved_specs_match_jax(arch, mesh):
    """Every parameter, cache and input spec resolved under ``default``,
    ``tp_only``, ``seq_shard`` and ``single`` on the production meshes'
    axis names, as JAX resolves it; the policies also take a mesh
    object by its ``mesh_dim_names``."""
    cfg, jcfg = _configs(arch)
    axes, _ = MESHES[mesh]
    specs = set(TF.logical_specs(cfg).values())
    for layer in TF.cache_specs(cfg, 2, 64):
        specs |= set(layer.values())
    specs |= set(SPECS.train_inputs(cfg, configs.SHAPES["train_4k"])[1]
                 .values())
    specs |= {("dp",), ("dp", None), ()}
    jmesh = types.SimpleNamespace(axis_names=axes)
    dmesh = types.SimpleNamespace(mesh_dim_names=axes)
    pols = [(getattr(sharding, n)(dmesh), getattr(jsharding, n)(jmesh))
            for n in POLICIES]
    pols.append((sharding.single_device_policy(),
                 jsharding.single_device_policy()))
    for mine, theirs in pols:
        assert mine.rules == theirs.rules
        for s in specs:
            assert mine.resolve(s) == _spec(theirs.resolve(P(*s))), s
    # the mesh half: placements follow the resolved spec
    from torch.distributed.tensor import Replicate, Shard
    pol = sharding.default_policy(dmesh)
    pl = pol.shard(dmesh, ("fsdp", "tp"))
    want = {"pod": Shard(0), "data": Shard(0), "model": Shard(1)}
    assert pl == [want[a] for a in axes]
    assert pol.shard(dmesh, ()) == [Replicate()] * len(axes)


# ---------------------------------------------------------------------------
# 2. the dry run's divide rule
# ---------------------------------------------------------------------------

JAX_FB = r"""
import json, sys
from repro.launch import dryrun as D      # forces 512 host devices first
import jax
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch import specs as S
from repro.launch.mesh import make_production_mesh

def specs_of(tree):
    if isinstance(tree, dict):
        return {k: specs_of(v) for k, v in tree.items()}
    return [list(a) if isinstance(a, tuple) else a for a in tuple(tree.spec)]

out = {}
for multi_pod in (False, True):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch in ARCHS:
        cfg = get_config(arch)
        pol = D._policy_for(mesh, "train", arch)
        pshapes, pspecs = S.abstract_params(cfg)
        bshapes, bspecs = S.train_inputs(cfg, SHAPES["train_4k"])
        (_, _, cshapes), (_, _, cspecs) = S.decode_inputs(
            cfg, SHAPES["decode_32k"])
        out[f"{arch}/{'mp' if multi_pod else 'sp'}"] = {
            "params": specs_of(D._fb_shardings(mesh, pol, pspecs, pshapes)),
            "batch": specs_of(D._fb_shardings(mesh, pol, bspecs, bshapes)),
            "cache": specs_of(D._fb_shardings(mesh, pol, cspecs, cshapes))}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_fb(subprocesses):
    _wait(subprocesses, "fb")
    return json.loads(subprocesses["tmp"].joinpath("fb.json").read_text())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_divide_rule_matches_jax(jax_fb, arch, mesh):
    """``dryrun._fb_specs`` on every parameter (fp32 training shapes),
    the train_4k batch and the decode_32k cache equals JAX's
    ``_fb_shardings`` on the production mesh (a subprocess with 512 forced
    host devices): a mesh axis that does not divide its dimension is
    dropped."""
    cfg = configs.get_config(arch)
    axes, shape = MESHES[mesh]
    dmesh = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
    from repro_torch.launch.dryrun import _policy_for
    pol = _policy_for(dmesh, "train", arch)
    want = jax_fb[f"{arch}/{mesh}"]
    pshapes, pspecs = SPECS.abstract_params(cfg)
    got = _fb_specs(dmesh, pol, pspecs, pshapes)
    jwant = _by_port_name(cfg, want["params"])
    assert got.keys() == jwant.keys()
    for name, (s, stacked) in jwant.items():
        # a stacked leaf's leading (layer) axis is never sharded
        assert got[name] == _unstacked(s, stacked), name
    bshapes, bspecs = SPECS.train_inputs(cfg, configs.SHAPES["train_4k"])
    got = _fb_specs(dmesh, pol, bspecs, bshapes)
    assert got == {k: _spec(v) for k, v in want["batch"].items()}
    (_, _, cshapes), (_, _, cspecs) = SPECS.decode_inputs(
        cfg, configs.SHAPES["decode_32k"])
    got = _fb_specs(dmesh, pol, cspecs, cshapes)
    assert got == _jax_cache_layers(cfg, want["cache"])


# ---------------------------------------------------------------------------
# 3. analytic and the roofline arithmetic
# ---------------------------------------------------------------------------

def test_analytic_and_roofline_match_jax(monkeypatch):
    """``launch/analytic`` and ``roofline_terms``/``model_flops_for`` equal
    JAX's to 1e-12 relative on every config, shape and mode (JAX's
    roofline with the port's H100 constants put in its place)."""
    from repro.launch import analytic as janalytic
    from repro.launch import roofline as jroofline
    from repro_torch.launch import analytic, roofline

    for k in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroofline, k, getattr(roofline, k))
    rel = dict(rtol=1e-12, atol=0)
    for arch in jconfigs.ARCHS:
        cfg, jcfg = _configs(arch)
        assert cfg.n_params() == jcfg.n_params()
        for name, shape in configs.SHAPES.items():
            jshape = jconfigs.SHAPES[name]
            for mode in ("train", "prefill", "decode"):
                for remat in ("none", "dots", "full"):
                    np.testing.assert_allclose(
                        analytic.exec_flops(cfg, shape, mode, remat),
                        janalytic.exec_flops(jcfg, jshape, mode, remat),
                        **rel)
                np.testing.assert_allclose(
                    analytic.useful_flops(cfg, shape, mode),
                    janalytic.useful_flops(jcfg, jshape, mode), **rel)
                for pb in (2, 4):
                    np.testing.assert_allclose(
                        analytic.hbm_bytes(cfg, shape, mode, pb),
                        janalytic.hbm_bytes(jcfg, jshape, mode, pb), **rel)
                np.testing.assert_allclose(
                    analytic.kv_cache_bytes(cfg, shape),
                    janalytic.kv_cache_bytes(jcfg, jshape), **rel)
                mf = roofline.model_flops_for(cfg, shape, mode)
                np.testing.assert_allclose(
                    mf, jroofline.model_flops_for(jcfg, jshape, mode), **rel)
                cost = {"flops": 3.7e12 * (1 + len(arch)),
                        "bytes accessed": 2.9e10}
                coll = {"all-gather": 123456789, "all-reduce": 98765}
                for chips in (1, 256, 512):
                    mine = roofline.roofline_terms(cost, coll, chips, mf)
                    theirs = jroofline.roofline_terms(cost, coll, chips, mf)
                    assert mine.keys() == theirs.keys()
                    for key, v in theirs.items():
                        if isinstance(v, float):
                            np.testing.assert_allclose(mine[key], v, **rel)
                        else:
                            assert mine[key] == v, key


# ---------------------------------------------------------------------------
# 4-5. the sharded train step in 4 gloo processes, and restore
# ---------------------------------------------------------------------------

CASES = (("minicpm_2b", 1), ("minicpm_2b", 2), ("qwen3_moe_30b_a3b", 1),
         ("qwen3_moe_30b_a3b", 2))
STEPS = 3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}|{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


JAX_STEP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.optim.adamw import adamw_init
from repro.optim.schedule import cosine_schedule
from repro.runtime.sharding import default_policy
from repro.runtime.train_loop import build_train_step, opt_state_specs

jtf.COMPUTE_DTYPE = jnp.float32
inp, outp, cases, steps = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), int(sys.argv[4])
data = np.load(inp)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

def fb(pol, spec_tree, shape_tree):     # the dry run's divide rule
    def one(spec, x):
        new = []
        for i, ax in enumerate(tuple(pol.resolve(spec))):
            axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
            n = int(np.prod([sizes[a] for a in axes]))
            new.append(ax if axes and i < np.ndim(x) and
                       np.shape(x)[i] % n == 0 else None)
        return NamedSharding(mesh, P(*new))
    return jax.tree.map(one, spec_tree, shape_tree,
                        is_leaf=lambda s: isinstance(s, P))

def nest(prefix):
    tree = {}
    for k in data.files:
        if not k.startswith(prefix + "|"):
            continue
        parts = k[len(prefix) + 1:].split("|")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(data[k])
    return tree

out = {}
for arch, M in cases:
    jcfg = jconfigs.get_config(arch, reduced=True)
    from repro.launch.specs import abstract_params
    _, specs = abstract_params(jcfg)
    params = nest(f"{arch}/init")
    pol = default_policy(mesh, microbatches=M, grad_compress_dtype=None)
    psh = fb(pol, specs, params)
    opt = adamw_init(params)
    osh = fb(pol, opt_state_specs(specs), opt)
    bsh = NamedSharding(mesh, P(pol.resolve(P("dp"))[0], None))
    rep = NamedSharding(mesh, P())
    step = jax.jit(build_train_step(jcfg, pol, cosine_schedule(3e-3, 1, 10),
                                    grad_shardings=psh),
                   in_shardings=(psh, osh, {"tokens": bsh, "labels": bsh},
                                 rep),
                   out_shardings=(psh, osh, rep))
    params = jax.device_put(params, psh)
    opt = jax.device_put(opt, osh)
    for s in range(steps):
        batch = {k: data[f"{arch}/batch{s}/{k}"] for k in ("tokens", "labels")}
        params, opt, m = step(params, opt, batch, jnp.asarray(s, jnp.int32))
        for k in ("loss", "grad_norm"):
            out[f"{arch}/{M}/{s}/{k}"] = np.asarray(m[k], np.float32)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, x in flat:
        key = "|".join(p.key for p in path)
        out[f"{arch}/{M}/params|{key}"] = np.asarray(x, np.float32)
np.savez(outp, **out)
"""

PORT_STEP = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def nest(data, prefix):
    tree = {}
    for k in data.files:
        if not k.startswith(prefix + "|"):
            continue
        parts = k[len(prefix) + 1:].split("|")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = data[k]
    return tree


def run(rank, inp, outp, cases, steps, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch import configs
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.models import transformer as TF
    from repro_torch.models.weights import from_jax_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.runtime.sharding import (default_policy,
                                              single_device_policy)
    from repro_torch.runtime.train_loop import (build_train_step,
                                                distribute_state,
                                                opt_state_specs)
    TF.COMPUTE_DTYPE = torch.float32
    data = np.load(inp)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for arch, M in cases:
        cfg = configs.get_config(arch, reduced=True)
        init = nest(data, f"{arch}/init")
        lm = from_jax_params(cfg, init, device="cpu", dtype=torch.float32)
        opt = adamw_init(dict(lm.named_parameters()))
        pol = default_policy(mesh, microbatches=M, grad_compress_dtype=None)
        psh = pol.tree_shardings(mesh, TF.logical_specs(cfg),
                                 dict(lm.named_parameters()))
        lm, opt = distribute_state(lm, opt, mesh, psh)
        step = build_train_step(cfg, pol, cosine_schedule(3e-3, 1, 10),
                                grad_shardings=psh)
        ref = from_jax_params(cfg, init, device="cpu", dtype=torch.float32)
        ref_opt = adamw_init(dict(ref.named_parameters()))
        ref_step = build_train_step(
            cfg, single_device_policy(microbatches=M,
                                      grad_compress_dtype=None),
            cosine_schedule(3e-3, 1, 10))
        for s in range(steps):
            batch = {k: data[f"{arch}/batch{s}/{k}"]
                     for k in ("tokens", "labels")}
            dbatch = {k: distribute_tensor(
                torch.as_tensor(x.astype(np.int64)), mesh,
                pol.shard(mesh, ("dp", None), x.shape))
                for k, x in batch.items()}
            lm, opt, m = step(lm, opt, dbatch, s)
            ref, ref_opt, rm = ref_step(ref, ref_opt, batch, s)
            for k in ("loss", "grad_norm"):
                out[f"{arch}/{M}/{s}/{k}"] = float(m[k])
                out[f"{arch}/{M}/{s}/ref_{k}"] = float(rm[k])
        placed = all(list(p.placements) == list(psh[n])
                     for n, p in lm.named_parameters())
        full = {n: p.full_tensor().numpy() for n, p in lm.named_parameters()}
        for n, p in ref.named_parameters():
            out[f"{arch}/{M}/params/{n}"] = full[n]
            out[f"{arch}/{M}/ref/{n}"] = p.detach().numpy()
        # save the sharded state, restore it onto its shardings
        live = {"params": dict(lm.named_parameters()), "opt": opt}
        ck = Checkpointer(os.path.join(os.path.dirname(outp),
                                       f"ck_{arch}_{M}_{rank}"),
                          async_save=False)
        ck.save(steps - 1, live)
        fresh = from_jax_params(cfg, init, device="cpu", dtype=torch.float32)
        like = {"params": dict(fresh.named_parameters()),
                "opt": adamw_init(dict(fresh.named_parameters()))}
        shard = {"params": psh, "opt": opt_state_specs(psh)._replace(
            step=[Replicate()] * mesh.ndim)}
        got = ck.restore(steps - 1, like, shardings=shard, mesh=mesh)
        ok = all(list(got["params"][n].placements) == list(psh[n]) and
                 torch.equal(got["params"][n].to_local(), p.to_local())
                 for n, p in live["params"].items())
        ok &= all(torch.equal(got["opt"].m[n].to_local(), x.to_local()) and
                  torch.equal(got["opt"].v[n].to_local(),
                              opt.v[n].to_local())
                  for n, x in opt.m.items())
        ok &= int(got["opt"].step.to_local()) == int(opt.step.to_local())
        out[f"{arch}/{M}/placed"] = float(placed)
        out[f"{arch}/{M}/restored"] = float(ok)
    flags = torch.tensor([min(v for k, v in out.items()
                              if k.endswith(("placed", "restored")))])
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    out["all_ranks_ok"] = float(flags)
    if rank == 0:
        np.savez(outp, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    inp, outp, cases, steps = (sys.argv[1], sys.argv[2],
                               json.loads(sys.argv[3]), int(sys.argv[4]))
    mp.spawn(run, args=(inp, outp, cases, steps,
                        os.path.join(os.path.dirname(outp), "store")),
             nprocs=4)
"""


GRADS = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def query_rows():
    # attention_core on a (1, 4) mesh with 6 query heads over 2 KV heads
    # (neither divides 4), q/k/v replicated: the output's placements and
    # its value and gradients against the plain call
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.models.attention import _causal_mask, attention_core
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(3)
    q, k, v, w = (torch.randn(*s, generator=g) for s in
                  ((2, 16, 6, 8), (2, 16, 2, 8), (2, 16, 2, 8), (2, 16, 6, 8)))
    pos = torch.arange(16)[None].expand(2, 16)
    mask = _causal_mask(pos, pos, 0)[:, None]
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = attention_core(*plain, mask, 8 ** -0.5)
    (ref * w).sum().backward()
    dist_in = [distribute_tensor(x, mesh, [Replicate()] * 2).requires_grad_()
               for x in (q, k, v)]
    out = attention_core(*dist_in, mask, 8 ** -0.5)
    (out.full_tensor() * w).sum().backward()
    err = lambda a, b: float((a - b).abs().max())
    return {"placements": [str(p) for p in out.placements],
            "out": err(out.full_tensor(), ref),
            "grads": [err(d.grad.full_tensor(), p.grad)
                      for d, p in zip(dist_in, plain)]}


def run(rank, outp, archs, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import transformer as TF
    from repro_torch.models.weights import jax_ranks
    from repro_torch.runtime.sharding import default_policy
    from repro_torch.runtime.train_loop import (_cast_params, _value_and_grad,
                                                distribute_state,
                                                init_train_state)
    TF.COMPUTE_DTYPE = torch.float32
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for arch in archs:
        cfg = configs.get_config(arch, reduced=True)
        lm, opt = init_train_state(cfg, 0, device="cpu")
        ref, _ = init_train_state(cfg, 0, device="cpu")
        pol = default_policy(mesh, grad_compress_dtype=None)
        psh = pol.tree_shardings(mesh, TF.logical_specs(cfg),
                                 dict(lm.named_parameters()))
        lm, _ = distribute_state(lm, opt, mesh, psh)
        batch = {k: torch.as_tensor(v) for k, v in
                 SyntheticLMData(cfg, 4, 16, seed=2).batch_at(0).items()}
        batch = {k: v.long() if v.dtype == torch.int32 else v
                 for k, v in batch.items()}
        dbatch = {k: distribute_tensor(v, mesh, pol.shard(
            mesh, ("dp",) + (None,) * (v.ndim - 1), v.shape))
            for k, v in batch.items()}
        loss_fn = lambda m, b: TF.loss_fn(m, cfg, b)
        with implicit_replication():
            pb = _cast_params(dict(lm.named_parameters()), torch.float32,
                              jax_ranks(cfg, lm))
            loss, grads = _value_and_grad(lm, pb, loss_fn, dbatch)
            grads = {k: g.full_tensor() for k, g in grads.items()}
            loss = loss.full_tensor()
        pb = _cast_params(dict(ref.named_parameters()), torch.float32,
                          jax_ranks(cfg, ref))
        rloss, rgrads = _value_and_grad(ref, pb, loss_fn, batch)
        out[arch] = {"loss": [float(loss), float(rloss)], "grad": {
            k: float((g - rgrads[k]).norm() /
                     rgrads[k].norm().clamp_min(1e-30))
            for k, g in grads.items()}}
    out["rows"] = query_rows()
    if rank == 0:
        json.dump(out, open(outp, "w"))
    dist.destroy_process_group()


if __name__ == "__main__":
    outp, archs = sys.argv[1], json.loads(sys.argv[2])
    mp.spawn(run, args=(outp, archs, outp + ".store"), nprocs=4)
"""


@pytest.fixture(scope="module")
def sharded_grads(subprocesses):
    _wait(subprocesses, "grads")
    return json.loads((subprocesses["tmp"] / "grads.json").read_text())


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_sharded_gradients_match_single_process(sharded_grads, arch):
    """Every reduced arch's loss and gradients (fp32) through the mesh
    path (4 gloo ranks, a (2, 2) mesh, the default policy's placements)
    against the single-process path from the same state and batch: the
    loss 1e-5 relative, each gradient 1e-4 by relative norm (the
    ``FP32`` tolerances of ``tests/test_torch_train.py``).  Each of the
    mesh routes (``linear``, ``gather_rows``, ``by_heads``, ``on_rows``,
    ``replicated``) must hand back the partial sums it leaves."""
    rec = sharded_grads[arch]
    np.testing.assert_allclose(rec["loss"][0], rec["loss"][1],
                               rtol=FP32["loss"])
    worst = max(rec["grad"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst


def test_attention_on_query_rows(sharded_grads):
    """Where the heads cannot stay whole in their GQA groups over a mesh
    dimension (6 query heads over 2 KV heads, 4 devices), attention runs
    on each device's query rows (JAX's "scores" layout), not repeated on
    every device: its output is sharded on the sequence, and the output
    and the gradients of q, k and v equal the plain call's to 1e-5."""
    rec = sharded_grads["rows"]
    assert rec["placements"][1] == "S(1)", rec["placements"]
    assert rec["out"] <= 1e-5 and max(rec["grads"]) <= 1e-5, rec


@pytest.fixture(scope="module")
def sharded_runs(subprocesses):
    """Both 4-way runs from the same JAX weights and batches: JAX's jitted
    step on a (2, 2) mesh of forced host devices, and the port's step in
    4 gloo processes on a (2, 2) ``DeviceMesh``."""
    _wait(subprocesses, "jax")
    _wait(subprocesses, "port")
    tmp = subprocesses["tmp"]
    return (dict(np.load(tmp / "jax.npz")),
            dict(np.load(tmp / "port" / "port.npz")), subprocesses["inits"])


def _wait(procs, name):
    p = procs[name]
    _, err = p.communicate(timeout=900)
    assert p.returncode == 0, f"{name}: {err[-3000:]}"


@pytest.fixture(scope="module", autouse=True)
def subprocesses(tmp_path_factory):
    """Starts the module's subprocesses at once, beside its other tests:
    JAX's divide rule on the production meshes (512 forced host devices),
    JAX's 4-device step and the port's 4 gloo ranks (the two from the
    same JAX weights and batches), and the port's gradients on 4 gloo
    ranks for every arch."""
    tmp = tmp_path_factory.mktemp("sharded")
    arrays, inits = {}, {}
    for arch in sorted({a for a, _ in CASES}):
        jcfg = jconfigs.get_config(arch, reduced=True)
        params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(0))
        inits[arch] = _flat(params)
        arrays.update({f"{arch}/init|{k}": v
                       for k, v in inits[arch].items()})
        data = JData(jcfg, 4, 16, seed=2)
        for s in range(STEPS):
            for k, x in data.batch_at(s).items():
                arrays[f"{arch}/batch{s}/{k}"] = x
    inp = tmp / "inputs.npz"
    np.savez(inp, **arrays)
    cases = json.dumps([list(c) for c in CASES])
    (tmp / "port").mkdir()
    script = tmp / "port_step.py"
    script.write_text(PORT_STEP)
    grads = tmp / "grads_script.py"
    grads.write_text(GRADS)

    def start(*args):
        return subprocess.Popen([sys.executable, *map(str, args)],
                                env=_env(), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    procs = {"tmp": tmp, "inits": inits,
             "fb": start("-c", JAX_FB, tmp / "fb.json"),
             "jax": start("-c", JAX_STEP, inp, tmp / "jax.npz", cases,
                          STEPS),
             # a file, not -c: spawned ranks import the script as __main__
             "port": start(script, inp, tmp / "port" / "port.npz", cases,
                           STEPS),
             "grads": start(grads, tmp / "grads.json",
                            json.dumps(jconfigs.ARCHS))}
    yield procs
    for name in ("fb", "jax", "port", "grads"):
        if procs[name].poll() is None:
            procs[name].kill()
            procs[name].communicate()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("arch,M", CASES)
def test_sharded_step_matches_jax(sharded_runs, arch, M):
    """The port's step on DTensors (``grad_shardings``, 4 gloo ranks, a
    (2, 2) mesh) against JAX's jitted step with ``in_shardings`` on 4
    host devices: each step's loss and grad norm, and each parameter's
    update after the last step, within the ``FP32`` tolerances."""
    jx, port, inits = sharded_runs
    cfg = configs.get_config(arch, reduced=True)
    for s in range(STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(port[f"{arch}/{M}/{s}/{k}"],
                                       jx[f"{arch}/{M}/{s}/{k}"],
                                       rtol=FP32["loss"])
    init = {n: x for n, (x, _) in _by_port_name(cfg, _nest(
        inits[arch])).items()}
    want = _by_port_name(cfg, _nest(
        {k[len(f"{arch}/{M}/params|"):]: v for k, v in jx.items()
         if k.startswith(f"{arch}/{M}/params|")}))
    for name, (w, stacked) in want.items():
        got = port[f"{arch}/{M}/params/{name}"]
        w0 = init[name]
        idx = _layer_index(cfg, name) if stacked else None
        if idx is not None:
            w, w0 = w[idx], w0[idx]
        assert _rel(got - w0, w - w0) <= FP32["update"], name


@pytest.mark.parametrize("arch,M", CASES)
def test_sharded_step_matches_single_process(sharded_runs, arch, M):
    """The same sharded run against the port's own single-process step
    from the same state: losses, grad norms and every parameter's update
    within the ``FP32`` tolerances; every parameter stays on its
    placements."""
    _, port, _ = sharded_runs
    for s in range(STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(port[f"{arch}/{M}/{s}/{k}"],
                                       port[f"{arch}/{M}/{s}/ref_{k}"],
                                       rtol=FP32["loss"])
    assert port[f"{arch}/{M}/placed"] == 1.0
    pre = f"{arch}/{M}/params/"
    for key in [k for k in port if k.startswith(pre)]:
        name = key[len(pre):]
        ref = port[f"{arch}/{M}/ref/{name}"]
        assert np.abs(port[key] - ref).max() <= \
            2e-4 * max(np.abs(ref).max(), 1e-6), name


@pytest.mark.parametrize("arch,M", CASES)
def test_restore_onto_shardings(sharded_runs, arch, M):
    """``Checkpointer.restore(..., shardings=)`` in the 4 gloo ranks: each
    saved leaf (parameters, m, v, step) comes back as a DTensor on the
    placements asked for, every local shard bit-equal to the live
    state's, on every rank."""
    _, port, _ = sharded_runs
    assert port[f"{arch}/{M}/restored"] == 1.0
    assert port["all_ranks_ok"] == 1.0


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        parts = k.split("|")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def _layer_index(cfg, name):
    """The index into JAX's stack of the port's parameter ``name``."""
    parts = name.split(".")
    pat = cfg.block_pattern or ("attn",)
    if parts[0] == "layers":
        return int(parts[1]) // len(pat)
    return int(parts[2]) if parts[0] == "encoder" else int(parts[1])
