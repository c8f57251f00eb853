"""The port's optimizer, schedules, data pipeline and sharding policy
(``repro_torch.optim``, ``data``, ``runtime.sharding``): the unit tests of
``tests/test_optim_data.py`` on the port, and each against the JAX
package on the same inputs.

Tolerances: ``adamw_update`` is held within 1e-6 relative (fp32 math on
both sides; XLA and PyTorch may round ``b ** step`` and a fused multiply
differently by an ulp); the schedules within 1e-6 relative (``cos`` and
``pow`` by an ulp); ``SyntheticLMData.batch_at`` bit for bit.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import SyntheticLMData as JData
from repro.models import transformer as jtf
from repro.optim.adamw import adamw_init as jinit
from repro.optim.adamw import adamw_update as jupdate
from repro.optim.schedule import cosine_schedule as jcosine
from repro.optim.schedule import wsd_schedule as jwsd
from repro.runtime import sharding as jsharding
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.weights import (from_jax_opt_state, from_jax_params,
                                        jax_ranks)
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import ShardingPolicy

# ---------------------------------------------------------------------------
# the unit tests of tests/test_optim_data.py, on the port
# ---------------------------------------------------------------------------


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, gn = adamw_update(params, grads, opt, lr=0.05,
                                       weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.2


def test_adamw_no_decay_on_vectors():
    params = {"b": torch.ones(4), "w": torch.ones((4, 4))}
    opt = adamw_init(params)
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    p2, _, _ = adamw_update(params, zeros, opt, lr=0.1, weight_decay=0.5)
    np.testing.assert_allclose(p2["b"].numpy(), 1.0)            # no decay
    assert float(p2["w"][0, 0]) < 1.0                            # decayed


def test_wsd_schedule_phases():
    lr = wsd_schedule(1.0, warmup=10, stable=20, decay=10)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0)
    assert float(lr(25)) == pytest.approx(1.0)      # stable plateau
    assert float(lr(40)) < 0.05                     # decayed


def test_cosine_schedule_monotone_after_peak():
    lr = cosine_schedule(1.0, warmup=5, total=50)
    vals = [float(lr(s)) for s in range(5, 50, 5)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))


def test_data_pipeline_determinism_and_shapes():
    cfg = get_config("minicpm_2b", reduced=True)
    d1 = SyntheticLMData(cfg, 8, 16, seed=1)
    d2 = SyntheticLMData(cfg, 8, 16, seed=1)
    b1, b2 = d1.batch_at(5), d2.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (8, 16)
    assert (b1["tokens"] >= 0).all() and \
        (b1["tokens"] < cfg.vocab_size).all()
    # next-token labels
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


def test_data_pipeline_host_sharding_disjoint():
    cfg = get_config("minicpm_2b", reduced=True)
    h0 = SyntheticLMData(cfg, 8, 16, seed=1, n_hosts=2, host_id=0)
    h1 = SyntheticLMData(cfg, 8, 16, seed=1, n_hosts=2, host_id=1)
    b0, b1 = h0.batch_at(0), h1.batch_at(0)
    assert b0["tokens"].shape == (4, 16)
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_sharding_policy_resolution():
    pol = ShardingPolicy(rules={"fsdp": ("pod", "data"), "tp": "model",
                                "dp": ("pod", "data")})
    assert pol.resolve(("fsdp", "tp")) == (("pod", "data"), "model")
    assert pol.resolve((None, "tp")) == (None, "model")
    # tuple-of-logical axes flatten
    assert pol.resolve((("fsdp",), "tp")) == (("pod", "data"), "model")


def test_prefetching_iterator():
    cfg = get_config("mamba2_130m", reduced=True)
    d = SyntheticLMData(cfg, 4, 8, prefetch=2)
    it = d.iterator()
    batches = [next(it) for _ in range(3)]
    d.stop()
    assert all(b["tokens"].shape == (4, 8) for b in batches)
    for i, b in enumerate(batches):     # in order, from step 0
        np.testing.assert_array_equal(b["tokens"], d.batch_at(i)["tokens"])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [("pod", "data", "model"), ("data", "model"),
                                  ("data",), ("model",)])
def test_policies_match_jax(axes):
    """``default_policy``, ``tp_only_policy``, ``seq_shard_policy`` and
    ``single_device_policy`` give JAX's rules, names and knobs (JAX's take
    a mesh and read its axis names), and resolve specs alike."""
    mesh = types.SimpleNamespace(axis_names=axes)
    specs = [("fsdp", "tp"), ("dp", None, "sp"), (("fsdp", "tp"), None),
             ("unknown",)]
    for name in ("default_policy", "tp_only_policy", "seq_shard_policy"):
        mine = getattr(sharding, name)(axes, microbatches=3)
        theirs = getattr(jsharding, name)(mesh, microbatches=3)
        assert mine.rules == theirs.rules and mine.name == theirs.name
        assert (mine.microbatches, mine.zero_opt_state,
                mine.grad_compress_dtype) == (theirs.microbatches,
                                              theirs.zero_opt_state,
                                              theirs.grad_compress_dtype)
        for s in specs:
            assert mine.resolve(s) == tuple(theirs.resolve(jax.sharding.
                                                           PartitionSpec(*s)))
    one, jone = sharding.single_device_policy(), jsharding.single_device_policy()
    assert (one.rules, one.name, one.microbatches) == \
        (jone.rules, jone.name, jone.microbatches)


def _stacked_tree(rng, L=2, d=6, V=10):
    """A JAX-shaped tree with a stacked norm ([L, d]: rank 2 in JAX, so
    decayed), stacked matrices, a 1-D ``final_norm`` and a table."""
    def f(*s):
        return rng.standard_normal(s).astype(np.float32)
    return {"embed": f(V, d), "final_norm": f(d),
            "layers": {"norm": f(L, d), "w": f(L, d, d)}}


def _port_tree(tree):
    """The same leaves as the port holds them, a layer a module: names and
    JAX ranks."""
    out, ranks = {}, {}
    for k in ("embed", "final_norm"):
        out[k], ranks[k] = torch.as_tensor(tree[k].copy()), tree[k].ndim
    for name, x in tree["layers"].items():
        for i in range(x.shape[0]):
            out[f"layers.{i}.{name}"] = torch.as_tensor(x[i].copy())
            ranks[f"layers.{i}.{name}"] = x.ndim
    return out, ranks


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_on_a_stacked_tree(grad_dtype, state_dtype):
    """Three steps of ``adamw_update`` (the third with gradients large
    enough to clip) on a tree with a stacked norm leaf: params, m, v,
    step and the global norm equal JAX's within 1e-6 relative, in both
    state dtypes and gradient dtypes.  The stacked norm is decayed, as
    JAX decays it (R11), and would not be without the JAX ranks."""
    rng = np.random.default_rng(0)
    jtree = _stacked_tree(rng)
    params, ranks = _port_tree(jtree)
    jp = jax.tree.map(jnp.asarray, jtree)
    sd = getattr(jnp, state_dtype)
    jo, to = jinit(jp, dtype=sd), adamw_init(params,
                                             dtype=getattr(torch,
                                                           state_dtype))
    for step, scale in enumerate((0.01, 0.1, 10.0)):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale)
                         .astype(np.float32), jtree)
        jg = jax.tree.map(lambda x: jnp.asarray(x, getattr(jnp, grad_dtype)),
                          g)
        tg, _ = _port_tree(jax.tree.map(
            lambda x: np.asarray(x.astype(jnp.float32)), jg))
        tg = {k: v.to(getattr(torch, grad_dtype)) for k, v in tg.items()}
        lr = 1e-2 * (step + 1)
        jp, jo, jgn = jupdate(jp, jg, jo, lr)
        params, to, gn = adamw_update(params, tg, to, lr, ranks=ranks)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        assert int(to.step) == int(jo.step) == step + 1
        for mine, theirs in ((params, jp), (to.m, jo.m), (to.v, jo.v)):
            want, _ = _port_tree(jax.tree.map(
                lambda x: np.asarray(x.astype(jnp.float32)), theirs))
            for k, x in mine.items():
                np.testing.assert_allclose(x.float().numpy(),
                                           want[k].numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=k)
    # without the JAX ranks the per-layer norm [d] would not be decayed
    p = {"layers.0.norm": torch.ones(4)}
    zeros = {"layers.0.norm": torch.zeros(4)}
    kept, _, _ = adamw_update(dict(p), zeros, adamw_init(p), 0.1)
    assert torch.equal(kept["layers.0.norm"], torch.ones(4))
    p = {"layers.0.norm": torch.ones(4)}
    decayed, _, _ = adamw_update(p, zeros, adamw_init(p), 0.1,
                                 ranks={"layers.0.norm": 2})
    assert float(decayed["layers.0.norm"][0]) < 1.0


def test_global_norm_and_clip_match_jax():
    from repro.optim.adamw import clip_by_global_norm as jclip
    from repro.optim.adamw import global_norm as jnorm
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    mine = {k: torch.as_tensor(v) for k, v in tree.items()}
    np.testing.assert_allclose(float(global_norm(mine)),
                               float(jnorm(tree)), rtol=1e-6)
    clipped, gn = clip_by_global_norm(mine, 1.0)
    jclipped, jgn = jclip(jax.tree.map(jnp.asarray, tree), 1.0)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   np.asarray(jclipped[k]), rtol=1e-6)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)


def test_opt_state_carried_across_continues_like_jax():
    """``from_jax_opt_state`` carries JAX's AdamW state after one step of
    reduced MiniCPM (step, m, v by the port's names); one more update
    with the same gradients on both sides then gives JAX's params and
    moments within 1e-6 (decay by ``jax_ranks``)."""
    cfg = get_config("minicpm_2b", reduced=True)
    jcfg = jconfigs.get_config("minicpm_2b", reduced=True)
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32) * 0.1), params)
        for _ in range(2)]
    jo = jinit(params)
    params, jo, _ = jupdate(params, grads[0], jo, 1e-2)
    np32 = lambda t: jax.tree.map(np.asarray, t)
    lm = from_jax_params(cfg, np32(params), device="cpu", dtype=torch.float32)
    to = from_jax_opt_state(cfg, np32(jo), device="cpu")
    assert int(to.step) == 1 and to.step.dtype == torch.int32
    named = dict(lm.named_parameters())
    assert to.m.keys() == named.keys() == to.v.keys()
    gl = from_jax_params(cfg, np32(grads[1]), device="cpu",
                         dtype=torch.float32)
    tg = {n: p.detach() for n, p in gl.named_parameters()}
    params, jo, jgn = jupdate(params, grads[1], jo, 1e-2)
    _, to, gn = adamw_update(named, tg, to, 1e-2, ranks=jax_ranks(cfg, lm))
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for mine, theirs in ((named, params), (to.m, jo.m), (to.v, jo.v)):
        want = from_jax_params(cfg, np32(theirs), device="cpu",
                               dtype=torch.float32)
        for n, x in want.named_parameters():
            np.testing.assert_allclose(mine[n].detach().numpy(),
                                       x.detach().numpy(), rtol=1e-6,
                                       atol=1e-8, err_msg=n)
    # a bf16 state carries across in bf16
    jb = jinit(params, dtype=jnp.bfloat16)
    tb = from_jax_opt_state(cfg, np32(jb), device="cpu")
    assert all(x.dtype == torch.bfloat16 for x in tb.m.values())


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
@pytest.mark.parametrize("args", [(3e-4, 10, 100), (1.0, 0, 37),
                                  (2.5e-3, 7, 50)])
def test_schedules_match_jax(kind, args):
    """Both schedules at steps 0..100 (warmup, plateau, decay and past
    the end) within 1e-6 relative; fp32 scalars."""
    peak, warmup, total = args
    if kind == "cosine":
        mine, theirs = cosine_schedule(*args), jcosine(*args)
    else:
        mine = wsd_schedule(peak, warmup, total // 2, total // 3)
        theirs = jwsd(peak, warmup, total // 2, total // 3)
    for step in range(101):
        got = mine(step)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(theirs(step)),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("arch", ["minicpm_2b", "internvl2_2b",
                                  "whisper_base", "mamba2_130m"])
def test_batch_at_bit_equal_to_jax(arch):
    """Every frontend (none, vit_stub's patches, audio_stub's frames):
    ``batch_at`` equal to JAX's bit for bit, at several steps and hosts
    and at full and reduced size."""
    for reduced in (True, False):
        cfg = get_config(arch, reduced=reduced)
        jcfg = jconfigs.get_config(arch, reduced=reduced)
        for seed, n_hosts, host in ((0, 1, 0), (7, 2, 1)):
            mine = SyntheticLMData(cfg, 4, 24, seed=seed, n_hosts=n_hosts,
                                   host_id=host)
            theirs = JData(jcfg, 4, 24, seed=seed, n_hosts=n_hosts,
                           host_id=host)
            for step in (0, 3, 1000):
                a, b = mine.batch_at(step), theirs.batch_at(step)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
