"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the reduced Qwen3-30B-A3B and
Granite-MoE configs.

Reduced Granite keeps ``pad_experts_to=48`` with 8 real experts, so the
mask of padded experts is covered.  Weights come from JAX's ``init_moe``
(as numpy) through ``weights.load_tree``; inputs from
``numpy.random.default_rng``.  Routing (experts, capacity ranks, the keep
set) is held exactly; outputs within 1e-5 in fp32 and 2e-2 (by element
and by row norm) in bf16; the combine bit for bit in bf16.  A
repeated-token input makes assignments overflow capacity, and each test
that needs drops asserts that they occurred.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models.layers import split_pv_tree
from repro_torch import configs
from repro_torch.models import moe as MOE
from repro_torch.models.weights import load_tree

ARCHS = ["qwen3_moe_30b_a3b", "granite_moe_3b_a800m"]
TOL = 2e-2


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _cfgs(arch, reduced=True, **moe):
    cfg = configs.get_config(arch, reduced=reduced)
    jcfg = jconfigs.get_config(arch, reduced=reduced)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
    return cfg, jcfg


def _pair(cfg, jcfg, dtype, seed=1):
    """(port MoE holding JAX's init_moe weights, JAX params)."""
    jp = split_pv_tree(jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))[0]
    p = MOE.MoE(cfg, dtype=getattr(torch, dtype), device="cpu")
    load_tree(p, jax.tree.map(np.asarray, jp), None, "moe")
    return p, jp


def _inputs(cfg, dtype, B=2, S=24, repeat=False, seed=2):
    """(jax x, torch x) with the same values in ``dtype``; with
    ``repeat`` the last row is one token repeated, which overflows
    capacity."""
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
    if repeat:
        x[-1] = x[-1, :1]
    jx = jnp.asarray(x, dtype)
    return jx, torch.as_tensor(_np(jx)).to(getattr(torch, dtype))


def _drops(cfg, experts, n_groups):
    """Dropped assignments per group of the port's dispatch."""
    E = MOE._padded_experts(cfg)
    G = n_groups
    eg = experts.reshape(G, -1, cfg.moe.top_k)
    _, keep = MOE.dispatch(eg, E, MOE.capacity(cfg, eg.shape[1]))
    return (~keep).sum(-1).tolist()


def assert_close(got, want, dtype):
    """fp32: 1e-5; bf16: 2e-2 by element (of the max value) and by row
    norm (rows that are zero on both sides, whole-token drops, agree)."""
    g = got.float().numpy()
    w = _np(want)
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        return
    assert np.abs(g - w).max() <= TOL * np.abs(w).max()
    gn = np.linalg.norm(g - w, axis=-1)
    wn = np.linalg.norm(w, axis=-1)
    assert (gn[wn == 0] == 0).all()
    assert (gn[wn > 0] / wn[wn > 0]).max() <= TOL


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    """fp32 gates and aux within 1e-6, experts exactly; the inputs hold
    a crafted row where every real expert ties (lower index first, as
    ``jax.lax.top_k``; ``torch.topk`` would not) and a row with a tie at
    the k-th place."""
    cfg, jcfg = _cfgs(arch)
    p, jp = _pair(cfg, jcfg, "float32")
    jx, tx = _inputs(cfg, "float32", S=32)
    jx = jx.at[0, 0].set(0.0)          # zero input: equal logits
    tx[0, 0] = 0.0
    # equal router columns 1 and 2: a tie between two experts everywhere
    jp = dict(jp, router=jp["router"].at[:, 2].set(jp["router"][:, 1]))
    p.router.data[:, 2] = p.router.data[:, 1]
    g, e, aux = MOE._route(p, cfg, tx)
    jg, je, jaux = jmoe._route(jp, jcfg, jx)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(g.numpy(), _np(jg), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert e[0, 0].tolist() == list(range(cfg.moe.top_k))
    tied = (e == 1).any(-1) & (e == 2).any(-1)
    assert bool(tied.any()), "no tie was exercised"
    # where both tied experts are picked, the lower index comes first
    pos1 = (e == 1).int().argmax(-1)
    pos2 = (e == 2).int().argmax(-1)
    assert bool((pos1[tied] < pos2[tied]).all())


def test_route_breaks_an_all_tie_row_lower_index_first():
    cfg, _ = _cfgs("granite_moe_3b_a800m")
    E = MOE._padded_experts(cfg)
    logits = torch.zeros((1, E))
    logits[0, cfg.moe.n_experts:] = MOE.NEG_INF
    _, experts, _ = MOE.route_logits(cfg, logits, torch.float32)
    assert experts.tolist() == [list(range(cfg.moe.top_k))]
    probs = torch.tensor([[.25, .25, .25, .25, 0.0]])
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
    cfg2 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=5, top_k=2, pad_experts_to=0))
    got = MOE.route_logits(cfg2, torch.log(probs), torch.float32)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_capacity(jcfg, T):
    """JAX's capacity, read off ``_gather_moe``: every token of a group
    of T routed to experts 0..k-1 with gate 1 and unit expert weights;
    the tokens with a nonzero output are the min(T, C) kept."""
    d = jcfg.d_model
    E = jmoe._padded_experts(jcfg)
    ff = jcfg.moe.d_ff
    p = {"router": jnp.zeros((d, E)),
         "w_gate": jnp.ones((E, d, ff)), "w_up": jnp.ones((E, d, ff)),
         "w_down": jnp.ones((E, ff, d))}
    k = jcfg.moe.top_k
    x = jnp.ones((1, T, d))
    experts = jnp.broadcast_to(jnp.arange(k), (1, T, k))
    gates = jnp.ones((1, T, k))
    y = jax.jit(lambda p, x, g, e: jmoe._gather_moe(p, jcfg, x, g, e))(
        p, x, gates, experts)
    return int((jnp.abs(y[0]).sum(-1) > 0).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    """The port's capacity against JAX's over a grid of T on the reduced
    config (read off JAX's dispatch), and JAX's formula at full size,
    where Granite divides by its 40 real experts, not the padded 48."""
    cfg, jcfg = _cfgs(arch)
    for T in (1, 3, 4, 7, 24, 64):
        assert min(T, MOE.capacity(cfg, T)) == _jax_capacity(jcfg, T)
    full, jfull = _cfgs(arch, reduced=False)
    for T in (1, 7, 512, 4095, 4096, 8192, 8193, 32768):
        want = int(max(1, (T * jfull.moe.top_k * jfull.moe.capacity_factor)
                       // max(jfull.moe.n_experts, 1)))
        assert MOE.capacity(full, T) == want
    if arch == "granite_moe_3b_a800m":
        assert MOE._padded_experts(full) == 48
        assert MOE.capacity(full, 4096) == 1024     # 4096*8*1.25 // 40
    else:
        assert MOE.capacity(full, 8192) == MOE.capacity(full, 8193) == 640
        assert MOE.capacity(full, 1) == 1


def test_dispatch_ranks_in_flat_token_k_order():
    """The rank of each assignment counts the earlier ones to its expert
    in (token, k) order; ranks at or past C drop."""
    experts = torch.tensor([[[0, 1], [1, 0], [0, 2], [0, 1]]])
    rank, keep = MOE.dispatch(experts, 3, 2)
    assert rank.tolist() == [[0, 0, 1, 1, 2, 0, 3, 2]]
    assert keep.tolist() == [[True, True, True, True, False, True, False,
                              False]]


# ---------------------------------------------------------------------------
# dispatch and combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("repeat", [False, True], ids=["no-drops", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gather_moe_matches_jax(arch, repeat, dtype):
    """``_gather_moe`` on JAX's own routing of the same input.  Without
    drops the capacity factor is E / k (C = T: nothing can overflow);
    with the repeated row at the config's factor, assignments drop."""
    kw = {} if repeat else {"capacity_factor": 4.0}
    cfg, jcfg = _cfgs(arch, **kw)
    p, jp = _pair(cfg, jcfg, dtype)
    jx, tx = _inputs(cfg, dtype, repeat=repeat)
    jg, je, _ = jmoe._route(jp, jcfg, jx)
    got = MOE._gather_moe(p, cfg, tx, torch.as_tensor(_np(jg)).to(tx.dtype),
                          torch.as_tensor(np.asarray(je)).long())
    want = jmoe._gather_moe(jp, jcfg, jx, jg, je)
    assert_close(got, want, dtype)
    drops = _drops(cfg, torch.as_tensor(np.asarray(je)).long(), 2)
    if repeat:
        assert drops[1] > 0, drops
    else:
        assert drops == [0, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("repeat", [False, True], ids=["no-drops", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, repeat, dtype):
    kw = {} if repeat else {"capacity_factor": 4.0}
    cfg, jcfg = _cfgs(arch, **kw)
    p, jp = _pair(cfg, jcfg, dtype)
    jx, tx = _inputs(cfg, dtype, repeat=repeat)
    got, aux = MOE.apply_moe(p, cfg, tx)
    want, jaux = jmoe.apply_moe(jp, jcfg, jx)
    assert got.dtype == tx.dtype
    assert_close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    experts = MOE._route(p, cfg, tx)[1]
    np.testing.assert_array_equal(experts.numpy(),
                                  np.asarray(jmoe._route(jp, jcfg, jx)[1]))
    drops = _drops(cfg, experts, 2)
    assert (drops[1] > 0) if repeat else drops == [0, 0], drops


@pytest.mark.parametrize("arch", ARCHS)
def test_combine_is_bit_equal_to_jax_scatter_add(arch):
    """The combine alone on identical bf16 expert outputs: JAX's
    ``zeros.at[token].add(ye[slot] * (gate * keep))`` against the port's
    k adds in k order, bit for bit (an fp32 sum rounded once is not)."""
    cfg, _ = _cfgs(arch)
    k = cfg.moe.top_k
    rng = np.random.default_rng(3)
    G, T, N, d = 2, 40, 50, cfg.d_model
    ye = jnp.asarray(rng.standard_normal((N, d)) * 3, jnp.bfloat16)
    slot = rng.integers(0, N, (G, T * k))
    gate = jnp.asarray(rng.random((G, T * k)), jnp.bfloat16)
    keep = rng.random((G, T * k)) < 0.8

    def jax_combine(s, g, kp):
        contrib = ye[s] * (g * kp).astype(jnp.bfloat16)[:, None]
        flat_t = jnp.arange(T * k) // k
        return jnp.zeros((T, d), jnp.bfloat16).at[flat_t].add(contrib)

    want = jax.vmap(jax_combine)(jnp.asarray(slot), gate, jnp.asarray(keep))
    w = (torch.as_tensor(_np(gate)).bfloat16() * torch.as_tensor(keep))
    tye = torch.as_tensor(_np(ye)).bfloat16()
    got = MOE.combine(tye, torch.as_tensor(slot).view(G, T, k),
                      w.view(G, T, k))
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    once = (tye.float()[torch.as_tensor(slot)] *
            w.float()[..., None]).view(G, T, k, d).sum(2).bfloat16()
    assert not torch.equal(once, got)


def test_padded_experts_receive_no_tokens():
    """Granite: 8 real experts padded to 48; no input routes to a padded
    one, and their dispatch rows stay empty, even where every real
    expert's logit is very negative."""
    cfg, jcfg = _cfgs("granite_moe_3b_a800m")
    p, _ = _pair(cfg, jcfg, "float32")
    E, E_real = MOE._padded_experts(cfg), cfg.moe.n_experts
    assert (E, E_real) == (48, 8)
    _, tx = _inputs(cfg, "float32", B=3, S=40, repeat=True)
    tx = tx * 1e3
    logits = MOE.router_logits(p, cfg, tx)
    assert bool((logits[..., E_real:] == MOE.NEG_INF).all())
    _, experts, _ = MOE._route(p, cfg, tx)
    assert int(experts.max()) < E_real
    rank, keep = MOE.dispatch(experts, E, MOE.capacity(cfg, 40))
    per_expert = torch.bincount(experts.reshape(3, -1)[keep], minlength=E)
    assert per_expert[E_real:].sum() == 0 and per_expert.sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_dispatch_matches_jax(arch, dtype):
    """``dispatch="dense"``: every expert on every token.  In bf16 JAX
    casts its fp32 masters to fp32 here, the port its bf16 weights, so
    bf16 is held at 2e-2."""
    cfg, jcfg = _cfgs(arch, dispatch="dense")
    p, jp = _pair(cfg, jcfg, dtype)
    jx, tx = _inputs(cfg, dtype, repeat=True)
    got, aux = MOE.apply_moe(p, cfg, tx)
    want, jaux = jmoe.apply_moe(jp, jcfg, jx)
    assert_close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_groups", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_n_groups_matches_jax(arch, n_groups, dtype):
    """Grouping other than one group per row: the whole batch as one
    group, and 4 groups over 2 rows (the repeated row's groups drop)."""
    cfg, jcfg = _cfgs(arch)
    p, jp = _pair(cfg, jcfg, dtype)
    jx, tx = _inputs(cfg, dtype, repeat=True)
    got, _ = MOE.apply_moe(p, cfg, tx, n_groups=n_groups)
    want, _ = jmoe.apply_moe(jp, jcfg, jx, n_groups=n_groups)
    assert_close(got, want, dtype)
    drops = _drops(cfg, MOE._route(p, cfg, tx)[1], n_groups)
    assert drops[-1] > 0, drops
