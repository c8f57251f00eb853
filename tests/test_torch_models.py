"""The port's serving path (``repro_torch.models``) against the JAX
package's ``repro.models``: every architecture the JAX package configures
(dense, MoE, the RG-LRU hybrid with its remainder blocks, the SSM, the
whisper encoder-decoder and the VLM with its prepended patch embeddings).

Weights come from the JAX ``init_lm`` (as numpy) through
``weights.from_jax_params``; inputs from ``numpy.random.default_rng``.  In
bf16 (the compute dtype of both) the two round at different places: the
port's prefill goes through the flash kernel's plain version (fp32 scores
and weights) where JAX's ``attention_core`` rounds both to bf16, and bf16
matmuls accumulate in another order.  So bf16 results are held within
2e-2 by relative norm and by max |error| / max |value|; the same paths in
fp32 (``COMPUTE_DTYPE`` switched on both sides) are held within 1e-4.

The MoE archs serve through the same tests.  Their top-k routing is a
step function of the block's normed input h2, and the bf16 h2 of the two
frameworks differs by rounding (~3e-3 by norm), which flips near-tied
picks and, through the capacity ranks, which later assignments drop.  So
in bf16 each MoE call is held on JAX's own h2 (``_route_on_jax_inputs``):
the port's h2 within 2e-2 of JAX's, the port's routing of JAX's h2 equal
to JAX's bit for bit, and the path goes on with that routing.  In fp32
the port routes its own h2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.layers import split_pv_tree
from repro_torch import configs
from repro_torch.kernels.flash_attention import kernel as FAK
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as TF
from repro_torch.models.weights import from_jax_params, load_tree
from repro_torch.runtime.train_loop import init_train_state

DENSE = ["h2o_danube_3_4b", "minicpm_2b", "qwen15_32b", "nemotron_4_340b",
         "internvl2_2b"]
MOE_ARCHS = ["qwen3_moe_30b_a3b", "granite_moe_3b_a800m"]
RECURRENT = ["recurrentgemma_9b", "mamba2_130m"]
# a config changed on both sides (dataclasses.replace) and how it serves:
# RecurrentGemma at 8 layers, 2 x (R, R, A) then the remainder blocks R, R
# (the reduced config's 6 layers have none); InternVL2 with its prepended
# patch embeddings (extra_embeds)
VARIANTS = {"recurrentgemma_9b:8L": ("recurrentgemma_9b", {"n_layers": 8}),
            "internvl2_2b:patches": ("internvl2_2b", {})}
SERVED = DENSE + MOE_ARCHS + RECURRENT + ["whisper_base"] + list(VARIANTS)
# every config of the JAX package, and the 8-layer RecurrentGemma
ALL_CONFIGS = jconfigs.ARCHS + ["recurrentgemma_9b:8L"]
TOL = 2e-2


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x, np.float32)).to(dtype)


def assert_bf16_close(got, want, tol=TOL):
    """Within ``tol`` by relative norm and by max |error| / max |value|."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else _np(got)
    w = want.float().numpy() if isinstance(want, torch.Tensor) else _np(want)
    assert g.shape == w.shape
    scale = np.abs(w).max()
    assert np.abs(g - w).max() <= tol * scale, \
        f"max abs err {np.abs(g - w).max()} vs {tol} x {scale}"
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= tol, f"relative norm {rel}"


def _snapshot(cache):
    """A copy of the port's cache (decode writes it in place)."""
    return [{n: x.clone() for n, x in layer.items()} for layer in cache]


def _configs(name, reduced=True):
    """(port config, JAX config) of an arch or a ``VARIANTS`` name."""
    arch, kw = VARIANTS.get(name, (name, {}))
    return (dataclasses.replace(configs.get_config(arch, reduced=reduced),
                                **kw),
            dataclasses.replace(jconfigs.get_config(arch, reduced=reduced),
                                **kw))


def _jax_layer_entries(jcache, cfg):
    """JAX's cache tree (or its ``cache_shapes``) as the port's list: the
    superblock stack ``layers.b{i}_{kind}`` indexed by superblock, the
    remainder blocks ``rem{j}_{kind}``, and whisper's ``cross_k``/
    ``cross_v`` stacks by layer.  Leaves come back as ``(leaf, index)``."""
    pat = cfg.block_pattern or ("attn",)
    n_scanned = cfg.n_layers // len(pat) * len(pat)
    out = []
    for i, kind in enumerate(TF.layer_kinds(cfg)):
        if i < n_scanned:
            tree = jcache["layers"][f"b{i % len(pat)}_{kind}"]
            ent = {n: (x, i // len(pat)) for n, x in tree.items()}
        else:
            tree = jcache[f"rem{i - n_scanned}_{kind}"]
            ent = {n: (x, None) for n, x in tree.items()}
        if cfg.is_enc_dec:
            ent.update(cross_k=(jcache["cross_k"], i),
                       cross_v=(jcache["cross_v"], i))
        out.append(ent)
    return out


def _jax_cache_layers(jcache, cfg):
    return [{n: x if i is None else x[i] for n, (x, i) in ent.items()}
            for ent in _jax_layer_entries(jcache, cfg)]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_equal_jax(arch, reduced):
    a = configs.get_config(arch, reduced=reduced)
    b = jconfigs.get_config(arch, reduced=reduced)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.n_params(), a.padded_vocab, a.resolved_head_dim) == \
        (b.n_params(), b.padded_vocab, b.resolved_head_dim)
    assert configs.SHAPES.keys() == jconfigs.SHAPES.keys()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    b = rng.standard_normal(64).astype(np.float32) * 0.1
    jx = jnp.asarray(x, dtype)
    tx = _t(_np(jx), getattr(torch, dtype))
    got = L.rmsnorm(tx, _t(w), 1e-6)
    want = jlayers.rmsnorm(jx, jnp.asarray(w), 1e-6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=1e-5,
                               rtol=1e-5)
    got = L.layernorm(tx, _t(w), _t(b), 1e-5)
    want = jlayers.layernorm(jx, jnp.asarray(w), jnp.asarray(b), 1e-5)
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=1e-5,
                               rtol=1e-5)
    for norm_type in ("rmsnorm", "layernorm"):
        p = L.init_norm(norm_type, 64, device="cpu")
        jp = split_pv_tree(jlayers.init_norm(norm_type, 64))[0]
        np.testing.assert_allclose(
            L.apply_norm(norm_type, p, tx, 1e-6).float().numpy(),
            _np(jlayers.apply_norm(norm_type, jp, jx, 1e-6)), atol=1e-5,
            rtol=1e-5)


@pytest.mark.parametrize("hd", [16, 120])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(hd, dtype):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = np.stack([np.arange(9), rng.integers(0, 9000, 9)]).astype(np.int32)
    jx = jnp.asarray(x, dtype)
    got = L.apply_rope(_t(_np(jx), getattr(torch, dtype)),
                       torch.as_tensor(pos), 10000.0)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), 10000.0)
    # fp32: XLA's and PyTorch's cos/sin of angles up to 9,000 rad differ
    # by a few 1e-5
    tol = 1e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(L.rope_freqs(hd, 1e6, device="cpu").numpy(),
                               _np(jlayers.rope_freqs(hd, 1e6)), rtol=1e-6)


def test_activations_and_positions_match_jax():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(L.squared_relu(_t(x)).numpy(),
                               _np(jlayers.squared_relu(jnp.asarray(x))))
    np.testing.assert_allclose(L.softcap(_t(x), 3.0).numpy(),
                               _np(jlayers.softcap(jnp.asarray(x), 3.0)),
                               atol=1e-6)
    assert L.softcap(_t(x), 0.0).equal(_t(x))
    np.testing.assert_allclose(L.sinusoidal_positions(16, 32, "cpu").numpy(),
                               _np(jlayers.sinusoidal_positions(16, 32)),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# mlp and attention units
# ---------------------------------------------------------------------------

def _cfg(**kw):
    return dataclasses.replace(
        configs.get_config("h2o_danube_3_4b", reduced=True), **kw)


def _jcfg(**kw):
    return dataclasses.replace(
        jconfigs.get_config("h2o_danube_3_4b", reduced=True), **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type", ["swiglu", "squared_relu", "gelu"])
def test_mlp_matches_jax(mlp_type, dtype):
    cfg, jcfg = _cfg(mlp_type=mlp_type), _jcfg(mlp_type=mlp_type)
    jp = split_pv_tree(jmlp.init_mlp(jax.random.PRNGKey(1), jcfg))[0]
    p = M.MLP(cfg, dtype=getattr(torch, dtype), device="cpu")
    load_tree(p, jax.tree.map(np.asarray, jp), None, "mlp")
    x = np.random.default_rng(2).standard_normal((2, 7, 64))
    jx = jnp.asarray(x, dtype)
    got = M.apply_mlp(p, cfg, _t(_np(jx), getattr(torch, dtype)))
    want = jmlp.apply_mlp(jp, jcfg, jx)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5,
                                   rtol=1e-5)
    else:
        assert_bf16_close(got, want)


def _attn_pair(cfg, jcfg, dtype, seed=3):
    jp = split_pv_tree(jattn.init_attention(jax.random.PRNGKey(seed),
                                            jcfg))[0]
    rng = np.random.default_rng(seed)
    if "bq" in jp:      # nonzero biases and norm weights, so they count
        jp = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
                  if k in ("bq", "bk", "bv", "q_norm", "k_norm") else v)
              for k, v in jp.items()}
    p = A.Attention(cfg, dtype=getattr(torch, dtype), device="cpu")
    load_tree(p, jax.tree.map(np.asarray, jp), None, "attn")
    return p, jp


def _assert_kv_equal(got, want, dtype):
    """K/V rows: bit-equal in bf16 (projection, bias, norm and RoPE round
    alike), within 1e-5 in fp32 (matmul summation order)."""
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    else:
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5,
                                   rtol=1e-5)


ATTN_CASES = {"danube": {}, "bias+qknorm": {"qkv_bias": True,
                                            "qk_norm": True},
              "no-window": {"window": 0, "attn_type": "full"},
              "mha": {"n_kv_heads": 4},
              "softcap": {"attn_softcap": 5.0}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_prefill_matches_jax(case, dtype):
    cfg, jcfg = _cfg(**ATTN_CASES[case]), _jcfg(**ATTN_CASES[case])
    p, jp = _attn_pair(cfg, jcfg, dtype)
    S = 48
    x = np.random.default_rng(4).standard_normal((2, S, 64))
    jx = jnp.asarray(x, dtype)
    pos = np.arange(S)[None]
    got, (k, v) = A.attn_prefill(p, cfg, _t(_np(jx), getattr(torch, dtype)),
                                 torch.as_tensor(pos))
    want, (jk, jv) = jattn.attn_prefill(jp, jcfg, jx, jnp.asarray(pos))
    _assert_kv_equal(k, jk, dtype)
    _assert_kv_equal(v, jv, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4,
                                   rtol=1e-4)
    else:
        assert_bf16_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring", [True, False])
def test_attn_decode_matches_jax(ring, dtype):
    """The ring branch (window 32, slab 32) and the plain one (no window,
    slab 16: positions >= 16 drop their write, as a JAX scatter does)."""
    kw = {} if ring else {"window": 0, "attn_type": "full"}
    cfg, jcfg = _cfg(**kw), _jcfg(**kw)
    p, jp = _attn_pair(cfg, jcfg, dtype, seed=5)
    T = 32 if ring else 16
    rng = np.random.default_rng(6)
    B, KV, hd = 3, cfg.n_kv_heads, cfg.resolved_head_dim
    ck = jnp.asarray(rng.standard_normal((B, T, KV, hd)), dtype)
    cv = jnp.asarray(rng.standard_normal((B, T, KV, hd)), dtype)
    tk, tv = _t(_np(ck), getattr(torch, dtype)), _t(_np(cv),
                                                    getattr(torch, dtype))
    for pos in ([0, 5, 31], [40, 63, 100]) if ring else ([0, 7, 15],
                                                         [3, 16, 40]):
        x = jnp.asarray(rng.standard_normal((B, 1, 64)), dtype)
        pos = np.asarray(pos, np.int32)
        want, ck, cv = jattn.attn_decode(jp, jcfg, x, ck, cv,
                                         jnp.asarray(pos))
        got, tk, tv = A.attn_decode(p, cfg, _t(_np(x), getattr(torch, dtype)),
                                    tk, tv, torch.as_tensor(pos))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4,
                                       rtol=1e-4)
        else:
            assert_bf16_close(got, want)
        _assert_kv_equal(tk, ck, dtype)
        _assert_kv_equal(tv, cv, dtype)


def _core_repeated(q, k, v, mask, scale, cap=0.0):
    """attention_core as JAX computes it: K/V repeated to H heads."""
    G = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    scores = torch.where(mask, L.softcap(scores, cap), A.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", w, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 1, 40, 8, 2, 16), (2, 9, 9, 6, 3, 8),
                                   (1, 1, 33, 4, 4, 16),
                                   (2, 5, 17, 8, 1, 32)],
                         ids=lambda s: "B{}S{}T{}H{}KV{}hd{}".format(*s))
def test_grouped_core_matches_repeated(shape, dtype):
    """attention_core contracts each KV head against its G query heads
    (head h = kv*G + g); the repeated-K/V form gives the same output:
    within 1e-6 in fp32, within one bf16 ulp in bf16, softcap or not."""
    B, S, T, H, KV, hd = shape
    g = torch.Generator().manual_seed(sum(shape))
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=g).to(dt)
               for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
    mask = torch.rand((B, 1, S, T), generator=g) < 0.7
    mask[..., 0] = True
    for cap in (0.0, 5.0):
        got = A.attention_core(q, k, v, mask, 0.3, cap)
        want = _core_repeated(q, k, v, mask, 0.3, cap)
        tol = 1e-6 if dtype == "float32" else 2 ** -8
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the serving path: prefill -> decode_step
# ---------------------------------------------------------------------------

def _serve_both(name, S=64, steps=4, B=2, max_seq=64):
    """Prefill of S seeded tokens then ``steps`` decode steps through both
    packages.  Whisper's encoder takes seeded frames [B, n_enc_ctx, d]; the
    ``:patches`` variant prepends seeded patch embeddings [B, F, d] to the
    text (its cache and positions grow by F)."""
    cfg, jcfg = _configs(name)
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(7))
    lm = from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (B, S + steps)).astype(np.int32)
    extra, F = None, 0
    if cfg.is_enc_dec:
        extra = rng.standard_normal((B, cfg.n_enc_ctx, cfg.d_model))
    elif name.endswith(":patches"):
        F = cfg.n_frontend_tokens
        extra = rng.standard_normal((B, F, cfg.d_model))
    if extra is not None:
        extra = extra.astype(np.float32)
    jc = jtf.init_cache(jcfg, B, max_seq + F)
    tc = TF.init_cache(cfg, B, max_seq + F, device="cpu")
    jl, jc = jax.jit(lambda p, t, c, e: jtf.prefill(p, jcfg, t, c, e))(
        params, jnp.asarray(toks[:, :S]), jc,
        None if extra is None else jnp.asarray(extra))
    n0 = FAK.flash_attention_kernel.launches
    tl, tc = TF.prefill(lm, cfg, torch.as_tensor(toks[:, :S]), tc,
                        None if extra is None else torch.as_tensor(extra))
    assert FAK.flash_attention_kernel.launches == n0    # CPU: plain version
    out = [(tl, jl, _snapshot(tc), _jax_cache_layers(jc, cfg))]
    dec = jax.jit(lambda p, t, pos, c: jtf.decode_step(p, jcfg, t, pos, c))
    for i in range(steps):
        pos = np.full((B,), F + S + i, np.int32)
        jl, jc = dec(params, jnp.asarray(toks[:, S + i]), jnp.asarray(pos), jc)
        tl, tc = TF.decode_step(lm, cfg, torch.as_tensor(toks[:, S + i]),
                                torch.as_tensor(pos), tc)
        out.append((tl, jl, _snapshot(tc), _jax_cache_layers(jc, cfg)))
    return cfg, out


def _route_on_jax_inputs(monkeypatch):
    """Hold each MoE call of the port on the h2 of JAX's matching call.

    JAX's ``_route`` records (h2, gates, experts) of every call, in
    order; the port's ``_route`` takes the next record, asserts its own
    h2 within TOL of JAX's and its routing of JAX's h2 equal to JAX's bit
    for bit, and returns that routing.  The returned list gets, per call,
    the number of picks the port's own h2 would have routed otherwise."""
    calls, flips = [], []
    jroute, troute = jmoe._route, MOE._route

    def recording(p, cfg, x):
        gates, experts, aux = jroute(p, cfg, x)
        jax.debug.callback(
            lambda *a: calls.append([np.array(t) for t in a]), x, gates,
            experts, ordered=True)
        return gates, experts, aux

    def on_jax_input(p, cfg, x):
        jax.effects_barrier()
        jx, jg, je = calls.pop(0)
        assert_bf16_close(x, jx)
        gates, experts, aux = troute(p, cfg, _t(_np(jx), x.dtype))
        np.testing.assert_array_equal(experts.numpy(), je)
        np.testing.assert_array_equal(gates.float().numpy(), _np(jg))
        flips.append(int((troute(p, cfg, x)[1].numpy() != je).sum()))
        return gates, experts, aux

    monkeypatch.setattr(jmoe, "_route", recording)
    monkeypatch.setattr(MOE, "_route", on_jax_input)
    return flips


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_decode_match_jax_bf16(arch, monkeypatch):
    """Reduced configs at S = 64 (Danube and RecurrentGemma: window 32 < S,
    so the prefill merge keeps the ring-aligned tail and decode runs the
    ring branch); every cache entry of every layer (K/V slabs, recurrent
    states and conv windows, whisper's cross K/V) is held.  MoE archs
    route each call on JAX's h2 (``_route_on_jax_inputs``)."""
    moe = arch in MOE_ARCHS
    if moe:
        flips = _route_on_jax_inputs(monkeypatch)
    cfg, out = _serve_both(arch)
    for tl, jl, tc, jc in out:
        assert tl.dtype == torch.bfloat16 and tl.shape == (2, cfg.vocab_size)
        assert_bf16_close(tl, jl)
        for t, j in zip(tc, jc, strict=True):
            assert t.keys() == j.keys()
            for n in t:
                assert_bf16_close(t[n], j[n])
    if moe:     # every MoE call of the prefill and the 4 steps was held
        assert len(flips) == cfg.n_layers * len(out)


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_decode_match_jax_fp32(arch, monkeypatch):
    """The same path with fp32 as the compute dtype on both sides: the
    algorithm, masks and ring arithmetic agree to fp32 rounding."""
    monkeypatch.setattr(jtf, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TF, "COMPUTE_DTYPE", torch.float32)
    cfg, out = _serve_both(arch)
    for tl, jl, tc, jc in out:
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
        for t, j in zip(tc, jc, strict=True):
            assert t.keys() == j.keys()
            for n in t:
                np.testing.assert_allclose(t[n].numpy(), _np(j[n]),
                                           atol=1e-4, rtol=1e-4)


def test_ring_slab_incongruent_prompt_mirrors_jax(monkeypatch):
    """ROADMAP R6: with S % T != 0 (S = 48, window slab T = 32) the prefill
    merge keeps positions 16..47 in slots 0..31, where decode expects
    position p in slot p % T.  The port mirrors the reference, cache and
    logits alike."""
    monkeypatch.setattr(jtf, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TF, "COMPUTE_DTYPE", torch.float32)
    cfg, out = _serve_both("h2o_danube_3_4b", S=48, steps=2)
    for tl, jl, tc, jc in out:
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
        for t, j in zip(tc, jc):
            np.testing.assert_allclose(t["k"].numpy(), _np(j["k"]),
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n_frames", [10, 24])
def test_whisper_frames_other_than_n_enc_ctx_mirror_jax(n_frames,
                                                         monkeypatch):
    """ROADMAP R9: the cross K/V slab holds n_enc_ctx (16) frames; a
    prefill over 10 frames leaves zero rows that decode attends to, one
    over 24 keeps the last 16.  The port mirrors the reference (fp32)."""
    monkeypatch.setattr(jtf, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TF, "COMPUTE_DTYPE", torch.float32)
    cfg, jcfg = _configs("whisper_base")
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(7))
    lm = from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(18)
    toks = rng.integers(0, cfg.vocab_size, (2, 14)).astype(np.int32)
    frames = rng.standard_normal((2, n_frames, cfg.d_model)).astype(
        np.float32)
    jc, tc = jtf.init_cache(jcfg, 2, 16), TF.init_cache(cfg, 2, 16,
                                                        device="cpu")
    jl, jc = jtf.prefill(params, jcfg, jnp.asarray(toks[:, :12]), jc,
                         jnp.asarray(frames))
    tl, tc = TF.prefill(lm, cfg, torch.as_tensor(toks[:, :12]), tc,
                        torch.as_tensor(frames))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
    for i in range(2):
        pos = np.full((2,), 12 + i, np.int32)
        jl, jc = jtf.decode_step(params, jcfg, jnp.asarray(toks[:, 12 + i]),
                                 jnp.asarray(pos), jc)
        tl, tc = TF.decode_step(lm, cfg, torch.as_tensor(toks[:, 12 + i]),
                                torch.as_tensor(pos), tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4,
                                   rtol=1e-4)
    for t, j in zip(tc, _jax_cache_layers(jc, cfg)):
        np.testing.assert_allclose(t["cross_k"].numpy(), _np(j["cross_k"]),
                                   atol=1e-4, rtol=1e-4)
    assert bool(tc[0]["cross_k"][:, n_frames:].eq(0).all())


@pytest.mark.parametrize("arch", ["h2o_danube_3_4b", "minicpm_2b"] +
                         RECURRENT)
def test_teacher_forced_decode_equals_prefill(arch):
    """In the port alone: decoding a prompt token by token from an empty
    cache gives the last logits of its prefill (Danube and RecurrentGemma:
    S = 64 over a window of 32, the ring slab; the recurrent states carry
    the rest)."""
    cfg = configs.get_config(arch, reduced=True)
    lm = TF.init_lm(cfg, 9, device="cpu")
    B, S = 2, 64
    toks = torch.as_tensor(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (B, S)))
    want, _ = TF.prefill(lm, cfg, toks, TF.init_cache(cfg, B, S,
                                                      device="cpu"))
    cache = TF.init_cache(cfg, B, S, device="cpu")
    for i in range(S):
        got, cache = TF.decode_step(lm, cfg, toks[:, i],
                                    torch.full((B,), i), cache)
    assert_bf16_close(got, want)


# ---------------------------------------------------------------------------
# shapes, indexing rules, what is not ported
# ---------------------------------------------------------------------------

def _port_names(cfg, keys, shape):
    """{port parameter name: shape} of one leaf of JAX's init_lm tree: a
    stacked leaf (superblocks ``layers.b{i}_{kind}``, whisper's
    ``encoder.blocks`` and ``cross``) names one parameter per layer it
    stacks, a remainder block ``rem{j}_{kind}`` the layer after the
    superblocks."""
    pat = cfg.block_pattern or ("attn",)
    n_super = cfg.n_layers // len(pat)
    rest = ".".join(keys[2:])
    if keys[0] == "layers":
        i = int(keys[1][1:].split("_")[0])
        return {f"layers.{s * len(pat) + i}.{rest}": shape[1:]
                for s in range(n_super)}
    if keys[0].startswith("rem"):
        j = int(keys[0][3:].split("_")[0])
        return {f"layers.{n_super * len(pat) + j}." + ".".join(keys[1:]):
                shape}
    if keys[:2] == ["encoder", "blocks"]:
        return {f"encoder.blocks.{i}.{rest}": shape[1:]
                for i in range(cfg.n_enc_layers)}
    if keys[0] == "cross":
        return {f"cross.{i}." + ".".join(keys[1:]): shape[1:]
                for i in range(cfg.n_layers)}
    return {".".join(keys): shape}


@pytest.mark.parametrize("arch", ALL_CONFIGS)
def test_full_width_init_shapes_match_jax(arch):
    """init_lm at full width and depth on the meta device has JAX's
    init_lm tree shapes (``jax.eval_shape``: nothing is allocated), every
    layer kind, the remainder blocks and whisper's encoder and cross
    stacks included."""
    cfg, jcfg = _configs(arch, reduced=False)
    shapes = jax.eval_shape(
        lambda: jtf.init_lm(jcfg, jax.random.PRNGKey(0))[0])
    lm = TF.init_lm(cfg, 0, device="meta")
    own = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    want = {}
    for name, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        want.update(_port_names(cfg, [k.key for k in name],
                                tuple(leaf.shape)))
    assert own == want
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(leaf.size for leaf in jax.tree.leaves(shapes))
    assert [b.kind for b in lm.layers] == TF.layer_kinds(cfg)
    if arch == "h2o_danube_3_4b":
        assert lm.layers[0].attn.wq.shape == (3840, 32, 120)
        assert n == cfg.n_params() + (2 * cfg.n_layers + 1) * cfg.d_model
    if arch == "recurrentgemma_9b":     # 12 x (R, R, A), then R, R
        assert TF.layer_kinds(cfg)[-3:] == ["attn", "rglru", "rglru"]
        assert round(n / 1e9, 3) == 9.396
        assert lm.layers[37].rglru.wa.dtype == torch.float32
        assert lm.layers[37].rglru.w_main.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ALL_CONFIGS)
@pytest.mark.parametrize("max_seq", [16, 64, 8192])
def test_cache_shapes_match_jax(arch, max_seq):
    """Each layer's entry has JAX's shapes (a stacked leaf less its stack
    axis) and dtypes: K/V slabs and conv windows bf16, recurrent states
    fp32; whisper's cross K/V by layer."""
    for reduced in (True, False):
        cfg, jcfg = _configs(arch, reduced=reduced)
        own = TF.cache_shapes(cfg, 3, max_seq)
        want = _jax_layer_entries(jtf.cache_shapes(jcfg, 3, max_seq), cfg)
        assert len(own) == len(want) == cfg.n_layers
        for o, w in zip(own, want):
            assert o.keys() == w.keys()
            for n, ((shape, dtype, _), i) in w.items():
                assert o[n][0] == (shape if i is None else shape[1:])
                assert str(o[n][1]) == f"torch.{jnp.dtype(dtype).name}"


def test_embed_gather_follows_jax_index_rules():
    """Out-of-range ids clamp and a negative one wraps once, as a JAX
    gather does; raw torch indexing would raise."""
    cfg = configs.get_config("h2o_danube_3_4b", reduced=True)
    jcfg = jconfigs.get_config("h2o_danube_3_4b", reduced=True)
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(11))
    lm = from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    ids = np.array([[0, 255, 256, 10_000, -1, -300]], np.int32)
    got = TF.embed_tokens(lm, cfg, torch.as_tensor(ids))
    want = jtf.embed_tokens(params, jcfg, jnp.asarray(ids))
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_unembed_masks_vocab_padding_and_scales_like_jax():
    kw = dict(vocab_size=250, dim_model_base=16, logit_softcap=30.0)
    cfg = dataclasses.replace(configs.get_config("minicpm_2b", reduced=True),
                              **kw)
    jcfg = dataclasses.replace(
        jconfigs.get_config("minicpm_2b", reduced=True), **kw)
    assert cfg.padded_vocab == 256
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(12))
    lm = from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    x = jnp.asarray(np.random.default_rng(13).standard_normal((2, 3, 64)),
                    jnp.bfloat16)
    got = TF.unembed(lm, cfg, _t(_np(x), torch.bfloat16))
    want = jtf.unembed(params, jcfg, x)
    assert bool((got[..., 250:] == -1e30).all())
    assert_bf16_close(got[..., :250], jnp.asarray(want)[..., :250])


def test_extra_embeds_and_training_raise():
    """A mode other than train/prefill/decode raises, for every block
    kind, and training runs (``tests/test_torch_train.py`` holds it
    against JAX).  extra_embeds serve: a VLM prepends them to the text;
    whisper's encoder needs them and raises without them, in prefill and
    in training."""
    cfg = configs.get_config("internvl2_2b", reduced=True)
    lm = TF.init_lm(cfg, 0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    logits, cache = TF.prefill(lm, cfg, toks,
                               TF.init_cache(cfg, 1, 8, device="cpu"),
                               extra_embeds=torch.zeros((1, 2, cfg.d_model)))
    assert logits.shape == (1, cfg.padded_vocab)
    # 2 patches then 4 tokens: slots 2..5 hold the text's keys, 6..7 none
    assert bool(cache[0]["k"][:, 2:6].ne(0).any())
    assert bool(cache[0]["k"][:, 6:].eq(0).all())
    wcfg = configs.get_config("whisper_base", reduced=True)
    wlm = TF.init_lm(wcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        TF.prefill(wlm, wcfg, toks, TF.init_cache(wcfg, 1, 8, device="cpu"))
    with pytest.raises(ValueError, match="frames"):
        TF.forward_train(wlm, wcfg, toks)
    for arch in ("internvl2_2b", "recurrentgemma_9b", "mamba2_130m"):
        cfg = configs.get_config(arch, reduced=True)
        lm = TF.init_lm(cfg, 0, device="cpu")
        with pytest.raises(ValueError, match="mode 'serve'"):
            TF.apply_block(lm.layers[0], cfg,
                           torch.zeros((1, 4, cfg.d_model)),
                           torch.arange(4)[None], "serve")
        with pytest.raises(ValueError, match="mode 'serve'"):
            TF.check_supported(cfg, "serve")
        x, cache, aux = TF.apply_block(lm.layers[0], cfg,
                                       torch.zeros((1, 4, cfg.d_model)),
                                       torch.arange(4)[None], "train")
        assert x.shape == (1, 4, cfg.d_model) and cache is None
        assert float(aux) == 0.0
        for mode in TF.MODES:
            TF.check_supported(cfg, mode)


def test_from_jax_params_rejects_a_mismatched_tree():
    cfg = configs.get_config("qwen15_32b", reduced=True)
    jcfg = jconfigs.get_config("qwen15_32b", reduced=True)
    params = jax.tree.map(np.asarray,
                          jtf.init_lm(jcfg, jax.random.PRNGKey(14))[0])
    del params["layers"]["b0_attn"]["attn"]["bq"]
    with pytest.raises(KeyError, match="bq"):
        from_jax_params(cfg, params, device="cpu")
    params = jax.tree.map(np.asarray,
                          jtf.init_lm(jcfg, jax.random.PRNGKey(14))[0])
    params["final_norm"]["w"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(cfg, params, device="cpu")
    # the moe subtree of an MoE config: a missing leaf, a leaf of the
    # wrong shape
    cfg = configs.get_config("granite_moe_3b_a800m", reduced=True)
    jcfg = jconfigs.get_config("granite_moe_3b_a800m", reduced=True)
    params = jax.tree.map(np.asarray,
                          jtf.init_lm(jcfg, jax.random.PRNGKey(14))[0])
    del params["layers"]["b0_attn"]["moe"]["w_up"]
    with pytest.raises(KeyError, match="w_up"):
        from_jax_params(cfg, params, device="cpu")
    params = jax.tree.map(np.asarray,
                          jtf.init_lm(jcfg, jax.random.PRNGKey(14))[0])
    router = params["layers"]["b0_attn"]["moe"]["router"]
    params["layers"]["b0_attn"]["moe"]["router"] = router[..., :40]
    with pytest.raises(ValueError, match="router"):
        from_jax_params(cfg, params, device="cpu")


@pytest.mark.parametrize("case", ["rem_leaf", "encoder_leaf", "cross_shape",
                                  "extra_rem"])
def test_from_jax_params_rejects_recurrent_and_encoder_mismatch(case):
    """A missing leaf of a remainder block or of whisper's encoder, a cross
    stack leaf of the wrong shape, and a remainder block the config does
    not have, each raise."""
    arch = "whisper_base" if case.startswith(("encoder", "cross")) else \
        "recurrentgemma_9b:8L"
    cfg, jcfg = _configs(arch)
    params = jax.tree.map(np.asarray,
                          jtf.init_lm(jcfg, jax.random.PRNGKey(14))[0])
    from_jax_params(cfg, params, device="cpu")     # the whole tree loads
    if case == "rem_leaf":
        del params["rem1_rglru"]["rglru"]["lam"]
        err, match = KeyError, "lam"
    elif case == "encoder_leaf":
        del params["encoder"]["blocks"]["mlp"]["w_up"]
        err, match = KeyError, "w_up"
    elif case == "cross_shape":
        wq = params["cross"]["attn"]["wq"]
        params["cross"]["attn"]["wq"] = wq[..., :-1]
        err, match = ValueError, "wq"
    else:
        params["rem2_attn"] = params["rem0_rglru"]
        err, match = KeyError, "rem2_attn"
    with pytest.raises(err, match=match):
        from_jax_params(cfg, params, device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = configs.get_config("h2o_danube_3_4b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.init_lm(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.init_cache(cfg, 1, 8)


_DEFAULT_DEVICE_CALLS = {
    "LM": lambda cfg: TF.LM(cfg),
    "Block": lambda cfg: TF.Block(cfg),
    "Attention": lambda cfg: A.Attention(cfg),
    "MLP": lambda cfg: M.MLP(cfg),
    "MoE": lambda cfg: MOE.MoE(configs.get_config("qwen3_moe_30b_a3b",
                                                  reduced=True)),
    "RGLRU": lambda cfg: RG.RGLRU(configs.get_config("recurrentgemma_9b",
                                                     reduced=True)),
    "SSM": lambda cfg: SSM.SSM(configs.get_config("mamba2_130m",
                                                  reduced=True)),
    "Block(ssm)": lambda cfg: TF.Block(configs.get_config("mamba2_130m",
                                                          reduced=True),
                                       kind="ssm"),
    "Encoder": lambda cfg: TF.Encoder(configs.get_config("whisper_base",
                                                         reduced=True)),
    "CrossBlock": lambda cfg: TF.CrossBlock(configs.get_config(
        "whisper_base", reduced=True)),
    "init_norm": lambda cfg: L.init_norm(cfg.norm_type, cfg.d_model),
    "dense_init": lambda cfg: L.dense_init(None, cfg.d_model, cfg.d_ff),
    "embed_init": lambda cfg: L.embed_init(None, cfg.vocab_size,
                                           cfg.d_model),
    "rope_freqs": lambda cfg: L.rope_freqs(cfg.resolved_head_dim, 1e4),
    "sinusoidal_positions": lambda cfg: L.sinusoidal_positions(8, 16),
    "from_jax_params": lambda cfg: from_jax_params(cfg, {}),
    "init_lm(float32)": lambda cfg: TF.init_lm(cfg, 0, dtype=torch.float32),
    "init_train_state": lambda cfg: init_train_state(cfg, 0),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_DEVICE_CALLS))
def test_constructors_default_to_cuda(name, monkeypatch):
    """Every module and initialiser that makes a tensor places it on
    ``cuda`` unless the CPU is asked for: with no usable card it raises
    instead of building on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("h2o_danube_3_4b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        _DEFAULT_DEVICE_CALLS[name](cfg)
