"""The port's dense LM serving path (``repro_torch.models``) against the
JAX package's ``repro.models``.

Weights come from the JAX ``init_lm`` (as numpy) through
``weights.from_jax_params``; inputs from ``numpy.random.default_rng``.  In
bf16 (the compute dtype of both) the two round at different places: the
port's prefill goes through the flash kernel's plain version (fp32 scores
and weights) where JAX's ``attention_core`` rounds both to bf16, and bf16
matmuls accumulate in another order.  So bf16 results are held within
2e-2 by relative norm and by max |error| / max |value|; the same paths in
fp32 (``COMPUTE_DTYPE`` switched on both sides) are held within 1e-4.
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
from repro.models import transformer as jtf
from repro.models.layers import split_pv_tree
from repro_torch import configs
from repro_torch.kernels.flash_attention import kernel as FAK
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import transformer as TF
from repro_torch.models.weights import from_jax_params, load_tree

DENSE = ["h2o_danube_3_4b", "minicpm_2b", "qwen15_32b", "nemotron_4_340b",
         "internvl2_2b"]
NOT_PORTED = ["qwen3_moe_30b_a3b", "granite_moe_3b_a800m",
              "recurrentgemma_9b", "mamba2_130m", "whisper_base"]
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


def _jax_cache_layers(jcache, n_layers):
    return [{n: jcache["layers"]["b0_attn"][n][i] for n in "kv"}
            for i in range(n_layers)]


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


# ---------------------------------------------------------------------------
# the serving path: prefill -> decode_step
# ---------------------------------------------------------------------------

def _serve_both(arch, S=64, steps=4, B=2, max_seq=64):
    jcfg = jconfigs.get_config(arch, reduced=True)
    cfg = configs.get_config(arch, reduced=True)
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(7))
    lm = from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, S + steps)).astype(np.int32)
    jc = jtf.init_cache(jcfg, B, max_seq)
    tc = TF.init_cache(cfg, B, max_seq, device="cpu")
    jl, jc = jax.jit(lambda p, t, c: jtf.prefill(p, jcfg, t, c))(
        params, jnp.asarray(toks[:, :S]), jc)
    n0 = FAK.flash_attention_kernel.launches
    tl, tc = TF.prefill(lm, cfg, torch.as_tensor(toks[:, :S]), tc)
    assert FAK.flash_attention_kernel.launches == n0    # CPU: plain version
    out = [(tl, jl, _snapshot(tc), _jax_cache_layers(jc, cfg.n_layers))]
    dec = jax.jit(lambda p, t, pos, c: jtf.decode_step(p, jcfg, t, pos, c))
    for i in range(steps):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = dec(params, jnp.asarray(toks[:, S + i]), jnp.asarray(pos), jc)
        tl, tc = TF.decode_step(lm, cfg, torch.as_tensor(toks[:, S + i]),
                                torch.as_tensor(pos), tc)
        out.append((tl, jl, _snapshot(tc),
                    _jax_cache_layers(jc, cfg.n_layers)))
    return cfg, out


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_match_jax_bf16(arch):
    """Reduced configs at S = 64 (Danube: window 32 < S, so the prefill
    merge keeps the ring-aligned tail and decode runs the ring branch)."""
    cfg, out = _serve_both(arch)
    for tl, jl, tc, jc in out:
        assert tl.dtype == torch.bfloat16 and tl.shape == (2, cfg.vocab_size)
        assert_bf16_close(tl, jl)
        for t, j in zip(tc, jc):
            assert_bf16_close(t["k"], j["k"])
            assert_bf16_close(t["v"], j["v"])


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_match_jax_fp32(arch, monkeypatch):
    """The same path with fp32 as the compute dtype on both sides: the
    algorithm, masks and ring arithmetic agree to fp32 rounding."""
    monkeypatch.setattr(jtf, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TF, "COMPUTE_DTYPE", torch.float32)
    cfg, out = _serve_both(arch)
    for tl, jl, tc, jc in out:
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
        for t, j in zip(tc, jc):
            np.testing.assert_allclose(t["k"].numpy(), _np(j["k"]),
                                       atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(t["v"].numpy(), _np(j["v"]),
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


@pytest.mark.parametrize("arch", ["h2o_danube_3_4b", "minicpm_2b"])
def test_teacher_forced_decode_equals_prefill(arch):
    """In the port alone: decoding a prompt token by token from an empty
    cache gives the last logits of its prefill (Danube: S = 64 over a
    window of 32, the ring slab)."""
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

@pytest.mark.parametrize("arch", DENSE)
def test_full_width_init_shapes_match_jax(arch):
    """init_lm at full width and depth on the meta device has JAX's
    init_lm tree shapes (``jax.eval_shape``: nothing is allocated)."""
    cfg = configs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    shapes = jax.eval_shape(
        lambda: jtf.init_lm(jcfg, jax.random.PRNGKey(0))[0])
    lm = TF.init_lm(cfg, 0, device="meta")
    own = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    want = {}
    for name, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in name]
        if keys[0] == "layers":
            for i in range(cfg.n_layers):
                want[".".join(["layers", str(i)] + keys[2:])] = \
                    tuple(leaf.shape[1:])
        else:
            want[".".join(keys)] = tuple(leaf.shape)
    assert own == want
    n = sum(p.numel() for p in lm.parameters())
    if arch == "h2o_danube_3_4b":
        assert lm.layers[0].attn.wq.shape == (3840, 32, 120)
        assert n == cfg.n_params() + (2 * cfg.n_layers + 1) * cfg.d_model


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("max_seq", [16, 64, 8192])
def test_cache_shapes_match_jax(arch, max_seq):
    for reduced in (True, False):
        cfg = configs.get_config(arch, reduced=reduced)
        jcfg = jconfigs.get_config(arch, reduced=reduced)
        own = TF.cache_shapes(cfg, 3, max_seq)
        want = jtf.cache_shapes(jcfg, 3, max_seq)["layers"]["b0_attn"]
        assert len(own) == cfg.n_layers
        for n in "kv":
            assert (cfg.n_layers,) + own[0][n][0] == want[n][0]
            assert own[0][n][1] == torch.bfloat16


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


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_configs_raise(arch):
    cfg = configs.get_config(arch, reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TF.init_lm(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TF.init_cache(cfg, 1, 8, device="cpu")


def test_extra_embeds_and_training_raise():
    cfg = configs.get_config("internvl2_2b", reduced=True)
    lm = TF.init_lm(cfg, 0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TF.prefill(lm, cfg, toks, TF.init_cache(cfg, 1, 8, device="cpu"),
                   extra_embeds=torch.zeros((1, 2, cfg.d_model)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TF.apply_block(lm.layers[0], cfg, torch.zeros((1, 4, cfg.d_model)),
                       torch.arange(4)[None], "train")


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
    "init_norm": lambda cfg: L.init_norm(cfg.norm_type, cfg.d_model),
    "dense_init": lambda cfg: L.dense_init(None, cfg.d_model, cfg.d_ff),
    "embed_init": lambda cfg: L.embed_init(None, cfg.vocab_size,
                                           cfg.d_model),
    "rope_freqs": lambda cfg: L.rope_freqs(cfg.resolved_head_dim, 1e4),
    "sinusoidal_positions": lambda cfg: L.sinusoidal_positions(8, 16),
    "from_jax_params": lambda cfg: from_jax_params(cfg, {}),
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
