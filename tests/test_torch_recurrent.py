"""The port's recurrent, state-space and encoder-decoder pieces of
``repro_torch.models`` against the JAX package's, on seeded numpy inputs.

``models/rglru.py`` (the conv, the gate coefficients, the RG-LRU block in
prefill with and without a carried state, and decode), ``models/ssm.py``
(the causal conv, the chunked SSD at S < chunk, S % chunk == 0 and a
ragged S, each with and without h0, the decode step and the whole
block), whisper's ``cross_kv``/``cross_attend``/``bidir_attend`` and the
``activation_sharding`` hooks (the embed_onehot branch included).

Tolerances, as the dense path is held: fp32 within 1e-4 (the RG-LRU scan
and the SSD sum in another order than JAX's associative scan and
einsums), bf16 within 2e-2 by relative norm and by max |error| / max
|value| (the two frameworks round bf16 at other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import activation_sharding as jas
from repro.models import attention as jattn
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models.layers import split_pv_tree
from repro_torch import configs
from repro_torch.models import activation_sharding as AS
from repro_torch.models import attention as A
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as TF
from repro_torch.models.weights import from_jax_params, load_tree

FP32_TOL = 1e-4
BF16_TOL = 2e-2
DTYPES = ["float32", "bfloat16"]


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x, np.float32)).to(dtype)


def _both(x, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    j = jnp.asarray(np.asarray(x, np.float32), dtype)
    return j, _t(_np(j), getattr(torch, dtype))


def assert_close(got, want, dtype):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else _np(got)
    w = want.float().numpy() if isinstance(want, torch.Tensor) else _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=FP32_TOL, rtol=FP32_TOL)
        return
    scale = np.abs(w).max()
    assert np.abs(g - w).max() <= BF16_TOL * scale, \
        f"max abs err {np.abs(g - w).max()} vs {BF16_TOL} x {scale}"
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= BF16_TOL, f"relative norm {rel}"


def _cfgs(arch, **kw):
    return (dataclasses.replace(configs.get_config(arch, reduced=True), **kw),
            dataclasses.replace(jconfigs.get_config(arch, reduced=True),
                                **kw))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_pair(dtype, seed=1):
    cfg, jcfg = _cfgs("recurrentgemma_9b")
    jp = split_pv_tree(jrg.init_rglru(jax.random.PRNGKey(seed), jcfg))[0]
    rng = np.random.default_rng(seed)
    # nonzero biases, so they count
    jp = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
              if k in ("ba", "bx", "conv_b") else v) for k, v in jp.items()}
    p = RG.RGLRU(cfg, dtype=getattr(torch, dtype), device="cpu")
    load_tree(p, jax.tree.map(np.asarray, jp), None, "rglru")
    return cfg, jcfg, p, jp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("module", ["rglru", "ssm"])
def test_causal_conv_matches_jax(module, with_state, dtype):
    """``_conv1d`` (RG-LRU) and ``_causal_conv`` (SSM, SiLU in fp32), with
    and without a carried state; S = 2 < W - 1 keeps part of the state in
    the new one."""
    rng = np.random.default_rng(2)
    W, C = 4, 24
    w, b = rng.standard_normal((W, C)) * 0.3, rng.standard_normal(C) * 0.1
    for S in (9, 2):
        x = rng.standard_normal((2, S, C))
        st = rng.standard_normal((2, W - 1, C)) if with_state else None
        jx, tx = _both(x, dtype)
        jst, tst = _both(st, dtype) if with_state else (None, None)
        jf, tf = (jrg._conv1d, RG._conv1d) if module == "rglru" else \
            (jssm._causal_conv, SSM._causal_conv)
        want = jf(jx, jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32),
                  jst)
        got = tf(tx, _t(w), _t(b), tst)
        for g, j in zip(got, want):
            assert g.dtype == tx.dtype
            assert_close(g, j, dtype)


def test_rglru_coeffs_match_jax():
    cfg, jcfg, p, jp = _rglru_pair("float32")
    u = np.random.default_rng(3).standard_normal((2, 7, 64))
    ja, jb = jrg._rglru_coeffs(jp, jcfg, jnp.asarray(u, jnp.float32))
    ta, tb = RG._rglru_coeffs(p, cfg, _t(u))
    assert ta.dtype == tb.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), _np(ja), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), _np(jb), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_linear_scan_equals_the_sequential_recurrence(S):
    """The log-depth scan against h_t = a_t h_{t-1} + b_t step by step, in
    fp32 (a in (0, 1), as the RG-LRU's is)."""
    g = torch.Generator().manual_seed(S)
    a = torch.rand((3, S, 5), generator=g)
    b = torch.randn((3, S, 5), generator=g)
    h, want = torch.zeros(3, 5), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = RG.linear_scan(a, b)
    torch.testing.assert_close(got, torch.stack(want, 1), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_apply_rglru_prefill_matches_jax(with_h0, dtype):
    cfg, jcfg, p, jp = _rglru_pair(dtype)
    rng = np.random.default_rng(4)
    jx, tx = _both(rng.standard_normal((2, 40, 64)), dtype)
    h0 = rng.standard_normal((2, 64)).astype(np.float32) if with_h0 else None
    cs = rng.standard_normal((2, 3, 64)) if with_h0 else None
    jcs, tcs = _both(cs, dtype) if with_h0 else (None, None)
    want, (jh, jc) = jrg.apply_rglru(
        jp, jcfg, jx, h0=None if h0 is None else jnp.asarray(h0),
        conv_state=jcs)
    got, (th, tc) = RG.apply_rglru(p, cfg, tx,
                                   h0=None if h0 is None else _t(h0),
                                   conv_state=tcs)
    assert got.dtype == tx.dtype and th.dtype == torch.float32
    assert_close(got, want, dtype)
    assert_close(th, jh, dtype)
    assert_close(tc, jc, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rglru_decode_matches_jax(dtype):
    """Four decode steps, each on the state the last one left, from a zero
    state first."""
    cfg, jcfg, p, jp = _rglru_pair(dtype, seed=5)
    rng = np.random.default_rng(6)
    jh = th = jcs = tcs = None
    for _ in range(4):
        jx, tx = _both(rng.standard_normal((3, 1, 64)), dtype)
        want, (jh, jcs) = jrg.apply_rglru(jp, jcfg, jx, h0=jh,
                                          conv_state=jcs, decode=True)
        got, (th, tcs) = RG.apply_rglru(p, cfg, tx, h0=th, conv_state=tcs,
                                        decode=True)
        assert_close(got, want, dtype)
        assert_close(th, jh, dtype)
        assert_close(tcs, jcs, dtype)


# ---------------------------------------------------------------------------
# SSM (Mamba-2 SSD)
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, B, S, H, P, N):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0)) \
        .astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [5, 32, 48, 37], ids=lambda s: f"S{s}")
def test_ssd_chunked_matches_jax(S, with_h0):
    """chunk 16: S = 5 < chunk (one chunk of 5), S % chunk == 0 (32, 48),
    and a ragged S = 37 (chunks of 16, zero-dt padding to 48)."""
    rng = np.random.default_rng(S)
    ins = _ssd_inputs(rng, 2, S, 3, 4, 8)
    h0 = rng.standard_normal((2, 3, 4, 8)).astype(np.float32) \
        if with_h0 else None
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, ins), 16,
                              h0=None if h0 is None else jnp.asarray(h0))
    ty, th = SSM.ssd_chunked(*map(_t, ins), 16,
                             h0=None if h0 is None else _t(h0))
    assert ty.shape == (2, S, 3, 4) and th.shape == (2, 3, 4, 8)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=FP32_TOL,
                               rtol=FP32_TOL)
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=FP32_TOL,
                               rtol=FP32_TOL)


def test_ssd_chunked_equals_its_decode_steps():
    """In the port alone: the chunked scan at a ragged S equals the decode
    recurrence run token by token (the smoke's gate on the card)."""
    rng = np.random.default_rng(9)
    x, dt, A, Bm, Cm, D = map(_t, _ssd_inputs(rng, 2, 37, 3, 4, 8))
    y, hT = SSM.ssd_chunked(x, dt, A, Bm, Cm, D, 16)
    h = torch.zeros(2, 3, 4, 8)
    for t in range(37):
        yt, h = SSM.ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                    D, h)
        torch.testing.assert_close(y[:, t], yt, atol=FP32_TOL, rtol=FP32_TOL)
    torch.testing.assert_close(hT, h, atol=FP32_TOL, rtol=FP32_TOL)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(10)
    x, dt, A, Bm, Cm, D = _ssd_inputs(rng, 2, 1, 3, 4, 8)
    h = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D, h)
    jy, jh = jssm.ssd_decode_step(*map(jnp.asarray, args))
    ty, th = SSM.ssd_decode_step(*map(_t, args))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=1e-5, rtol=1e-5)


def _ssm_pair(dtype, seed=11):
    cfg, jcfg = _cfgs("mamba2_130m")
    jp = split_pv_tree(jssm.init_ssm(jax.random.PRNGKey(seed), jcfg))[0]
    rng = np.random.default_rng(seed)
    jp = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
              if k in ("norm_w", "conv_b", "D") else v)
          for k, v in jp.items()}
    p = SSM.SSM(cfg, dtype=getattr(torch, dtype), device="cpu")
    load_tree(p, jax.tree.map(np.asarray, jp), None, "ssm")
    return cfg, jcfg, p, jp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [10, 37])
def test_apply_ssm_matches_jax(S, dtype):
    """Prefill of S tokens (S < chunk 16 and ragged), then 3 decode steps
    on the state it left."""
    cfg, jcfg, p, jp = _ssm_pair(dtype)
    rng = np.random.default_rng(12 + S)
    jx, tx = _both(rng.standard_normal((2, S, 64)), dtype)
    want, (jh, jc) = jssm.apply_ssm(jp, jcfg, jx)
    got, (th, tc) = SSM.apply_ssm(p, cfg, tx)
    assert got.dtype == tx.dtype and th.dtype == torch.float32
    assert_close(got, want, dtype)
    assert_close(th, jh, dtype)
    assert_close(tc, jc, dtype)
    for _ in range(3):
        jx, tx = _both(rng.standard_normal((2, 1, 64)), dtype)
        want, (jh, jc) = jssm.apply_ssm(jp, jcfg, jx, h0=jh, conv_state=jc,
                                        decode=True)
        got, (th, tc) = SSM.apply_ssm(p, cfg, tx, h0=th, conv_state=tc,
                                      decode=True)
        assert_close(got, want, dtype)
        assert_close(th, jh, dtype)


def test_ssm_dims_match_jax():
    for arch in ("mamba2_130m",):
        for reduced in (False, True):
            assert SSM.ssm_dims(configs.get_config(arch, reduced=reduced)) \
                == jssm.ssm_dims(jconfigs.get_config(arch, reduced=reduced))


# ---------------------------------------------------------------------------
# whisper: cross and bidirectional attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cross", [True, False])
def test_cross_and_bidir_attention_match_jax(cross, dtype):
    """``cross_kv`` + ``cross_attend`` (decoder queries over 16 encoder
    frames) and ``bidir_attend`` (the encoder, unmasked), through
    ``attention_core``."""
    cfg, jcfg = _cfgs("whisper_base")
    jp = split_pv_tree(jattn.init_attention(jax.random.PRNGKey(13), jcfg,
                                            cross=cross))[0]
    p = A.Attention(cfg, dtype=getattr(torch, dtype), device="cpu",
                    cross=cross)
    load_tree(p, jax.tree.map(np.asarray, jp), None, "attn")
    rng = np.random.default_rng(14)
    jx, tx = _both(rng.standard_normal((2, 9, 64)), dtype)
    je, te = _both(rng.standard_normal((2, 16, 64)), dtype)
    if cross:
        jk, jv = jattn.cross_kv(jp, jcfg, je)
        tk, tv = A.cross_kv(p, cfg, te)
        assert_close(tk, jk, dtype)
        assert_close(tv, jv, dtype)
        want = jattn.cross_attend(jp, jcfg, jx, jk, jv)
        got = A.cross_attend(p, cfg, tx, tk, tv)
    else:
        pos = np.arange(16)[None]
        want = jattn.bidir_attend(jp, jcfg, je, jnp.asarray(pos))
        got = A.bidir_attend(p, cfg, te, torch.as_tensor(pos))
    assert got.dtype == tx.dtype
    assert_close(got, want, dtype)


def test_cross_attention_has_no_bias():
    cfg, _ = _cfgs("whisper_base", qkv_bias=True)
    assert hasattr(A.Attention(cfg, device="cpu"), "bq")
    assert not hasattr(A.Attention(cfg, device="cpu", cross=True), "bq")


# ---------------------------------------------------------------------------
# activation_sharding hooks
# ---------------------------------------------------------------------------

@pytest.fixture
def hooks():
    """Both packages' hook tables, cleared after the test."""
    AS.clear()
    jas.clear()
    yield
    AS.clear()
    jas.clear()


def test_hook_table_and_api_match_jax(hooks):
    assert AS._HOOKS.keys() == jas._HOOKS.keys()
    x = torch.ones(3)
    assert not AS.enabled("inner") and AS.constrain(x, "inner") is x
    assert AS.constrain(x) is x and AS.constrain(x, "no such hook") is x
    AS.set_constraint(lambda t: t * 2, "inner")
    assert AS.enabled("inner") and not AS.enabled("block")
    torch.testing.assert_close(AS.constrain(x, "inner"), 2 * x)
    AS.set_constraint(lambda t: t + 1)          # the default name: block
    torch.testing.assert_close(AS.constrain(x), x + 1)
    AS.clear()
    assert not any(AS.enabled(n) for n in AS._HOOKS)


def _lm_pair(arch, seed=15):
    cfg, jcfg = _cfgs(arch)
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(seed))
    lm = from_jax_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, jcfg, params, lm


def _recording(table, seen, tag):
    """Install a hook under every name that records (name, shape)."""
    for name in table._HOOKS:
        if name != "embed_onehot":
            table.set_constraint(
                lambda x, n=name: (seen.add((tag, n, tuple(x.shape))), x)[1],
                name)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "qwen15_32b"])
def test_hooks_are_called_where_jax_calls_them(arch, hooks):
    """Every hook the port calls in prefill and decode has a JAX call of
    the same name and shape, and vice versa; the one exception is JAX's
    prefill "scores" [B,H,S,S], which the port's flash kernel never
    materialises."""
    cfg, jcfg, params, lm = _lm_pair(arch)
    B, S = 2, 16
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, (B, S + 1))
    seen = set()
    _recording(AS, seen, "port")
    _recording(jas, seen, "jax")
    jc = jtf.init_cache(jcfg, B, S + 1)
    tc = TF.init_cache(cfg, B, S + 1, device="cpu")
    _, jc = jtf.prefill(params, jcfg, jnp.asarray(toks[:, :S]), jc)
    TF.prefill(lm, cfg, torch.as_tensor(toks[:, :S]), tc)
    pre = set(seen)
    seen.clear()
    pos = np.full((B,), S, np.int32)
    jtf.decode_step(params, jcfg, jnp.asarray(toks[:, S]), jnp.asarray(pos),
                    jc)
    TF.decode_step(lm, cfg, torch.as_tensor(toks[:, S]),
                   torch.as_tensor(pos), tc)
    for calls, prefill in ((pre, True), (seen, False)):
        port = {c[1:] for c in calls if c[0] == "port"}
        want = {c[1:] for c in calls if c[0] == "jax"}
        if prefill:
            want = {c for c in want if c[0] != "scores"}
        assert port == want
        assert {n for n, _ in port} >= {"embed", "inner", "block", "logits"}
    assert ("scores", (B, cfg.n_heads, 1, S + 1)) in \
        {c[1:] for c in seen if c[0] == "port"}


def test_a_hook_changes_the_output_as_in_jax(hooks):
    """A hook that scales "inner" (each block's normed input) moves the
    logits of both packages alike."""
    cfg, jcfg, params, lm = _lm_pair("mamba2_130m")
    toks = np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 12))
    AS.set_constraint(lambda x: x * 0.5, "inner")
    jas.set_constraint(lambda x: x * 0.5, "inner")
    want, _ = jtf.prefill(params, jcfg, jnp.asarray(toks),
                          jtf.init_cache(jcfg, 2, 12))
    got, _ = TF.prefill(lm, cfg, torch.as_tensor(toks),
                        TF.init_cache(cfg, 2, 12, device="cpu"))
    assert_close(got, want, "bfloat16")
    AS.clear()
    plain, _ = TF.prefill(lm, cfg, torch.as_tensor(toks),
                          TF.init_cache(cfg, 2, 12, device="cpu"))
    assert float((plain.float() - got.float()).abs().max()) > 0.1


def test_embed_onehot_branch_matches_jax(hooks):
    """With "embed_onehot" set, both embed by a one-hot product: equal to
    the gather for ids in the table and a zero row for an id outside it
    (where the gather clamps or wraps)."""
    cfg, jcfg, params, lm = _lm_pair("internvl2_2b")
    ids = np.array([[0, 5, 255, 256, 10_000, -1]], np.int32)
    gather = TF.embed_tokens(lm, cfg, torch.as_tensor(ids))
    AS.set_constraint(True, "embed_onehot")
    jas.set_constraint(True, "embed_onehot")
    got = TF.embed_tokens(lm, cfg, torch.as_tensor(ids))
    want = jtf.embed_tokens(params, jcfg, jnp.asarray(ids))
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    assert torch.equal(got[0, :3], gather[0, :3])
    assert not bool(got[0, 3:].any())
