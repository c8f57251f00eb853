"""The port's training path (``repro_torch.models.transformer``'s
``forward_train``/``lm_loss``/``loss_fn``, remat, ``runtime.train_loop``)
against the JAX package's.

Weights come from the JAX ``init_lm`` (as numpy) through
``weights.from_jax_params(..., dtype=torch.float32)`` (JAX's fp32 tree,
unrounded); batches from ``SyntheticLMData`` (numpy, the same arrays on
both sides).  The JAX side runs its own ``loss_fn`` under
``jax.value_and_grad`` on ``_cast_params(params, bf16)`` and its own
jitted ``build_train_step``; nothing in ``src/repro`` changes.

Tolerances.  In fp32 (``COMPUTE_DTYPE`` switched on both sides, no bf16
copy) the two agree to fp32 rounding: losses and gradient norms within
1e-5 relative, gradients 1e-4 by relative norm, a step's parameter
update 2e-4 by relative norm.  In bf16 the two frameworks round at other
places (the serving tests hold bf16 logits within 2e-2), and a
gradient, taken through the whole bf16 model, reads up to ~2.6e-2 by
relative norm on these reduced configs: losses are held within 5e-3
relative, each gradient within 5e-2 by relative norm and all of them
together within 3e-2.  Adam's first updates are about ±lr by the sign of
each gradient element, so a few elements whose bf16 gradients are near 0
flip sign: the 3-step updates are held within 1e-1 by relative norm and
the moments within 6e-2 (the fp32 case of the same test is the tight
one).

MoE: top-k routing is a step function of the router's input, and bf16
rounding flips near-tied picks.  So the MoE archs' bf16 gradient
test holds each of the port's MoE calls on the experts JAX picked in its
matching call (``_route_on_jax_picks``); the port's gates are its own
softmax at those experts, so the router's gradient is still the port's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.data.pipeline import SyntheticLMData as JData
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.schedule import cosine_schedule as jcosine
from repro.runtime.sharding import single_device_policy as jsingle
from repro.runtime.train_loop import _cast_params as jcast
from repro.runtime.train_loop import build_train_step as jbuild
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as TF
from repro_torch.models.weights import from_jax_params, jax_ranks
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.runtime.sharding import single_device_policy
from repro_torch.runtime.train_loop import (_cast_params, _value_and_grad,
                                            build_train_step, to_device)

MOE_ARCHS = ["qwen3_moe_30b_a3b", "granite_moe_3b_a800m"]
# RecurrentGemma at 8 layers: 2 x (R, R, A), then the remainder blocks R, R
# (unstacked in JAX's tree: their 1-D leaves stay fp32, R11)
VARIANTS = {"recurrentgemma_9b:8L": ("recurrentgemma_9b", {"n_layers": 8})}
CONFIGS = jconfigs.ARCHS + list(VARIANTS)
FP32 = dict(loss=1e-5, grad=1e-4, update=2e-4, moment=1e-4)
BF16 = dict(loss=5e-3, grad=5e-2, grad_all=3e-2, update=1e-1, moment=6e-2)


def _configs(name, **kw):
    arch, extra = VARIANTS.get(name, (name, {}))
    extra = {**extra, **kw}
    return (dataclasses.replace(configs.get_config(arch, reduced=True),
                                **extra),
            dataclasses.replace(jconfigs.get_config(arch, reduced=True),
                                **extra))


def _np32(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)),
                        tree)


def _by_name(cfg, tree):
    """A JAX tree of the ``init_lm`` structure keyed by the port's
    parameter names, in fp32."""
    lm = from_jax_params(cfg, _np32(tree), device="cpu", dtype=torch.float32)
    return {n: p.detach() for n, p in lm.named_parameters()}


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _set_fp32(monkeypatch):
    monkeypatch.setattr(jtf, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TF, "COMPUTE_DTYPE", torch.float32)


def _port_grads(cfg, lm, batch, dtype):
    pb = _cast_params(dict(lm.named_parameters()), dtype,
                      jax_ranks(cfg, lm))
    loss, grads = _value_and_grad(lm, pb, lambda m, b: TF.loss_fn(m, cfg, b),
                                  to_device(batch, "cpu"))
    return loss, grads, pb


def _route_on_jax_picks(monkeypatch):
    """Hold each of the port's MoE calls on the experts JAX picked in its
    matching call (in order): JAX's ``_route`` records its picks; the
    port's takes the next record, gates by its own softmax at those
    experts and computes the aux loss with them.  Returns the list of
    the picks the port's own routing would have changed, per call."""
    picks, flips = [], []
    jroute = jmoe._route

    def recording(p, cfg, x):
        gates, experts, aux = jroute(p, cfg, x)
        jax.debug.callback(lambda e: picks.append(np.array(e)), experts,
                           ordered=True)
        return gates, experts, aux

    def on_jax_picks(p, cfg, x):
        jax.effects_barrier()
        experts = torch.as_tensor(picks.pop(0)).long()
        logits = MOE.router_logits(p, cfg, x)
        flips.append(int((MOE.route_logits(cfg, logits, x.dtype)[1]
                          != experts).sum()))
        E, k = logits.shape[-1], cfg.moe.top_k
        probs = torch.softmax(logits, dim=-1)
        gates = probs.gather(-1, experts)
        gates = gates / gates.sum(dim=-1, keepdim=True)
        count = torch.zeros(E).scatter_add_(
            0, experts.reshape(-1), torch.ones(experts.numel()))
        frac = count / (probs.numel() // E) / k
        mp = torch.mean(probs.reshape(-1, E), dim=0)
        aux = cfg.moe.n_experts * torch.sum(frac * mp)
        return gates.to(x.dtype), experts, aux

    monkeypatch.setattr(jmoe, "_route", recording)
    monkeypatch.setattr(MOE, "_route", on_jax_picks)
    return flips


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4, 1e-1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_and_its_gradient_match_jax(dtype, z_loss):
    """Ignored labels (-1, a whole row of them included), a label past the
    vocabulary (picks 0, as JAX's iota-select), z-loss: the value and the
    gradient with respect to the logits within 1e-5 (fp32 math on both
    sides; the bf16 logits are the same bf16 values)."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (3, 7)).astype(np.int32)
    labels[0, 2:5] = -1
    labels[2, :] = -1
    labels[1, 3] = 40
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    want, jg = jax.value_and_grad(
        lambda x: jtf.lm_loss(x, jnp.asarray(labels), z_loss))(jl)
    tl = torch.as_tensor(np.array(jl.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_(True)
    got = TF.lm_loss(tl, torch.as_tensor(labels).long(), z_loss)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tl.grad.float().numpy(),
                               np.asarray(jg.astype(jnp.float32)),
                               rtol=1e-5, atol=1e-5)
    # no label at all: JAX's denominator is max(0, 1)
    none = torch.full((3, 7), -1)
    assert TF.lm_loss(tl, none, z_loss).item() == 0.0


# ---------------------------------------------------------------------------
# loss_fn and every gradient, every config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", CONFIGS)
def test_loss_fn_and_gradients_match_jax(name, dtype, monkeypatch):
    """Reduced configs (remat ``none``), batch 2 x 16 of
    ``SyntheticLMData`` (whisper's frames, InternVL2's prepended patches):
    the loss, its ``ce``/``aux`` metrics, and the gradient of every
    parameter on the compute copy (bf16 for JAX-rank >= 2 fp32 leaves)
    against ``jax.value_and_grad`` of JAX's ``loss_fn`` on
    ``_cast_params(params, bf16)``; in fp32 both sides compute in fp32."""
    cfg, jcfg = _configs(name)
    fp32 = dtype == "float32"
    if fp32:
        _set_fp32(monkeypatch)
    elif cfg.moe.n_experts:
        flips = _route_on_jax_picks(monkeypatch)
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(3))
    batch = JData(jcfg, 2, 16, seed=4).batch_at(0)
    gdt = jnp.float32 if fp32 else jnp.bfloat16
    (want, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, jcfg, b), has_aux=True))(
            jcast(params, gdt), batch)
    lm = from_jax_params(cfg, _np32(params), device="cpu",
                         dtype=torch.float32)
    loss, grads, pb = _port_grads(cfg, lm, batch,
                                  torch.float32 if fp32 else torch.bfloat16)
    tol = FP32 if fp32 else BF16
    np.testing.assert_allclose(float(loss), float(want), rtol=tol["loss"])
    want_g = _by_name(cfg, jg)
    assert grads.keys() == want_g.keys()
    errs = {n: _rel(grads[n], g) for n, g in want_g.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol["grad"], (worst, errs[worst])
    for n, g in grads.items():      # the gradient has the copy's dtype
        assert g.dtype == pb[n].dtype and g.shape == pb[n].shape
    if not fp32:
        cat = lambda d: torch.cat([d[n].float().flatten() for n in want_g])
        assert _rel(cat(grads), cat(want_g)) <= tol["grad_all"]
        if cfg.moe.n_experts:       # every MoE call was held on JAX's picks
            assert len(flips) == cfg.n_layers


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_aux_loss_reaches_the_loss_like_jax(arch, monkeypatch):
    """With fp32 compute on both sides (so both route alike), the MoE
    load-balance loss summed over the layers equals JAX's within 1e-6
    relative, and loss = ce + ``aux_loss_weight`` · aux (the serving path
    drops it)."""
    _set_fp32(monkeypatch)
    cfg, jcfg = _configs(arch)
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(5))
    batch = JData(jcfg, 2, 16, seed=6).batch_at(0)
    want, jm = jtf.loss_fn(params, jcfg, batch)
    lm = from_jax_params(cfg, _np32(params), device="cpu",
                         dtype=torch.float32)
    with torch.no_grad():
        got, tm = TF.loss_fn(lm, cfg, to_device(batch, "cpu"))
    assert float(tm["aux"]) > 0
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-6)
    with torch.no_grad():
        logits, aux = TF.forward_train(lm, cfg, torch.as_tensor(
            batch["tokens"]).long())
        ce = TF.lm_loss(logits, torch.as_tensor(batch["labels"]).long())
    assert torch.equal(aux, tm["aux"])
    np.testing.assert_allclose(
        float(got), float(ce + cfg.moe.aux_loss_weight * aux), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_compute_copy_dtypes_follow_jax_rank(name):
    """R11: the compute copy casts exactly the leaves JAX's
    ``_cast_params`` casts (fp32 leaves of rank >= 2 in JAX's stacked
    tree): stacked norms, biases and gates go to bf16, ``final_norm`` and
    the remainder blocks' 1-D leaves stay fp32; the decay rank is the same
    record."""
    cfg, jcfg = _configs(name)
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(0))
    cast = jax.tree.map(lambda x: x.dtype == jnp.bfloat16,
                        jcast(params, jnp.bfloat16))
    want = _by_name(cfg, _ones_where(params, cast))
    lm = TF.init_lm(cfg, 0, device="cpu", dtype=torch.float32)
    ranks = jax_ranks(cfg, lm)
    pb = _cast_params(dict(lm.named_parameters()), torch.bfloat16, ranks)
    for n, x in pb.items():
        assert (x.dtype == torch.bfloat16) == bool(want[n].flatten()[0]), n
        assert x.requires_grad
    assert ranks["final_norm.w"] == 1 and pb["final_norm.w"].dtype == \
        torch.float32
    assert ranks["layers.0.norm1.w"] == 2
    if name in VARIANTS:            # the remainder blocks, layers 6 and 7
        assert ranks["layers.6.rglru.lam"] == 1
        assert pb["layers.7.norm1.w"].dtype == torch.float32
        assert pb["layers.0.rglru.lam"].dtype == torch.bfloat16


def _ones_where(params, flags):
    """A tree like ``params`` whose leaves are all 1.0 where ``flags`` is
    true, else 0.0 (so it loads through ``from_jax_params``)."""
    return jax.tree.map(lambda x, f: np.full(x.shape, float(f), np.float32),
                        params, flags)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["minicpm_2b", "qwen3_moe_30b_a3b",
                                  "recurrentgemma_9b:8L", "mamba2_130m",
                                  "whisper_base"])
def test_remat_modes_are_bit_equal(name):
    """``remat`` none, dots and full give the same loss and gradients bit
    for bit on the CPU.  What each recomputes, by op counts over the
    whole step: "dots" runs no projection (``aten.mm``) twice but every
    batched product (``aten.bmm``) of the superblocks again; "full" runs
    both again."""
    out = {}
    for remat in ("none", "dots", "full"):
        cfg, _ = _configs(name, remat=remat)
        lm = TF.init_lm(cfg, 0, device="cpu", dtype=torch.float32)
        batch = SyntheticLMData(cfg, 2, 16, seed=1).batch_at(0)
        with _CountOps() as ops:
            loss, grads, _ = _port_grads(cfg, lm, batch, torch.bfloat16)
        out[remat] = (loss, grads, ops.counts)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    loss, grads, base = out["none"]
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], loss)
        for n, g in grads.items():
            assert torch.equal(out[remat][1][n], g), (remat, n)
    dots, full = out["dots"][2], out["full"][2]
    assert dots.get(mm, 0) == base.get(mm, 0)
    assert full.get(mm, 0) > base.get(mm, 0)
    if base.get(bmm, 0):
        assert dots.get(bmm, 0) > base[bmm] and full.get(bmm, 0) > base[bmm]


# ---------------------------------------------------------------------------
# the recurrent scans under autograd
# ---------------------------------------------------------------------------

def _linear_scan_in_place(a, b):
    """The serving scan as it was before it was written out of place (in
    place rounds; autograd cannot run through it)."""
    a, b = a.clone(), b.clone()
    S, d = a.shape[1], 1
    while d < S:
        b_tail = torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])
        if 2 * d < S:
            a[:, d:] = a[:, d:] * a[:, :-d]
        b[:, d:] = b_tail
        d *= 2
    return b


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_linear_scan_grad_matches_the_sequential_recurrence(S):
    """The RG-LRU scan's gradients (w.r.t. a and b, under a random
    cotangent) against autograd through h_t = a_t h_{t-1} + b_t step by
    step, in fp64 within 1e-10; and the scan's values bit-equal to the
    in-place scan the serving path ran before (serving unchanged)."""
    rng = np.random.default_rng(S)
    a0 = torch.as_tensor(rng.uniform(0.5, 1.0, (2, S, 6)))
    b0 = torch.as_tensor(rng.standard_normal((2, S, 6)))
    ct = torch.as_tensor(rng.standard_normal((2, S, 6)))

    def grads(fn):
        a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
        (fn(a, b) * ct).sum().backward()
        # at S = 1 the scan is b itself: a gets no gradient (zero)
        return [torch.zeros_like(t) if t.grad is None else t.grad
                for t in (a, b)]

    def sequential(a, b):
        h, hs = torch.zeros_like(b[:, 0]), []
        for t in range(a.shape[1]):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        return torch.stack(hs, dim=1)

    for got, want in zip(grads(RG.linear_scan), grads(sequential)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-10)
    a32, b32 = a0.float(), b0.float()
    assert torch.equal(RG.linear_scan(a32, b32),
                       _linear_scan_in_place(a32, b32))


@pytest.mark.parametrize("S", [5, 32, 37])
def test_ssd_chunked_grad_matches_the_recurrent_step(S):
    """``ssd_chunked``'s gradients (x, dt, B, C) against autograd through
    ``ssd_decode_step`` token by token, in fp64 within 1e-9 (chunk 8: one
    chunk, several, and zero-dt padding)."""
    rng = np.random.default_rng(S)
    Bsz, H, P, N = 2, 3, 4, 5
    x0 = torch.as_tensor(rng.standard_normal((Bsz, S, H, P)))
    dt0 = torch.as_tensor(rng.uniform(0.01, 0.5, (Bsz, S, H)))
    A = -torch.as_tensor(rng.uniform(0.5, 2.0, H))
    Bm0 = torch.as_tensor(rng.standard_normal((Bsz, S, N)))
    Cm0 = torch.as_tensor(rng.standard_normal((Bsz, S, N)))
    D = torch.as_tensor(rng.standard_normal(H))
    ct = torch.as_tensor(rng.standard_normal((Bsz, S, H, P)))

    def grads(fn):
        xs = [t.clone().requires_grad_() for t in (x0, dt0, Bm0, Cm0)]
        (fn(*xs) * ct).sum().backward()
        return [t.grad for t in xs]

    def chunked(x, dt, Bm, Cm):
        return SSM.ssd_chunked(x, dt, A, Bm, Cm, D, 8)[0]

    def stepwise(x, dt, Bm, Cm):
        h, ys = torch.zeros((Bsz, H, P, N), dtype=x.dtype), []
        for t in range(S):
            y, h = SSM.ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t],
                                       Cm[:, t], D, h)
            ys.append(y)
        return torch.stack(ys, dim=1)

    for got, want in zip(grads(chunked), grads(stepwise)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", ["minicpm_2b", "mamba2_130m"])
def test_train_step_matches_jax(arch, M, dtype, monkeypatch):
    """``build_train_step`` against JAX's jitted step from the same fp32
    weights and a zero AdamW state, on the same 4 x 16 batches, with
    ``cosine_schedule(3e-3, 1, 10)``: step 0 (lr 0) fills m and v, so the
    3 updating steps 1..3 are not Adam's sign-like first update (a near-
    zero gradient element whose sign flips by rounding moves by ±lr even
    in fp32).  Each step: its loss, grad norm and lr, every parameter's
    update since step 0, and m and v (both by relative norm).  In fp32 (no bf16 copy:
    ``grad_compress_dtype=None`` on both sides) to fp32 rounding."""
    fp32 = dtype == "float32"
    if fp32:
        _set_fp32(monkeypatch)
    gc = None if fp32 else "bfloat16"
    tol = FP32 if fp32 else BF16
    cfg, jcfg = _configs(arch)
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(0))
    lm = from_jax_params(cfg, _np32(params), device="cpu",
                         dtype=torch.float32)
    p0 = {n: p.detach().clone() for n, p in lm.named_parameters()}
    jstep = jax.jit(jbuild(jcfg, jsingle(microbatches=M,
                                         grad_compress_dtype=gc),
                           jcosine(3e-3, 1, 10)))
    tstep = build_train_step(cfg, single_device_policy(
        microbatches=M, grad_compress_dtype=gc), cosine_schedule(3e-3, 1, 10))
    jo, to = jadamw_init(params), adamw_init(dict(lm.named_parameters()))
    data = JData(jcfg, 4, 16, seed=2)
    for step in range(4):
        batch = data.batch_at(step)
        params, jo, jm = jstep(params, jo, batch, jnp.asarray(step,
                                                              jnp.int32))
        lm, to, tm = tstep(lm, to, batch, step)
        assert int(to.step) == int(jo.step) == step + 1
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=tol["loss"])
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        want_p = _by_name(cfg, params)
        for n, p in lm.named_parameters():
            assert _rel(p.detach() - p0[n], want_p[n] - p0[n]) <= \
                tol["update"], n
        for mine, theirs in ((to.m, jo.m), (to.v, jo.v)):
            want = _by_name(cfg, theirs)
            for n, x in mine.items():
                assert _rel(x, want[n]) <= tol["moment"], n
