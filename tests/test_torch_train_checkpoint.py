"""The port's training checkpoints (``repro_torch.checkpoint``) and its
training script (``repro_torch.launch.train``): the tests of
``tests/test_checkpoint_ft.py`` and ``test_system.py``'s training leg on
the port, and the script against the JAX package's from the same weights.

R12 (ROADMAP): the state saved under step s is the state after step s,
and ``restore_or_init`` returns s as the step to start from, so a resumed
run applies step s (with its batch) a second time.  The port mirrors
it, and ``test_resume_reapplies_the_latest_step_like_jax`` shows it on
both sides.
"""
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch import train
from repro_torch.models import transformer as TF
from repro_torch.models.weights import from_jax_params, jax_ranks
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.train_loop import (_cast_params, init_train_state,
                                            to_device)

TRAIN_ARGS = ["--arch", "mamba2_130m", "--reduced", "--steps", "20",
              "--batch", "4", "--seq", "32", "--ckpt-every", "10",
              "--log-every", "50"]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 8), generator=g),
            "opt": {"m": torch.zeros((8, 8)),
                    "step": torch.tensor(3, dtype=torch.int32)},
            "h": torch.randn(5, generator=g).to(torch.bfloat16)}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------------
# tests/test_checkpoint_ft.py, on the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """Every leaf back bit for bit (fp32, int32, bf16 through its 16-bit
    patterns) in the ``like`` tree's dtypes; the manifest names them."""
    ck = Checkpointer(str(tmp_path), async_save=False)
    t = _tree()
    ck.save(7, t)
    assert ck.latest_step() == 7
    like = _zeros_like(t)
    r = ck.restore(7, like)
    assert r is like
    for a, b in zip(_leaves(t), _leaves(r)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    assert keys["h"] == {"shape": [5], "dtype": "bfloat16"}
    assert keys["opt/step"] == {"shape": [], "dtype": "int32"}


def test_checkpoint_atomicity_no_tmp_visible(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _tree())
    ck.save(2, _tree(1))
    names = os.listdir(tmp_path)
    assert not any(n.endswith(".tmp") for n in names)
    assert ck.latest_step() == 2


def test_manager_keep_n_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2,
                            async_save=False)
    t = _tree()
    for step in range(1, 6):
        mgr.maybe_save(step, {"w": t["w"] + step})
    mgr.finalize()
    state, start = mgr.restore_or_init(lambda: {"w": torch.zeros(8, 8)})
    assert start == 5
    assert torch.equal(state["w"], t["w"] + 5)
    # keep=2 garbage collection
    kept = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(kept) <= 2


def test_async_save_snapshots_before_returning(tmp_path):
    """``save`` copies to the host before it returns: writing the tensors
    in place afterwards (the next train step) does not reach the file.
    A crash's leftover ``.tmp`` is collected by the next save."""
    os.makedirs(tmp_path / "step_00000001.tmp")
    mgr = CheckpointManager(str(tmp_path), every=2, keep=3)
    w = torch.arange(6.0)
    assert not mgr.maybe_save(1, {"w": w})
    assert mgr.maybe_save(2, {"w": w})
    w.add_(100.0)
    mgr.finalize()
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    r = mgr.ckpt.restore(2, {"w": torch.zeros(6)})
    assert torch.equal(r["w"], torch.arange(6.0))


def test_restore_into_a_fresh_training_state_is_bit_equal(tmp_path):
    """A training state (fp32 LM masters, an AdamW state with a bf16
    option) saved after a step and restored into a freshly built one:
    every tensor bit-equal, in the fresh state's own tensors; a leaf of
    another shape raises."""
    cfg = configs.get_config("minicpm_2b", reduced=True)
    lm, opt = init_train_state(cfg, 1, device="cpu")
    opt = adamw_init(dict(lm.named_parameters()), dtype=torch.bfloat16)
    with torch.no_grad():
        for p, m in zip(lm.parameters(), opt.m.values()):
            p.add_(0.5)
            m.add_(torch.randn(m.shape).to(m.dtype))
    state = {"params": dict(lm.named_parameters()),
             "opt": opt._replace(step=opt.step + 4)}
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(4, state)
    ck.wait()
    fresh_lm, fresh_opt = init_train_state(cfg, 2, device="cpu")
    fresh_opt = adamw_init(dict(fresh_lm.named_parameters()),
                           dtype=torch.bfloat16)
    fresh = {"params": dict(fresh_lm.named_parameters()), "opt": fresh_opt}
    ck.restore(4, fresh)
    assert int(fresh_opt.step) == 4
    for n, p in fresh_lm.named_parameters():
        assert torch.equal(p, state["params"][n])
    for mine, saved in ((fresh_opt.m, opt.m), (fresh_opt.v, opt.v)):
        for n, x in mine.items():
            assert x.dtype == torch.bfloat16 and torch.equal(x, saved[n])
    bad = {"params": {"embed": torch.zeros(3)}, "opt": fresh_opt}
    with pytest.raises(ValueError, match="embed"):
        ck.restore(4, bad)


# ---------------------------------------------------------------------------
# test_system.py's training leg, and the script against JAX's
# ---------------------------------------------------------------------------

def test_training_loss_falls_and_resume(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch mamba2_130m --reduced
    --device cpu``: 20 steps, the loss falls, checkpoints at steps 10 and
    19 (the forced final save); the second call resumes from step 19."""
    args = TRAIN_ARGS + ["--ckpt-dir", str(tmp_path), "--device", "cpu"]
    losses = train.main(args)
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert sorted(os.listdir(tmp_path)) == ["step_00000010",
                                            "step_00000019"]
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "step    19  loss" in out
    losses2 = train.main(args)
    assert losses2 is not None and len(losses2) == 1


def test_training_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(TRAIN_ARGS)


def test_resume_reapplies_the_latest_step_like_jax(tmp_path, monkeypatch):
    """The port's script and JAX's from the same weights (JAX's
    ``init_lm(PRNGKey(0))`` carried across in fp32, since a torch
    generator cannot draw JAX's; JAX's saves synchronous, R13): the 20
    losses within 5e-3 relative
    (bf16 compute; both run the same data, schedule and steps), then the
    resumed runs' single losses within 5e-3 of each other.  R12: that
    loss is step 19's batch applied again to the state saved after step
    19 (the port's equals ``loss_fn`` there)."""
    jcfg = jconfigs.get_config("mamba2_130m", reduced=True)
    cfg = configs.get_config("mamba2_130m", reduced=True)
    params, _ = jtf.init_lm(jcfg, jax.random.PRNGKey(0))
    np32 = jax.tree.map(lambda x: np.asarray(x, np.float32), params)

    def carried(cfg_, seed, device=None):
        lm = from_jax_params(cfg_, np32, device=device, dtype=torch.float32)
        return lm, adamw_init(dict(lm.named_parameters()))

    monkeypatch.setattr(train, "init_train_state", carried)
    # the JAX manager's gc deletes the .tmp of its own save in flight
    # (R13), so its checkpoints are written synchronously here
    monkeypatch.setattr(jtrain, "CheckpointManager", functools.partial(
        JCheckpointManager, async_save=False))
    mine_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    mine = train.main(TRAIN_ARGS + ["--ckpt-dir", str(mine_dir), "--device",
                                    "cpu"])
    theirs = jtrain.main(TRAIN_ARGS + ["--ckpt-dir", str(jax_dir)])
    np.testing.assert_allclose(mine, theirs, rtol=5e-3)
    # the state saved after step 19 (step 20 of AdamW), and step 19's
    # batch on it: what the resumed run will compute; the first run's
    # step 19 saw the state after step 18
    lm, opt = carried(cfg, 0, "cpu")
    Checkpointer(str(mine_dir)).restore(
        19, {"params": dict(lm.named_parameters()), "opt": opt})
    assert int(opt.step) == 20
    batch = SyntheticLMData(cfg, 4, 32).batch_at(19)
    pb = _cast_params(dict(lm.named_parameters()), torch.bfloat16,
                      jax_ranks(cfg, lm))
    with torch.no_grad():
        again, _ = torch.func.functional_call(
            lm, pb, (lambda m, b: TF.loss_fn(m, cfg, b),
                     to_device(batch, "cpu")))
    mine2 = train.main(TRAIN_ARGS + ["--ckpt-dir", str(mine_dir), "--device",
                                     "cpu"])
    theirs2 = jtrain.main(TRAIN_ARGS + ["--ckpt-dir", str(jax_dir)])
    assert len(mine2) == len(theirs2) == 1
    np.testing.assert_allclose(mine2, theirs2, rtol=5e-3)
    assert float(again) == mine2[0] != mine[19]
