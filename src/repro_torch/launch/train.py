"""End-to-end training entry point, as the JAX package's
``repro.launch.train``: the config registry, the synthetic data pipeline,
the train step, the WSD/cosine schedules and the checkpoint manager with
auto-resume and preemption handling.  It runs on ``cuda`` unless ``--device cpu``.

The initial weights come from a seeded ``torch.Generator`` (seed 0):
JAX's ``PRNGKey(0)`` init is not reproducible in torch, so a run starts
from other weights than the JAX script's (the CPU tests start both from
weights carried across instead).

``--mesh host`` is a test hook, not a feature (the JAX script has no such
flag): it trains through the mesh path on ``launch/mesh.make_host_mesh``
(one device; a world-size-1 process group is made if none is): the state
and the batches are DTensors placed by the default policy's
``tree_shardings`` of ``logical_specs``, the step takes
``grad_shardings``, and a checkpoint is restored onto those shardings.
It is how one card runs the sharded step at full size.  The default,
``--mesh none``, is the single-device path.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm_2b \\
      --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import resolve
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule
from repro_torch.runtime.sharding import (default_policy,
                                          single_device_policy)
from repro_torch.runtime.train_loop import (build_train_step,
                                            distribute_state,
                                            init_train_state, to_device)


def schedule(cfg, lr: float, steps: int, name: str = "cosine"):
    """The schedule ``main`` trains with: WSD if asked or if the config has
    ``scale_depth`` (MiniCPM trains with WSD per its paper), else
    cosine."""
    if name == "wsd" or cfg.scale_depth:
        return wsd_schedule(lr, steps // 10, steps // 2, steps // 2)
    return cosine_schedule(lr, steps // 10, steps)


def host_mesh(dev):
    """The one-device mesh, with a world-size-1 process group (nccl on
    the card, gloo on the CPU) made if there is none."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_host_mesh(dev.type)


def on_mesh(cfg, mesh, microbatches, lm, opt):
    """The mesh path's pieces: (policy, the parameters' placements, the
    optimizer state on ``mesh``, a batch → DTensors function), with
    ``lm``'s parameters placed on ``mesh`` in place."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.transformer import logical_specs

    pol = default_policy(mesh, microbatches=microbatches)
    specs = logical_specs(cfg)
    psh = pol.tree_shardings(mesh, specs, dict(lm.named_parameters()))
    lm, opt = distribute_state(lm, opt, mesh, psh)

    def place(batch):
        return {k: distribute_tensor(x, mesh, pol.shard(
            mesh, ("dp",) + (None,) * (x.ndim - 1), x.shape))
            for k, x in to_device(batch, mesh.device_type).items()}
    return pol, psh, opt, place


def main(argv=None, on_step=None):
    """Parses ``argv``, trains, and returns the losses of the steps run.
    ``on_step(step, lm, opt_state, metrics)``, if given, is called after
    each step (a caller's hook, e.g. to time the steps or keep the
    state)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--mesh", default="none", choices=["none", "host"],
                    help="host: train through the mesh path on a "
                    "one-device mesh (a test hook; module docstring)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    sched = schedule(cfg, args.lr, args.steps, args.schedule)
    data = SyntheticLMData(cfg, args.batch, args.seq)
    lm, opt = init_train_state(cfg, 0, device=dev)
    shardings = None
    place = None
    if args.mesh == "host":
        pol, psh, opt, place = on_mesh(cfg, host_mesh(dev),
                                       args.microbatches, lm, opt)
        # the moments on their parameters' placements, the step as it is
        shardings = {"params": psh, "opt": AdamWState(
            step=opt.step.placements, m=psh, v=psh)}
        step_fn = build_train_step(cfg, pol, sched, grad_shardings=psh)
    else:
        pol = single_device_policy(microbatches=args.microbatches)
        step_fn = build_train_step(cfg, pol, sched)

    mgr = None
    start = 0
    state = {"params": dict(lm.named_parameters()), "opt": opt}
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        mgr.install_preemption_handler()
        # restores in place, into the LM's parameters (on the mesh, onto
        # their shardings)
        state, start = mgr.restore_or_init(lambda: state,
                                           shardings=shardings)

    opt = state["opt"]
    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = data.batch_at(step)
        if place is not None:
            batch = place(batch)
        lm, opt, metrics = step_fn(lm, opt, batch, step)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step, lm, opt, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{tok_s:,.0f} tok/s", flush=True)
        if mgr is not None:
            mgr.maybe_save(step, {"params": state["params"], "opt": opt})
            if mgr.preempted:
                print("preempted: checkpoint flushed, exiting cleanly")
                break
    if mgr is not None:
        mgr.maybe_save(args.steps - 1, {"params": state["params"],
                                        "opt": opt}, force=True)
        mgr.finalize()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
