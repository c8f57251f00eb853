"""Checkpoint policy: periodic saves, keep-N, auto-resume, preemption
flush, as the JAX package's ``repro.checkpoint.manager``.

The training loop calls ``maybe_save(step, state)`` every step;
``restore_or_init`` picks up the newest committed checkpoint.  As in the
JAX package, it returns that checkpoint's step as the step to start
from, although the state saved under a step is the state *after* it, so
a resumed loop applies that step again (ROADMAP R12).
"""
from __future__ import annotations

import signal
from typing import Any, Callable

from repro_torch.checkpoint.checkpointer import Checkpointer


class CheckpointManager:
    def __init__(self, root: str, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.ckpt = Checkpointer(root, async_save=async_save)
        self.every = every
        self.keep = keep
        self._preempted = False

    def install_preemption_handler(self):
        """SIGTERM (the preemption signal of cloud fleets) sets a flag; the
        loop checkpoints and exits cleanly at the next step edge."""
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    @property
    def preempted(self) -> bool:
        return self._preempted

    def maybe_save(self, step: int, tree: Any, specs: Any = None,
                   force: bool = False) -> bool:
        if force or self._preempted or (self.every and step % self.every == 0
                                        and step > 0):
            self.ckpt.save(step, tree, specs=specs)
            self.ckpt.gc(self.keep)
            return True
        return False

    def restore_or_init(self, init_fn: Callable[[], Any],
                        shardings: Any = None):
        """→ (state, start_step). Resumes from the latest commit if any,
        placed on ``shardings`` (``Checkpointer.restore``) if given."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return init_fn(), 0
        like = init_fn()
        state = self.ckpt.restore(latest, like, shardings=shardings)
        return state, latest

    def finalize(self):
        self.ckpt.wait()
