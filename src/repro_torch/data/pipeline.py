"""Deterministic sharded synthetic token pipeline with host-side prefetch
(the port's own copy of the JAX package's numpy code: ``batch_at`` gives
the same arrays bit for bit; the train step moves them to the card).

Production posture: each host generates only its shard of the global batch
(`host_batch = global_batch // n_hosts`), keyed by (seed, step, host) so a
restarted/elastically-resized job regenerates identical data for any step —
data determinism is what makes checkpoint-resume exact. A background thread
keeps `prefetch` batches ready so the accelerator never waits on the host.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticLMData:
    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0,
                 prefetch: int = 2):
        assert global_batch % n_hosts == 0
        self.cfg = cfg
        self.global_batch = global_batch
        self.host_batch = global_batch // n_hosts
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()

    # -- deterministic batch synthesis ---------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        # zipf-ish marginal over the vocab: realistic softmax pressure
        z = rng.zipf(1.3, size=(self.host_batch, self.seq_len + 1))
        tokens = (z % self.cfg.vocab_size).astype(np.int32)
        batch = {"tokens": tokens[:, :-1],
                 "labels": tokens[:, 1:].copy()}
        if self.cfg.frontend == "vit_stub":
            batch["patches"] = rng.standard_normal(
                (self.host_batch, self.cfg.n_frontend_tokens,
                 self.cfg.d_model), dtype=np.float32)
        if self.cfg.frontend == "audio_stub":
            batch["frames"] = rng.standard_normal(
                (self.host_batch, self.cfg.n_enc_ctx, self.cfg.d_model),
                dtype=np.float32)
        return batch

    # -- prefetching iterator -------------------------------------------------
    def iterator(self, start_step: int = 0) -> Iterator[Dict]:
        self._q = queue.Queue(maxsize=self.prefetch)
        self._stop.clear()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self._stop.set()

    def stop(self):
        self._stop.set()
