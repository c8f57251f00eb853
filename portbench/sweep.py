"""The system under test, driven as a researcher drives a sweep.

A fleet of harts (``repro_torch.core.hext.sim.Fleet``, on the graph
engine on the card) runs a backlog of jobs.  Between two chunks of
``poll_ticks`` ticks the sweep reads the fleet's counters
(``Fleet.counters``), checks the exit code of every job that finished
against its kind's golden where the kind has one, and splices the next
job of the backlog into each freed lane (``Fleet.replace_hart``), so no
new graph is captured.

The sweep keeps its own books, never the program's: the kind and the
age (ticks since it was spliced in) of each lane's job, the instructions
retired, and the spans of its calls into the fleet.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hext.sim import Fleet, HartState
from portbench import traffic

# leaves of a hart's state, as the fleet holds them
STATE_LEAVES = ("pc", "regs", "csrs", "priv", "virt", "mem", "halted",
                "console")
COUNTER_LEAVES = ("done", "exit_code", "instret", "instret_virt",
                  "exc_by_level", "int_by_level", "pagefaults", "walks",
                  "ticks", "timer_irqs", "ctx_switches")


class Sweep:
    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any],
                 seed: int, device: torch.device):
        self.device = torch.device(device)
        self.poll = int(mix["poll_ticks"])
        self.mem_words = int(config["mem_words"])
        self.phases: Dict[str, float] = {}
        t0 = time.perf_counter()
        mod = traffic.module(mix)
        kinds = mod.kinds(mix, config)
        self.images = {k: traffic.image(mod, k, config) for k in kinds}
        self.goldens = {k: mod.golden(k) for k in kinds}
        first, self.backlog = traffic.plan(kinds, int(config["harts"]),
                                           seed)
        self.kind: List[str] = first
        self.age = np.zeros(len(first), dtype=np.int64)
        t1 = time.perf_counter()
        self.fleet = Fleet.from_images([self.images[k] for k in first],
                                       mem_words=self.mem_words,
                                       device=self.device)
        self._sync()
        t2 = time.perf_counter()
        self.phases.update(images=t1 - t0, boot=t2 - t1)
        # a tick's host seconds, from the last full chunk
        self._tick_s: Optional[float] = None
        self._jobs: Dict[str, HartState] = {}
        self._instret = np.zeros(len(first), dtype=np.int64)
        self.retired = 0          # instructions retired in the window
        self.refills = 0          # jobs finished and refilled in it
        self.harvest: List[Tuple[str, int, Dict[str, Any]]] = []
        self.bad_exit = 0         # finished jobs whose exit code is wrong
        self.spans: List[Tuple[str, float]] = []
        self.run_ticks: List[int] = []   # the ticks of each "run" span

    @property
    def harts(self) -> int:
        return len(self.kind)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _job(self, kind: str) -> HartState:
        """A freshly booted hart for ``kind`` (built once a kind)."""
        if kind not in self._jobs:
            self._jobs[kind] = HartState.fresh(
                self.mem_words, batch=1, device=self.device).or_image(
                    self.images[kind])
        return self._jobs[kind]

    # -- the two calls a round makes into the fleet -------------------------
    def run(self, ticks: Optional[int] = None) -> None:
        """Advance every lane by ``ticks`` (default ``poll_ticks``) and
        wait for the card."""
        t = self.poll if ticks is None else int(ticks)
        t0 = time.perf_counter()
        self.fleet.run(t, chunk=t)
        self._sync()
        dt = time.perf_counter() - t0
        self.spans.append(("run", dt))
        self.run_ticks.append(t)
        if t == self.poll:
            self._tick_s = dt / t
        self.age += t

    def control(self) -> int:
        """Harvest and refill: read the counters, check each finished
        job's exit code against its kind's golden, if it has one, and
        splice the next job into its lane.  Returns the number of jobs
        that finished."""
        t0 = time.perf_counter()
        cs = self.fleet.counters()
        now = np.fromiter((int(c.instret) for c in cs), np.int64, len(cs))
        self.retired += int((now - self._instret).sum())
        finished = 0
        for i, c in enumerate(cs):
            if not bool(c.done):
                continue
            kind = self.kind[i]
            counters = c.to_dict()
            gold = self.goldens[kind]
            if gold is not None:
                self.bad_exit += counters["exit_code"] != gold
            self.harvest.append((kind, int(self.age[i]), counters))
            nxt = next(self.backlog)
            self.fleet.replace_hart(i, self._job(nxt))
            self.kind[i], self.age[i], now[i] = nxt, 0, 0
            finished += 1
        self._instret = now
        self._sync()
        self.spans.append(("control", time.perf_counter() - t0))
        return finished

    # -- phases -------------------------------------------------------------
    def warm(self) -> None:
        """Capture the graph and run one tick and one control round, so
        the window builds nothing: the graph holds one tick, and a chunk
        replays it.  Lane 0 is spliced with a fresh boot of its own job
        first, which leaves its state as it was and warms
        ``replace_hart``."""
        t0 = time.perf_counter()
        self.fleet.replace_hart(0, self._job(self.kind[0]))
        self.run(1)
        capture = getattr(self.fleet.engine, "last_capture_s", 0.0)
        t1 = time.perf_counter()
        self.control()
        self.phases.update(capture=capture, warm_tick=t1 - t0 - capture,
                           warm_control=time.perf_counter() - t1)

    def window(self, seconds: float,
               max_rounds: Optional[int] = None) -> Tuple[float, int]:
        """Rounds of (chunk, control) until ``seconds`` have passed (or
        ``max_rounds`` are done).  The last chunk is cut to the ticks that
        the time left holds at the last full chunk's pace, so the window
        ends near ``seconds`` and not up to a chunk later.  Returns
        (seconds, ticks)."""
        self.retired, self.spans, self.run_ticks = 0, [], []
        jobs = len(self.harvest)
        t0 = time.perf_counter()
        rounds = ticks = 0
        while True:
            t = self.poll
            if max_rounds is None and self._tick_s is not None:
                left = seconds - (time.perf_counter() - t0)
                t = max(1, min(t, math.ceil(left / self._tick_s)))
            self.run(t)
            self.control()
            rounds += 1
            ticks += t
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds or rounds == max_rounds:
                self.refills = len(self.harvest) - jobs
                return elapsed, ticks

    def state(self) -> Dict[str, Any]:
        """Every leaf of the fleet's state on the host (numpy, int64 bit
        patterns and bools, leading hart dimension)."""
        h = self.fleet.harts.unwrap()
        out = {k: getattr(h, k).cpu().numpy() for k in STATE_LEAVES}
        out.update({k: getattr(h.counters, k).cpu().numpy()
                    for k in COUNTER_LEAVES})
        out["tlb"] = {k: v.cpu().numpy() for k, v in h.tlb.items()}
        return out
