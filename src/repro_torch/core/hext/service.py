"""Fleet-as-a-service: the hypervisor control plane (DESIGN.md §8) — the
port of ``repro.core.hext.service`` on the port's ``Fleet``.

:class:`FleetService` is a persistent daemon over two fixed-shape
:class:`~repro_torch.core.hext.sim.Fleet` pools — a *pod* pool of
preemptive N-guest scheduler harts and an optional *solo* pool for
native/guest single-tenant runs, both on ``device`` (default ``cuda``).
Tenants submit workloads into a queue; a pluggable
:class:`~repro_torch.core.hext.policies.PlacementPolicy` admits and bin-packs
them onto harts; the service then drives the fleet in timeslice-sized
engine runs, interleaving one control round per slice:

    harvest → detect/recover failures → resume parked → shed → evict
            → place → snapshot → run one slice

* **harvest** reads per-guest done flags and checksum mailboxes straight
  from hart memory — the few words it needs, gathered on the device and
  read in one host copy per pool, reused until the pool's state changes
  — and retires finished jobs (a finished hart's lane returns to the
  vacant pool);
* **recover** watches per-lane ``instret`` progress — a lane that stops
  retiring instructions for ``fail_after`` rounds is declared dead and
  restored from its last healthy per-lane snapshot (suspect lanes are
  never snapshotted, so the last file always predates the failure), with
  zero lost completed work: harvested jobs stay done, un-harvested guests
  replay from the snapshot and reach the same checksums;
* **resume** splices parked guests (``Fleet.resume_guest``) into free
  same-slot lanes; **shed** rebalances hot harts via
  ``Fleet.migrate_guest``; **evict** parks a victim guest as a per-guest
  checkpoint (``Fleet.park_guest``) when the queue is starved of lanes;
* **place** boots policy-chosen cohorts onto vacant lanes — lanes keep
  the pool's shapes (``Fleet.replace_hart``), and each pool keeps one
  engine for its lifetime, so on the card the control plane reuses the
  pool's captured CUDA graph and never captures another after warmup.

Lanes never host mid-flight *new* arrivals: cohorts are formed at
provision time only (the HS scheduler initializes contexts at boot), so
a guest served through the daemon runs under exactly the same scheduler
dynamics as a direct ``Fleet.boot`` — checksums always match the
registry goldens, and whole-cohort lanes match counters bit-identically.

The progress monitor doubles as straggler accounting: ``stragglers()``
reports lanes currently behind.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hext import checkpoint as _checkpoint
from repro_torch.core.hext import programs as _programs
from repro_torch.core.hext.policies import (BinPackPolicy, JobView,
                                            LaneView, PlacementPolicy,
                                            size_bucket, workload_footprint)
from repro_torch.core.hext.sim import (Fleet, HartSpec, HartState, MASK64,
                                       MigrationError, checksum_ok)
from repro_torch.device import resolve

__all__ = ["FleetService", "Job", "ServiceError",
           "QUEUED", "RUNNING", "PARKED", "DONE", "REJECTED"]

QUEUED, RUNNING, PARKED, DONE, REJECTED = \
    "queued", "running", "parked", "done", "rejected"
_TERMINAL = (DONE, REJECTED)


class ServiceError(RuntimeError):
    """The control plane hit an unrecoverable inconsistency."""


@dataclasses.dataclass
class Job:
    """One tenant submission and its full lifecycle record."""
    job_id: int
    workload: Any
    name: str
    tenant: int
    mode: str                       # "vm" | "native" | "guest"
    golden: int
    state: str = QUEUED
    submit_slice: int = 0
    start_slice: Optional[int] = None
    done_slice: Optional[int] = None
    lane: Optional[int] = None
    slot: Optional[int] = None
    checksum: Optional[int] = None
    ok: Optional[bool] = None
    parked_path: Optional[str] = None
    events: List[str] = dataclasses.field(default_factory=list)

    @property
    def terminal(self) -> bool:
        return self.state in _TERMINAL

    def time_to_result(self) -> Optional[int]:
        """Slices from submit to completion (None until done)."""
        if self.done_slice is None:
            return None
        return self.done_slice - self.submit_slice


@dataclasses.dataclass
class _Lane:
    active: bool = False
    jobs: List[Optional[int]] = dataclasses.field(default_factory=list)


class _Monitor:
    """Per-lane liveness/progress tracking (instret-based).

    ``observe`` compares a lane's retired-instruction counter against the
    last observation: a live hart always retires instructions (spin loops
    included), so a non-advancing counter across ``observe`` calls marks
    the lane as stalled.  Suspect lanes (stall > 0) are excluded from
    snapshotting and shedding until they either progress or are declared
    dead and recovered."""

    def __init__(self):
        self._last: Dict[int, int] = {}
        self.stall: Dict[int, int] = {}

    def reset(self, lane: int) -> None:
        self._last.pop(lane, None)
        self.stall[lane] = 0

    def drop(self, lane: int) -> None:
        self._last.pop(lane, None)
        self.stall.pop(lane, None)

    def observe(self, lane: int, instret: int) -> int:
        prev = self._last.get(lane)
        if prev is None or instret > prev:
            self.stall[lane] = 0
        else:
            self.stall[lane] = self.stall.get(lane, 0) + 1
        self._last[lane] = int(instret)
        return self.stall[lane]

    def suspect(self, lane: int) -> bool:
        return self.stall.get(lane, 0) > 0


class FleetService:
    """The persistent serving daemon (see module docstring).

    ``n_harts`` preemptive pod lanes of ``guests_per_hart`` slots each,
    plus ``n_solo`` single-tenant lanes for ``mode="native"|"guest"``
    submissions.  ``slice_ticks`` is the engine-run granularity between
    control rounds and must be a multiple of ``chunk``.  ``fail_after``
    is how many progress-free rounds declare a lane dead;
    ``snapshot_every`` bounds how stale a periodic lane snapshot may get
    (control-plane mutations always snapshot in the same round).
    ``device`` (default ``cuda``) holds both pools; ``engine`` as in
    :class:`~repro_torch.core.hext.sim.Fleet`, resolved once per pool.
    """

    def __init__(self, n_harts: int = 4, guests_per_hart: int = 2,
                 n_solo: int = 0, timeslice: int = 300,
                 slice_ticks: int = 2048, chunk: int = 512,
                 engine: Any = None,
                 policy: Optional[PlacementPolicy] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 4, fail_after: int = 2,
                 device=None):
        if n_harts < 1:
            raise ValueError(f"n_harts must be >= 1, got {n_harts}")
        if slice_ticks % chunk:
            raise ValueError(
                f"slice_ticks ({slice_ticks}) must be a multiple of "
                f"chunk ({chunk}) so tick accounting stays exact")
        self.n = int(guests_per_hart)
        self.timeslice = int(timeslice)
        self.slice_ticks = int(slice_ticks)
        self.chunk = int(chunk)
        self.snapshot_every = int(snapshot_every)
        self.fail_after = int(fail_after)
        self.policy = policy or BinPackPolicy()
        self.device = resolve(device)
        self._lay = _programs.sched_layout(self.n)
        self._snapshot_dir = snapshot_dir or tempfile.mkdtemp(
            prefix="fleet-service-")
        os.makedirs(self._snapshot_dir, exist_ok=True)

        vac_pod = self._vacant_state(self._lay.mem_words)
        self._pod = Fleet.from_states(
            [vac_pod] * n_harts,
            [self._vacant_spec() for _ in range(n_harts)], engine=engine)
        self._pod_lanes = [_Lane(jobs=[None] * self.n)
                           for _ in range(n_harts)]
        self._solo: Optional[Fleet] = None
        self._solo_lanes: List[_Lane] = []
        if n_solo:
            vac_solo = self._vacant_state(_programs.MEM_WORDS)
            self._solo = Fleet.from_states(
                [vac_solo] * n_solo,
                [self._vacant_spec() for _ in range(n_solo)], engine=engine)
            self._solo_lanes = [_Lane(jobs=[None]) for _ in range(n_solo)]

        self._jobs: Dict[int, Job] = {}
        self._next_id = 0
        self._queue: List[int] = []
        self._parked: List[int] = []
        self._slices = 0
        self._pod_ran = False
        self._solo_ran = False
        self._pod_mon = _Monitor()
        self._solo_mon = _Monitor()
        self._dirty_pod: set = set()
        self._dirty_solo: set = set()
        self._weights: Dict[str, int] = {}
        # per pool: (the state the words were read from, the words)
        self._words: Dict[str, Tuple[Any, np.ndarray]] = {}
        self._idle = next((w for w in _programs.WORKLOADS_EXTRA
                           if w.name == "idle"), None)
        self.stats = {"submitted": 0, "rejected": 0, "completed": 0,
                      "failed": 0, "migrations": 0, "parks": 0,
                      "resumes": 0, "recoveries": 0, "balloons": 0}

    # -- construction helpers -----------------------------------------------
    def _vacant_state(self, mem_words: int) -> HartState:
        """A frozen lane: done=True parks it in the engine's done-mask."""
        st = HartState.fresh(mem_words, device=self.device)
        return st.replace(counters=dataclasses.replace(
            st.counters, done=torch.ones_like(st.counters.done)))

    @staticmethod
    def _vacant_spec() -> HartSpec:
        return HartSpec(None, False, "vacant")

    def _weight(self, workload: Any) -> int:
        name = getattr(workload, "name", repr(workload))
        if name not in self._weights:
            self._weights[name] = size_bucket(workload_footprint(workload))
        return self._weights[name]

    # -- public API ---------------------------------------------------------
    @property
    def slices(self) -> int:
        return self._slices

    @property
    def ticks(self) -> int:
        return self._slices * self.slice_ticks

    def job(self, job_id: int) -> Job:
        return self._jobs[job_id]

    def jobs(self) -> List[Job]:
        return [self._jobs[k] for k in sorted(self._jobs)]

    def stragglers(self) -> List[Tuple[str, int, int]]:
        """Lanes currently behind: ``(pool, lane, stall_rounds)``."""
        out = [("pod", lane, s) for lane, s in
               sorted(self._pod_mon.stall.items()) if s > 0]
        out += [("solo", lane, s) for lane, s in
                sorted(self._solo_mon.stall.items()) if s > 0]
        return out

    def submit(self, workload: Any, tenant: int = 0,
               mode: str = "vm") -> int:
        """Queue one workload; returns its job id.  ``mode="vm"`` serves
        it as a scheduler guest on the pod pool; ``"native"``/``"guest"``
        use a dedicated solo lane.  Over-capacity submissions are
        REJECTED by the admission policy (check ``job(id).state``)."""
        if mode not in ("vm", "native", "guest"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode != "vm" and self._solo is None:
            raise ValueError(f"mode {mode!r} needs n_solo > 0")
        jid = self._next_id
        self._next_id += 1
        # weight first: the footprint probe runs write_data, which warms
        # data-dependent workloads before their golden is computed
        self._weight(workload)
        job = Job(job_id=jid, workload=workload,
                  name=getattr(workload, "name", f"job{jid}"),
                  tenant=int(tenant), mode=mode,
                  golden=int(workload.golden()) & MASK64,
                  submit_slice=self._slices)
        self._jobs[jid] = job
        self.stats["submitted"] += 1
        if not self.policy.admit(len(self._queue)):
            job.state = REJECTED
            job.ok = False
            job.events.append(f"s{self._slices}: rejected (queue full)")
            self.stats["rejected"] += 1
            return jid
        self._queue.append(jid)
        job.events.append(f"s{self._slices}: queued")
        return jid

    def inject_hart_failure(self, lane: int, pool: str = "pod") -> None:
        """Test hook: scramble one lane to a powered-off (halted, not
        done) state — its instret freezes, so the progress monitor
        declares it dead after ``fail_after`` rounds and the recover
        phase restores it from its last healthy snapshot."""
        fleet, lanes = self._pool(pool)
        if not (0 <= lane < len(lanes)):
            raise ValueError(f"{pool} lane {lane} out of range")
        mem_words = self._lay.mem_words if pool == "pod" \
            else _programs.MEM_WORDS
        dead = HartState.fresh(mem_words, device=self.device)
        dead = dead.replace(halted=torch.ones_like(dead.halted))
        fleet.replace_hart(lane, dead)          # spec/bookkeeping untouched
        for jid in lanes[lane].jobs:
            if jid is not None:
                self._jobs[jid].events.append(
                    f"s{self._slices}: hart failure injected on "
                    f"{pool} lane {lane}")

    def step(self) -> None:
        """One control round + one engine slice across both pools."""
        self._harvest()
        self._recover()
        self._resume_parked()
        self._shed()
        self._evict()
        self._place()
        self._snapshot()
        self._advance()
        self._slices += 1

    def drain(self, max_slices: int = 4000) -> bool:
        """Step until every job is terminal (or the budget runs out);
        True iff all terminal jobs completed with their golden."""
        while any(not j.terminal for j in self._jobs.values()):
            if self._slices >= max_slices:
                return False
            self.step()
        return all(j.ok for j in self._jobs.values()
                   if j.state == DONE)

    def metrics(self) -> Dict[str, Any]:
        """Serving metrics: completion counts, control-plane event
        totals, and p50/p99 time-to-result (slices and ticks)."""
        t2r = sorted(j.time_to_result() for j in self._jobs.values()
                     if j.time_to_result() is not None)
        out = dict(self.stats)
        out.update({
            "slices": self._slices,
            "ticks": self.ticks,
            "queued": len(self._queue),
            "parked": len(self._parked),
        })
        if t2r:
            p50 = float(np.percentile(t2r, 50))
            p99 = float(np.percentile(t2r, 99))
            out.update({
                "p50_ttr_slices": p50, "p99_ttr_slices": p99,
                "p50_ttr_ticks": p50 * self.slice_ticks,
                "p99_ttr_ticks": p99 * self.slice_ticks,
            })
        return out

    # -- pool plumbing ------------------------------------------------------
    def _pool(self, pool: str) -> Tuple[Fleet, List[_Lane]]:
        if pool == "pod":
            return self._pod, self._pod_lanes
        if pool == "solo":
            if self._solo is None:
                raise ValueError("service booted with n_solo=0")
            return self._solo, self._solo_lanes
        raise ValueError(f"unknown pool {pool!r}")

    def _gi_done_w(self, slot: int) -> int:
        return (self._lay.ginfo0 + slot * _programs.GINFO_SIZE + 24) >> 3

    def _mailbox_w(self, slot: int) -> int:
        return (self._lay.guest_res + 8 * slot) >> 3

    def _lane_words(self, pool: str) -> np.ndarray:
        """Per lane of ``pool``: ``[done, instret, exit_code]`` and, on the
        pod pool, each slot's ginfo done word then each slot's mailbox —
        gathered on the device and read in ONE host copy, reused until the
        pool's state changes (a run or a guest/lane operation)."""
        fleet, _ = self._pool(pool)
        harts = fleet.harts.unwrap()
        held = self._words.get(pool)
        if held is not None and held[0] is harts:
            return held[1]
        c = harts.counters
        cols = [c.done.long()[:, None], c.instret[:, None],
                c.exit_code[:, None]]
        if pool == "pod":
            idx = [self._gi_done_w(s) for s in range(self.n)] + \
                [self._mailbox_w(s) for s in range(self.n)]
            cols.append(harts.mem[:, torch.tensor(idx,
                                                   device=harts.device)])
        words = torch.cat(cols, 1).cpu().numpy()
        self._words[pool] = (harts, words)
        return words

    def _gi_done(self, words: np.ndarray, lane: int, slot: int) -> int:
        return int(words[lane, 3 + slot])

    def _mailbox(self, words: np.ndarray, lane: int, slot: int) -> int:
        return int(words[lane, 3 + self.n + slot]) & MASK64

    def _lane_path(self, pool: str, lane: int) -> str:
        return os.path.join(self._snapshot_dir, f"{pool}-lane{lane}.npz")

    def _park_path(self, jid: int) -> str:
        return os.path.join(self._snapshot_dir, f"park-job{jid}.npz")

    # -- control phases -----------------------------------------------------
    def _harvest(self) -> None:
        """Retire finished jobs from hart memory (per-guest mailboxes on
        the pod pool, exit codes on the solo pool); release exited lanes
        back to the vacant pool.  Already-DONE jobs are never touched, so
        a recovery replay cannot un-complete work."""
        words = self._lane_words("pod")
        for lane, lst in enumerate(self._pod_lanes):
            if not lst.active:
                continue
            for slot, jid in enumerate(lst.jobs):
                if jid is None:
                    continue
                job = self._jobs[jid]
                if job.state != RUNNING:
                    continue
                if self._gi_done(words, lane, slot) != 1:
                    continue
                self._finish(job, self._mailbox(words, lane, slot))
                lst.jobs[slot] = None
            if words[lane, 0]:
                lst.active = False
                lst.jobs = [None] * self.n
                self._pod_mon.drop(lane)
                self._dirty_pod.discard(lane)
        if self._solo is None:
            return
        words = self._lane_words("solo")
        for lane, lst in enumerate(self._solo_lanes):
            if not lst.active or not words[lane, 0]:
                continue
            jid = lst.jobs[0]
            if jid is not None and self._jobs[jid].state == RUNNING:
                self._finish(self._jobs[jid],
                             int(words[lane, 2]) & MASK64)
            lst.active = False
            lst.jobs = [None]
            self._solo_mon.drop(lane)
            self._dirty_solo.discard(lane)

    def _finish(self, job: Job, checksum: int) -> None:
        job.state = DONE
        job.done_slice = self._slices
        job.checksum = checksum
        job.ok = checksum_ok(checksum, job.golden)
        job.lane = None
        job.events.append(
            f"s{self._slices}: done checksum={checksum:#x} ok={job.ok}")
        self.stats["completed"] += 1
        if not job.ok:
            self.stats["failed"] += 1

    def _recover(self) -> None:
        """Progress-monitor both pools; restore dead lanes from their
        last healthy per-lane snapshot (spec and job bookkeeping are
        unchanged — mutations cannot land on a V=0 lane, so the live
        assignment always matches the snapshot's)."""
        for pool, fleet, lanes, mon, ran in (
                ("pod", self._pod, self._pod_lanes, self._pod_mon,
                 self._pod_ran),
                ("solo", self._solo, self._solo_lanes, self._solo_mon,
                 self._solo_ran)):
            if fleet is None or not ran:
                continue
            words = self._lane_words(pool)
            for lane, lst in enumerate(lanes):
                if not lst.active:
                    continue
                stall = mon.observe(lane, int(words[lane, 1]))
                if stall < self.fail_after:
                    continue
                path = self._lane_path(pool, lane)
                if not os.path.exists(path):
                    raise ServiceError(
                        f"{pool} lane {lane} is dead with no snapshot "
                        f"at {path!r}")
                state, _ = _checkpoint.load(path, decode_specs=False,
                                            device=self.device)
                fleet.replace_hart(lane, state)
                mon.reset(lane)
                self.stats["recoveries"] += 1
                for jid in lst.jobs:
                    if jid is not None:
                        self._jobs[jid].events.append(
                            f"s{self._slices}: lane recovered from "
                            f"snapshot")

    def _pressure(self) -> bool:
        """Capacity pressure: queued VM work with no vacant pod lane."""
        return any(self._jobs[j].mode == "vm" for j in self._queue) and \
            all(l.active for l in self._pod_lanes)

    def _resume_parked(self) -> None:
        """Splice parked guests into free same-slot lanes (FIFO).  While
        capacity pressure persists, parked guests stay parked — resuming
        would undo the eviction and thrash park/resume every round."""
        if self._pressure():
            return
        for jid in list(self._parked):
            job = self._jobs[jid]
            for lane, lst in enumerate(self._pod_lanes):
                if not lst.active or self._pod_mon.suspect(lane):
                    continue
                if lst.jobs[job.slot] is not None:
                    continue
                try:
                    self._pod.resume_guest(lane, job.parked_path,
                                           workload=job.workload)
                except MigrationError:
                    continue               # retry next round / next lane
                self._parked.remove(jid)
                job.state = RUNNING
                job.lane = lane
                job.events.append(
                    f"s{self._slices}: resumed on lane {lane} "
                    f"slot {job.slot}")
                lst.jobs[job.slot] = jid
                self._dirty_pod.add(lane)
                self.stats["resumes"] += 1
                break

    def _lane_views(self) -> List[LaneView]:
        """Healthy active pod lanes as policy views.  A slot is free when
        no job maps to it and its guest info block reads done (never
        scheduled again until something is spliced in)."""
        words = self._lane_words("pod")
        views = []
        for lane, lst in enumerate(self._pod_lanes):
            if not lst.active or self._pod_mon.suspect(lane):
                continue
            free = tuple(
                s for s in range(self.n)
                if lst.jobs[s] is None
                and self._gi_done(words, lane, s) == 1)
            views.append(LaneView(lane=lane, jobs=tuple(lst.jobs),
                                  free_slots=free))
        return views

    def _shed(self) -> None:
        """Ask the policy for one migration per round and apply it."""
        views = self._lane_views()
        if len(views) < 2:
            return
        dec = self.policy.shed(views)
        if dec is None:
            return
        jid = self._pod_lanes[dec.src].jobs[dec.slot]
        if jid is None:
            return
        try:
            self._pod.migrate_guest(dec.src, dec.dst, dec.slot)
        except MigrationError:
            return                         # preconditions retry next round
        self._pod_lanes[dec.src].jobs[dec.slot] = None
        self._pod_lanes[dec.dst].jobs[dec.slot] = jid
        job = self._jobs[jid]
        job.lane = dec.dst
        job.events.append(
            f"s{self._slices}: migrated lane {dec.src} -> {dec.dst} "
            f"(slot {dec.slot})")
        self._dirty_pod.update((dec.src, dec.dst))
        self.stats["migrations"] += 1

    def _evict(self) -> None:
        """Under sustained capacity pressure (queued VM jobs, no vacant
        lane, oldest job past the policy's patience), park a victim."""
        vm_queue = [j for j in self._queue
                    if self._jobs[j].mode == "vm"]
        if not vm_queue:
            return
        if any(not l.active for l in self._pod_lanes):
            return                         # placement will use the lane
        oldest = self._slices - min(self._jobs[j].submit_slice
                                    for j in vm_queue)
        if oldest < getattr(self.policy, "partial_after", 0):
            return
        pick = self.policy.victim(self._lane_views())
        if pick is None:
            return
        lane, slot = pick
        jid = self._pod_lanes[lane].jobs[slot]
        if jid is None:
            return
        job = self._jobs[jid]
        try:
            path = self._pod.park_guest(lane, slot, self._park_path(jid))
        except MigrationError:
            return                         # retry next round
        self._pod_lanes[lane].jobs[slot] = None
        job.state = PARKED
        job.lane = None
        job.slot = slot                    # parked guests are slot-bound
        job.parked_path = path
        job.events.append(
            f"s{self._slices}: evicted from lane {lane} slot {slot} "
            f"(parked)")
        self._parked.append(jid)
        self._dirty_pod.add(lane)
        self.stats["parks"] += 1

    def _homeless_parked(self) -> List[Job]:
        """Parked jobs with no live lane offering their slot."""
        views = self._lane_views()
        out = []
        for jid in self._parked:
            job = self._jobs[jid]
            if not any(job.slot in v.free_slots for v in views):
                out.append(job)
        return out

    def _place(self) -> None:
        """Boot policy-packed cohorts onto vacant lanes; solo jobs FIFO
        onto vacant solo lanes.  When parked guests have no live lane to
        resume into and the queue is empty, boot a balloon host: an
        ``idle`` tenant plus ``None`` reservations for the parked slots
        (the scheduler needs at least one live guest to boot)."""
        vacant = [i for i, l in enumerate(self._pod_lanes) if not l.active]
        vm_jobs = [self._jobs[j] for j in self._queue
                   if self._jobs[j].mode == "vm"]
        if vacant and vm_jobs:
            homeless = self._homeless_parked()
            reserved = [j.slot for j in homeless][:len(vacant)]
            queued_views = [
                JobView(job_id=j.job_id, tenant=j.tenant, name=j.name,
                        weight=self._weight(j.workload),
                        age=self._slices - j.submit_slice)
                for j in vm_jobs]
            cohorts = self.policy.pack(queued_views, len(vacant), self.n,
                                       reserved=reserved)
            for lane, cohort in zip(vacant, cohorts):
                self._provision(lane, cohort)
            vacant = [i for i, l in enumerate(self._pod_lanes)
                      if not l.active]
        # pure-resume corner: parked work, empty queue, only vacant lanes
        if vacant and not any(self._jobs[j].mode == "vm"
                              for j in self._queue):
            homeless = self._homeless_parked()
            if homeless and self._idle is not None:
                taken = {j.slot for j in homeless}
                idle_slot = next((s for s in range(self.n)
                                  if s not in taken), homeless[-1].slot)
                cohort: List[Optional[int]] = [None] * self.n
                self._provision(vacant[0], cohort,
                                balloon_slot=idle_slot)
                self.stats["balloons"] += 1
        if self._solo is None:
            return
        solo_vacant = [i for i, l in enumerate(self._solo_lanes)
                       if not l.active]
        solo_jobs = [j for j in self._queue
                     if self._jobs[j].mode in ("native", "guest")]
        for lane, jid in zip(solo_vacant, solo_jobs):
            job = self._jobs[jid]
            state = HartState.boot(job.workload,
                                   guest=(job.mode == "guest"),
                                   device=self.device)
            spec = HartSpec(job.workload, job.mode == "guest", job.name)
            self._solo.replace_hart(lane, state, spec)
            self._queue.remove(jid)
            job.state = RUNNING
            job.start_slice = self._slices
            job.lane = lane
            job.events.append(f"s{self._slices}: placed on solo "
                              f"lane {lane} ({job.mode})")
            self._solo_lanes[lane] = _Lane(active=True, jobs=[jid])
            self._solo_mon.reset(lane)
            self._dirty_solo.add(lane)

    def _provision(self, lane: int, cohort: List[Optional[int]],
                   balloon_slot: Optional[int] = None) -> None:
        wls: List[Optional[Any]] = []
        for slot, jid in enumerate(cohort):
            if jid is not None:
                wls.append(self._jobs[jid].workload)
            elif slot == balloon_slot:
                wls.append(self._idle)
            else:
                wls.append(None)
        state = HartState.boot_preemptive(*wls, timeslice=self.timeslice,
                                          device=self.device)
        name = "+".join(getattr(w, "name", "~") if w is not None else "~"
                        for w in wls)
        spec = HartSpec(wls[0], True, name, guests=tuple(wls),
                        timeslice=self.timeslice)
        self._pod.replace_hart(lane, state, spec)
        self._pod_lanes[lane] = _Lane(active=True, jobs=list(cohort))
        self._pod_mon.reset(lane)
        self._dirty_pod.add(lane)
        for slot, jid in enumerate(cohort):
            if jid is None:
                continue
            job = self._jobs[jid]
            self._queue.remove(jid)
            job.state = RUNNING
            job.start_slice = self._slices
            job.lane, job.slot = lane, slot
            job.events.append(
                f"s{self._slices}: placed on lane {lane} slot {slot}")

    def _snapshot(self) -> None:
        """Write per-lane snapshots: every lane a control-plane mutation
        dirtied this round, plus a periodic refresh.  Suspect lanes are
        skipped, so the newest file for a lane always predates its
        failure."""
        periodic = (self._slices % self.snapshot_every) == 0
        for pool, fleet, lanes, mon, dirty in (
                ("pod", self._pod, self._pod_lanes, self._pod_mon,
                 self._dirty_pod),
                ("solo", self._solo, self._solo_lanes, self._solo_mon,
                 self._dirty_solo)):
            if fleet is None:
                continue
            for lane, lst in enumerate(lanes):
                if not lst.active or mon.suspect(lane):
                    continue
                if lane not in dirty and not periodic:
                    continue
                _checkpoint.save(self._lane_path(pool, lane),
                                 fleet[lane], [fleet.specs[lane]],
                                 engine_name=getattr(fleet.engine, "name",
                                                     "custom"))
            dirty.clear()

    def _advance(self) -> None:
        self._pod_ran = any(l.active for l in self._pod_lanes)
        if self._pod_ran:
            self._pod.run(self.slice_ticks, self.chunk)
        self._solo_ran = self._solo is not None and \
            any(l.active for l in self._solo_lanes)
        if self._solo_ran:
            self._solo.run(self.slice_ticks, self.chunk)
