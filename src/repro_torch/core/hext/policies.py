"""Placement / shedding / eviction policies for the fleet control plane —
the port's own copy of ``repro.core.hext.policies`` (numpy only).

The :class:`FleetService` daemon (:mod:`repro_torch.core.hext.service`) is
policy-agnostic: every decision about *where* work runs goes through a
``PlacementPolicy`` object.  The policy sees only light-weight views —
:class:`JobView` for queued/parked jobs and :class:`LaneView` for live
harts — and answers four questions:

* ``admit``  — may another submission enter the queue?
* ``pack``   — which queued jobs boot together on a fresh hart (cohorts)?
* ``shed``   — should a hot hart live-migrate a guest to a cooler one?
* ``victim`` — which guest is parked to a checkpoint under capacity
  pressure?

The default :class:`BinPackPolicy` packs first-fit-decreasing by image
size bucket with tenant anti-affinity (spread one tenant's guests across
harts when possible), sheds when the live-guest imbalance between two
harts reaches ``shed_margin``, and evicts the youngest guest from the
most-loaded hart.  All decisions are deterministic — the serve benchmark
and its goldens depend on reproducible traces.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hext import programs as _programs

__all__ = ["JobView", "LaneView", "ShedDecision", "PlacementPolicy",
           "BinPackPolicy", "workload_footprint", "size_bucket"]


# ---------------------------------------------------------------------------
# policy-visible views
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JobView:
    """What a policy may know about one queued/parked job."""
    job_id: int
    tenant: int
    name: str
    weight: int                 # size bucket (0 = small … 2 = large)
    age: int                    # control rounds spent in the queue
    slot: Optional[int] = None  # parked jobs: the slot they must resume into


@dataclasses.dataclass(frozen=True)
class LaneView:
    """One live preemptive hart: which slots run which jobs."""
    lane: int
    jobs: Tuple[Optional[int], ...]   # slot -> job_id (None = not live)
    free_slots: Tuple[int, ...]       # slots a guest could land in

    @property
    def live(self) -> int:
        return sum(1 for j in self.jobs if j is not None)


@dataclasses.dataclass(frozen=True)
class ShedDecision:
    """Live-migrate slot ``slot`` from hart ``src`` to hart ``dst``."""
    src: int
    dst: int
    slot: int


class PlacementPolicy:
    """Interface every control-plane policy implements."""

    def admit(self, queue_len: int) -> bool:
        raise NotImplementedError

    def pack(self, queued: Sequence[JobView], n_lanes: int, slots: int,
             reserved: Sequence[int] = ()) -> List[List[Optional[int]]]:
        raise NotImplementedError

    def shed(self, lanes: Sequence[LaneView]) -> Optional[ShedDecision]:
        raise NotImplementedError

    def victim(self, lanes: Sequence[LaneView]
               ) -> Optional[Tuple[int, int]]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# image-size buckets
# ---------------------------------------------------------------------------

def workload_footprint(workload: Any) -> int:
    """Approximate image footprint in 64-bit words: assembled code words
    plus non-zero data words the workload writes into a scratch image."""
    a = _programs.Asm(_programs.WORKLOAD)
    workload.asm(a)
    code = len(a.assemble())
    img = _programs.Image(_programs.MEM_WORDS)
    workload.write_data(img)
    return code + int(np.count_nonzero(img.mem))


def size_bucket(footprint_words: int) -> int:
    """0 = small (code-only kernels), 1 = medium, 2 = large (data-heavy).
    Thresholds are tuned to the registry's spread (~15–160 words) so the
    nine paper workloads actually land in distinct buckets."""
    if footprint_words < 32:
        return 0
    if footprint_words < 128:
        return 1
    return 2


# ---------------------------------------------------------------------------
# the default policy
# ---------------------------------------------------------------------------

class BinPackPolicy(PlacementPolicy):
    """First-fit-decreasing bin packing with tenant anti-affinity.

    ``pack`` sorts the queue by weight (descending, job_id tie-break) and
    forms full cohorts of ``slots`` guests, preferring to mix tenants
    inside a cohort (a tenant's own guests spread across harts).  A
    partial cohort boots only once the oldest queued job has waited
    ``partial_after`` control rounds — brief queueing beats running
    under-packed harts.  Each ``reserved`` slot index (a parked job that
    needs a same-slot home) claims one empty slot in one new cohort.

    ``shed`` proposes a migration when the live-guest count between the
    hottest and coolest lanes differs by at least ``shed_margin`` and the
    cool lane has a free matching slot.  ``victim`` parks the youngest
    guest (highest job_id) on the most-loaded lane.
    """

    def __init__(self, max_queue: int = 64, partial_after: int = 2,
                 shed_margin: int = 2):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if shed_margin < 1:
            raise ValueError(f"shed_margin must be >= 1, got {shed_margin}")
        self.max_queue = int(max_queue)
        self.partial_after = int(partial_after)
        self.shed_margin = int(shed_margin)

    # -- admission ----------------------------------------------------------
    def admit(self, queue_len: int) -> bool:
        return queue_len < self.max_queue

    # -- placement ----------------------------------------------------------
    def pack(self, queued: Sequence[JobView], n_lanes: int, slots: int,
             reserved: Sequence[int] = ()) -> List[List[Optional[int]]]:
        jobs = sorted(queued, key=lambda j: (-j.weight, j.job_id))
        reserved = list(reserved)
        cohorts: List[List[Optional[int]]] = []
        while jobs and len(cohorts) < n_lanes:
            hold = reserved[0] if reserved else None
            capacity = slots - (1 if hold is not None else 0)
            take = min(capacity, len(jobs))
            if take < capacity and \
                    max(j.age for j in jobs) < self.partial_after:
                break                      # under-packed and nobody is old
            picked: List[JobView] = []
            pool = list(jobs)
            while pool and len(picked) < take:
                tenants = {j.tenant for j in picked}
                nxt = next((j for j in pool if j.tenant not in tenants),
                           pool[0])
                picked.append(nxt)
                pool.remove(nxt)
            cohort: List[Optional[int]] = [None] * slots
            fill = iter(picked)
            for s in range(slots):
                if hold is not None and s == hold:
                    continue               # reserved for a parked guest
                j = next(fill, None)
                cohort[s] = None if j is None else j.job_id
            if not any(c is not None for c in cohort):
                break
            if hold is not None:
                reserved.pop(0)
            for j in picked:
                jobs.remove(j)
            cohorts.append(cohort)
        return cohorts

    # -- load shedding ------------------------------------------------------
    def shed(self, lanes: Sequence[LaneView]) -> Optional[ShedDecision]:
        hot = sorted(lanes, key=lambda l: (-l.live, l.lane))
        cool = sorted(lanes, key=lambda l: (l.live, l.lane))
        for src in hot:
            for dst in cool:
                if src.lane == dst.lane:
                    continue
                if src.live - dst.live < self.shed_margin:
                    continue
                for slot in sorted(dst.free_slots):
                    if src.jobs[slot] is not None:
                        return ShedDecision(src.lane, dst.lane, slot)
        return None

    # -- eviction -----------------------------------------------------------
    def victim(self, lanes: Sequence[LaneView]
               ) -> Optional[Tuple[int, int]]:
        loaded = sorted(lanes, key=lambda l: (-l.live, l.lane))
        for lane in loaded:
            if lane.live < 2:
                continue                   # never empty a hart by eviction
            slot = max((s for s, j in enumerate(lane.jobs)
                        if j is not None), key=lambda s: lane.jobs[s])
            return lane.lane, slot
        return None
