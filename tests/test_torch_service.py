"""The port's fleet-as-a-service control plane on the CPU.

(a) the reference's admission and policy tests, as they are, on the
    port's ``policies``; the port's decisions equal the reference's on the
    same views (both are numpy only);
(b) the golden invariant on short workloads: a daemon-served N=2 pod
    lane (fft, sha) and native/guest solo lanes end with every counter
    field equal to a direct boot of the same groups (the reference's
    four-workload cohort runs on the card, ``chip_smoke.py`` phase (f));
(c) the service reads its pools' words once per state: a round with no
    change to a pool reads it once;
(d) a dead lane with no snapshot raises, and a stalled lane surfaces as a
    straggler.

The long-workload evict/park/resume and N=3 shed cases run on the card
(``tests/test_torch_cuda.py``), as does the 16-submission serve trace
(``chip_smoke.py --serve``).
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro.core.hext import policies as jpolicies
from repro.core.hext import programs as jprograms
from repro_torch.core.hext import programs
from repro_torch.core.hext.policies import (BinPackPolicy, JobView,
                                            LaneView, size_bucket,
                                            workload_footprint)
from repro_torch.core.hext.service import (QUEUED, REJECTED, FleetService,
                                           ServiceError)
from repro_torch.core.hext.sim import Fleet, HartState

pytestmark = pytest.mark.serve

BY_NAME = {w.name: w for w in programs.WORKLOADS + programs.WORKLOADS_EXTRA}
CHUNK = 512
SLICE = 2048


def _svc(tmp_path, **kw):
    kw.setdefault("n_harts", 2)
    kw.setdefault("guests_per_hart", 2)
    kw.setdefault("timeslice", 300)
    kw.setdefault("slice_ticks", SLICE)
    kw.setdefault("chunk", CHUNK)
    kw.setdefault("snapshot_dir", str(tmp_path / "snaps"))
    kw.setdefault("device", "cpu")
    return FleetService(**kw)


# ---------------------------------------------------------------------------
# (a) policy units (no simulation)
# ---------------------------------------------------------------------------

def test_admission_rejects_over_capacity(tmp_path):
    svc = _svc(tmp_path, policy=BinPackPolicy(max_queue=2))
    sha = BY_NAME["sha"]
    ids = [svc.submit(sha, tenant=t) for t in range(3)]
    assert [svc.job(i).state for i in ids] == [QUEUED, QUEUED, REJECTED]
    assert svc.job(ids[2]).ok is False
    assert svc.stats["rejected"] == 1
    assert svc.job(ids[2]).terminal


def test_binpack_ffd_and_tenant_anti_affinity():
    pol = BinPackPolicy(partial_after=2)
    q = [JobView(0, tenant=7, name="a", weight=0, age=0),
         JobView(1, tenant=7, name="b", weight=2, age=0),
         JobView(2, tenant=8, name="c", weight=2, age=0),
         JobView(3, tenant=8, name="d", weight=0, age=0)]
    cohorts = pol.pack(q, n_lanes=2, slots=2)
    assert cohorts == [[1, 2], [0, 3]] or cohorts == [[1, 2], [3, 0]]
    tenants = [{q[j].tenant for j in c} for c in cohorts]
    assert all(len(t) == 2 for t in tenants)


def test_binpack_partial_cohorts_wait_then_boot():
    pol = BinPackPolicy(partial_after=2)
    young = [JobView(0, tenant=0, name="a", weight=0, age=0)]
    assert pol.pack(young, n_lanes=1, slots=2) == []
    old = [JobView(0, tenant=0, name="a", weight=0, age=2)]
    assert pol.pack(old, n_lanes=1, slots=2) == [[0, None]]


def test_binpack_reserved_slot_held_for_parked_guest():
    pol = BinPackPolicy(partial_after=0)
    q = [JobView(0, tenant=0, name="a", weight=0, age=5),
         JobView(1, tenant=1, name="b", weight=0, age=5)]
    cohorts = pol.pack(q, n_lanes=1, slots=2, reserved=[1])
    assert cohorts == [[0, None]]
    cohorts = pol.pack(q, n_lanes=2, slots=2, reserved=[0])
    assert cohorts[0] == [None, 0]
    assert 1 in cohorts[1]


def test_policy_shed_and_victim_decisions():
    pol = BinPackPolicy(shed_margin=2)
    hot = LaneView(lane=0, jobs=(10, 11, 12), free_slots=())
    cool = LaneView(lane=1, jobs=(13, None, None), free_slots=(1, 2))
    dec = pol.shed([hot, cool])
    assert (dec.src, dec.dst) == (0, 1) and dec.slot in (1, 2)
    assert pol.shed([hot, LaneView(1, (13, 14, None), (2,))]) is None
    lane, slot = pol.victim([hot, cool])
    assert (lane, slot) == (0, 2)
    assert pol.victim([LaneView(0, (5, None), (1,))]) is None


def test_size_buckets_span_registry():
    buckets = {w.name: size_bucket(workload_footprint(w))
               for w in programs.WORKLOADS}
    assert set(buckets.values()) == {0, 1, 2}
    assert buckets["sha"] == 0 and buckets["fft"] == 2


def test_policy_decisions_equal_reference():
    """Footprints and every decision of both packages' BinPackPolicy on
    one seeded set of views."""
    for w, jw in zip(programs.WORKLOADS, jprograms.WORKLOADS):
        assert workload_footprint(w) == jpolicies.workload_footprint(jw)
    rng = np.random.default_rng(2026)
    for _ in range(50):
        kw = dict(max_queue=int(rng.integers(1, 8)),
                  partial_after=int(rng.integers(0, 3)),
                  shed_margin=int(rng.integers(1, 3)))
        pols = (BinPackPolicy(**kw), jpolicies.BinPackPolicy(**kw))
        n_jobs, slots = int(rng.integers(1, 7)), int(rng.integers(1, 4))
        n_lanes = int(rng.integers(1, 4))
        views = [dict(job_id=j, tenant=int(rng.integers(0, 3)),
                      name=f"w{j}", weight=int(rng.integers(0, 3)),
                      age=int(rng.integers(0, 4))) for j in range(n_jobs)]
        reserved = [int(x) for x in rng.integers(0, slots,
                                                 int(rng.integers(0, 2)))]
        lanes = []
        for lane in range(int(rng.integers(1, 4))):
            jobs = tuple(int(x) if rng.random() < 0.6 else None
                         for x in rng.integers(0, 20, slots))
            free = tuple(s for s, j in enumerate(jobs) if j is None)
            lanes.append(dict(lane=lane, jobs=jobs, free_slots=free))
        out = []
        for pol, mod in zip(pols, (None, jpolicies)):
            JV = JobView if mod is None else mod.JobView
            LV = LaneView if mod is None else mod.LaneView
            dec = pol.shed([LV(**v) for v in lanes])
            out.append((pol.admit(n_jobs),
                        pol.pack([JV(**v) for v in views],
                                 n_lanes, slots,
                                 reserved=reserved),
                        None if dec is None else dataclasses.astuple(dec),
                        pol.victim([LV(**v) for v in lanes])))
        assert out[0] == out[1]


# ---------------------------------------------------------------------------
# (b) the golden invariant: daemon == direct boot
# ---------------------------------------------------------------------------

def test_daemon_matches_direct_bit_identical(tmp_path):
    wl = {k: BY_NAME[k] for k in ("fft", "sha")}
    svc = _svc(tmp_path, n_harts=1, n_solo=2, slice_ticks=1024,
               policy=BinPackPolicy(partial_after=0))
    vm_ids = [svc.submit(w, tenant=t) for t, w in enumerate(wl.values())]
    nat = svc.submit(BY_NAME["sha"], tenant=8, mode="native")
    gst = svc.submit(BY_NAME["fft"], tenant=9, mode="guest")
    svc.step()                                 # everything places round 0
    placed = {(svc.job(i).lane, svc.job(i).slot): svc.job(i).workload
              for i in vm_ids}
    groups = [tuple(placed[(0, s)] for s in range(2))]
    solo_order = [svc.job(nat).lane, svc.job(gst).lane]
    assert svc.drain(200)
    assert svc.stats["completed"] == 4 and svc.stats["failed"] == 0

    # the direct boots of both pools as ONE fleet (the N=2 layout and the
    # solo layout share one memory size), run to completion by slices
    states = [HartState.boot_preemptive(*g, timeslice=300, device="cpu")
              for g in groups]
    states += [HartState.boot(BY_NAME["sha"], device="cpu"),
               HartState.boot(BY_NAME["fft"], guest=True, device="cpu")]
    direct = Fleet.from_states(states)
    while not direct.all_done:
        direct.run(1024, chunk=CHUNK)
    want = direct.harts.unwrap().counters
    got_pod = svc._pod.harts.unwrap().counters
    got_solo = svc._solo.harts.unwrap().counters
    for field in dataclasses.fields(want):
        w = getattr(want, field.name)
        assert torch.equal(getattr(got_pod, field.name), w[:1]), field.name
        assert torch.equal(getattr(got_solo, field.name)[solo_order],
                           w[1:]), field.name
    for i in (nat, gst):
        assert svc.job(i).ok


# ---------------------------------------------------------------------------
# (c), (d) reads, failures and stragglers
# ---------------------------------------------------------------------------

def test_lane_words_read_once_per_state(tmp_path, monkeypatch):
    svc = _svc(tmp_path, n_solo=1)
    svc.submit(BY_NAME["sha"], tenant=0, mode="native")
    reads = []
    real = svc._lane_words.__func__

    def counting(self, pool):
        held = self._words.get(pool)
        fresh = held is None or held[0] is not self._pool(pool)[0] \
            .harts.unwrap()
        reads.append((pool, fresh))
        return real(self, pool)

    monkeypatch.setattr(FleetService, "_lane_words", counting)
    svc.step()
    svc.step()                               # the solo lane ran one slice
    fresh = [(p, f) for p, f in reads if f]
    # round 0 reads both pools once; round 1 re-reads each pool only once
    # (the pod never ran, so its words are the ones read in round 0)
    assert fresh.count(("solo", True)) == 2
    assert fresh.count(("pod", True)) == 1


def test_recovery_without_snapshot_raises(tmp_path):
    svc = _svc(tmp_path, snapshot_every=10_000, fail_after=1,
               slice_ticks=CHUNK)
    svc.submit(BY_NAME["sha"], tenant=0)
    svc.submit(BY_NAME["fft"], tenant=1)
    svc.step()
    for p in pathlib.Path(svc._snapshot_dir).glob("pod-lane*.npz"):
        p.unlink()
    svc.inject_hart_failure(0, pool="pod")
    with pytest.raises(ServiceError, match="no snapshot"):
        for _ in range(4):
            svc.step()


def test_stragglers_surface_stalled_lanes(tmp_path):
    svc = _svc(tmp_path, fail_after=10, slice_ticks=CHUNK)
    svc.submit(BY_NAME["sha"], tenant=0)
    svc.submit(BY_NAME["fft"], tenant=1)
    svc.step()
    svc.inject_hart_failure(0, pool="pod")
    svc.step()
    svc.step()
    assert ("pod", 0, svc._pod_mon.stall[0]) in svc.stragglers()
