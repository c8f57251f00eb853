"""Kinds of job, found by name (``portbench/kinds/<kind>.py``): the three
cells' traffic pinned to what it was before the kinds moved there, and a
kind added by one module alone — with no golden, and one job that never
finishes — rehearsed through a whole run on the CPU, with the faults it
can have planted."""
from __future__ import annotations

import dataclasses
import hashlib
import sys
import time
import types

import pytest
import torch

from portbench import bench, check, run, traffic
from portbench.kinds import pad
from portbench.reference import programs as P
from repro_torch.core.hext import engine, sim

SEEDS = (1, 2 ** 31 + 5, 2 ** 33 + 17)

# Taken from the harness before the kinds moved into modules of their
# own: the first 16 hex digits of the sha256 of each kind's image (its
# little-endian words) and of the boot order followed by the first two
# backlog blocks (at the cell's harts, joined by newlines), and each
# kind's golden.
PINNED = {
    "mibench-guest": {
        "images": {
            "bitcount/guest": "0a388419644710c6",
            "basicmath/guest": "c9094429f1c84689",
            "qsort/guest": "a695b36318962d42",
            "susan/guest": "2de7cc07e6b21357",
            "sha/guest": "c6be2bf8f6843d0c",
            "crc32/guest": "1f954a82ab56097b",
            "dijkstra/guest": "76c51391917c1ec2",
            "stringsearch/guest": "167798c60e3fc796",
            "fft/guest": "7b533fda43928bd1",
        },
        "goldens": {
            "bitcount/guest": 3145,
            "basicmath/guest": 6363,
            "qsort/guest": 140163516972489126,
            "susan/guest": 208708,
            "sha/guest": 6624817737179081775,
            "crc32/guest": 2113075345,
            "dijkstra/guest": 2429,
            "stringsearch/guest": 3,
            "fft/guest": 9954,
        },
        "plans": {
            1: "e89d86cc97a7be40",
            2147483653: "87de4ced3f763467",
            8589934609: "8540c890d2771d68",
        },
    },
    "mibench-pod4": {
        "images": {
            "bitcount+basicmath+qsort+susan/pod": "24ceae3e671d4a98",
            "basicmath+qsort+susan+sha/pod": "448fff51e53c53da",
            "qsort+susan+sha+crc32/pod": "2179cbb1930c1285",
            "susan+sha+crc32+dijkstra/pod": "0f62e557ad1969ba",
            "sha+crc32+dijkstra+stringsearch/pod": "cff172de92aa2ca4",
            "crc32+dijkstra+stringsearch+fft/pod": "3545667979cf0562",
            "dijkstra+stringsearch+fft+bitcount/pod": "d78ac594b38a5e84",
            "stringsearch+fft+bitcount+basicmath/pod": "4218b530721cac55",
            "fft+bitcount+basicmath+qsort/pod": "cbf974ae636c4958",
        },
        "goldens": {
            "bitcount+basicmath+qsort+susan/pod": 140163516972707342,
            "basicmath+qsort+susan+sha/pod": 6764981254151785972,
            "qsort+susan+sha+crc32/pod": 6764981256264854954,
            "susan+sha+crc32+dijkstra/pod": 6624817739292368257,
            "sha+crc32+dijkstra+stringsearch/pod": 6624817739292159552,
            "crc32+dijkstra+stringsearch+fft/pod": 2113087731,
            "dijkstra+stringsearch+fft+bitcount/pod": 15531,
            "stringsearch+fft+bitcount+basicmath/pod": 19465,
            "fft+bitcount+basicmath+qsort/pod": 140163516972508588,
        },
        "plans": {
            1: "85f7011c75766998",
            2147483653: "a3066ab36690857d",
            8589934609: "ca92dcf769726b82",
        },
    },
    "mibench-native": {
        "images": {
            "bitcount/native": "c51b15f83452716b",
            "basicmath/native": "6280166f33e55805",
            "qsort/native": "c1a5aac53784e011",
            "susan/native": "63c4b7441935e17b",
            "sha/native": "01646cfa3aa96008",
            "crc32/native": "49bfd3aa568879e5",
            "dijkstra/native": "3825a664b51f585e",
            "stringsearch/native": "78c30ecbd15dfc74",
            "fft/native": "5020a4895eada681",
        },
        "goldens": {
            "bitcount/native": 3145,
            "basicmath/native": 6363,
            "qsort/native": 140163516972489126,
            "susan/native": 208708,
            "sha/native": 6624817737179081775,
            "crc32/native": 2113075345,
            "dijkstra/native": 2429,
            "stringsearch/native": 3,
            "fft/native": 9954,
        },
        "plans": {
            1: "1ded0bc2f8f30818",
            2147483653: "065fa5689b13cb8e",
            8589934609: "20753e6a2aa6f9d7",
        },
    },
}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_cells_traffic_is_pinned(name, seed):
    b = bench.load()
    cell = next(c for c in b["workloads"] if c["traffic"] == name)
    config = bench.config(b, cell["config"])
    mix, pin = bench.mix(name), PINNED[name]
    mod = traffic.module(mix)
    kinds = mod.kinds(mix, config)
    assert kinds == list(pin["images"])
    assert {k: _sha(traffic.image(mod, k, config).astype("<u8").tobytes())
            for k in kinds} == pin["images"]
    assert {k: mod.golden(k) for k in kinds} == pin["goldens"]
    first, backlog = traffic.plan(kinds, int(config["harts"]), seed)
    blocks = [next(backlog) for _ in range(2 * len(kinds))]
    assert _sha("\n".join(first + blocks).encode()) == pin["plans"][seed]


@pytest.mark.parametrize("kind", ["nosuch", "../solo"])
def test_an_unknown_kind_names_the_file_it_looked_for(kind):
    with pytest.raises(ValueError, match=f"portbench/kinds/{kind}.py"):
        traffic.module({"kind": kind})


def test_the_harness_branches_on_no_kind():
    for name in ("traffic", "sweep", "check"):
        src = (bench.HERE / f"{name}.py").read_text()
        assert '"solo"' not in src and '"pod"' not in src, name


# A kind added by a module alone: two M-mode programs, one that reports
# its exit code after five ticks and one that counts in a loop forever
# and keeps its lane to the end of the window.  It has no golden.
POLL, ROUNDS = 16, 4
CONFIG = {"harts": 4, "mem_words": 512, "guests_per_hart": 1,
          "timeslice": None}
MIX = {"kind": "rehearsal", "poll_ticks": POLL}


def _image(kind, config):
    a = P.Asm(P.M_BOOT)
    if kind == "rehearsal/finish":
        a.li("a0", 0x5EED)
        a.li("t1", P.MMIO_DONE)
        a.sd("a0", 0, "t1")
    a.label("spin")
    a.addi("t0", "t0", 1)
    a.j("spin")
    img = P.Image(16)
    img.place_code(P.M_BOOT, a.assemble())
    return pad(img.mem, config, kind)


@pytest.fixture
def rehearsal_kind(monkeypatch):
    mod = types.ModuleType("portbench.kinds.rehearsal")
    mod.kinds = lambda mix, config: ["rehearsal/finish", "rehearsal/spin"]
    mod.image = _image
    mod.golden = lambda kind: None
    monkeypatch.setitem(sys.modules, "portbench.kinds.rehearsal", mod)
    return mod


def _rehearse(monkeypatch, device="cpu"):
    """Four rounds of the rehearsal mix; (whether it is correct, the
    result's checks, what the check was handed: the lanes' kinds and ages
    and the harvest)."""
    seen = {}
    compare = check.compare

    def spy(port, kinds, ages, harvest, images, goldens):
        seen.update(kinds=list(kinds), ages=list(ages),
                    harvest=list(harvest))
        return compare(port, kinds, ages, harvest, images, goldens)

    monkeypatch.setattr(check, "compare", spy)
    rec = run.measure(CONFIG, MIX, 2 ** 31 + 77, 1e9, False, device,
                      time.perf_counter(), max_rounds=ROUNDS)
    out = run.result(rec, [], {}, False)
    assert rec["refills"] == len(seen["harvest"])
    return out["correct"], {k: v["value"] for k, v in
                            out["checks"].items()}, seen


@pytest.mark.parametrize(
    "device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_a_kind_with_no_golden(device, rehearsal_kind, monkeypatch):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert traffic.module(MIX) is rehearsal_kind
    correct, checks, seen = _rehearse(monkeypatch, device)
    assert correct is True
    assert checks == {"lanes_wrong": 0, "jobs_wrong": 0,
                      "exit_codes_wrong": 0}
    harvest = seen["harvest"]
    assert harvest and {k for k, _, _ in harvest} == {"rehearsal/finish"}
    assert all(got["done"] and got["exit_code"] == 0x5EED
               for _, _, got in harvest)
    # a job that never finishes keeps its lane and is held by the lane
    # compare at the age it reached: a boot lane has run every tick
    spin = [a for k, a in zip(seen["kinds"], seen["ages"])
            if k == "rehearsal/spin"]
    assert ROUNDS * POLL + 1 in spin


def test_a_golden_less_job_with_a_counter_altered(rehearsal_kind,
                                                  monkeypatch):
    """The counters read at the harvest of a finished job are off by one
    instruction; the lanes themselves are sound."""
    counters = sim.Fleet.counters

    def off(self):
        return [dataclasses.replace(c, instret=c.instret + 1)
                if bool(c.done) else c for c in counters(self)]

    monkeypatch.setattr(sim.Fleet, "counters", off)
    correct, checks, seen = _rehearse(monkeypatch)
    assert correct is False
    assert checks == {"lanes_wrong": 0, "jobs_wrong": len(seen["harvest"]),
                      "exit_codes_wrong": 0}


def test_a_golden_less_exit_code_altered(rehearsal_kind, monkeypatch):
    """A finished job reports another exit code where the tick produces
    it; with no golden, only the reference can tell."""
    sound = engine.TorchEngine.run

    def flip(self, state, max_ticks, chunk=4096):
        after = sound(self, state, max_ticks, chunk)
        c = after.counters
        code = torch.where(c.done, c.exit_code ^ 1, c.exit_code)
        return after.replace(counters=dataclasses.replace(c, exit_code=code))

    monkeypatch.setattr(engine.TorchEngine, "run", flip)
    correct, checks, _ = _rehearse(monkeypatch)
    assert correct is False
    assert checks["jobs_wrong"] >= 1 and checks["exit_codes_wrong"] == 0


def test_a_job_that_never_finishes_altered(rehearsal_kind, monkeypatch):
    """Every lane whose job has not finished gets one more count in its
    loop register (t0) than it ran; no harvest ever reads a job that
    never finishes, so only the lane compare can tell."""
    sound = engine.TorchEngine.run

    def bump(self, state, max_ticks, chunk=4096):
        after = sound(self, state, max_ticks, chunk)
        regs = after.regs.clone()
        regs[:, 5] += (~after.counters.done).to(regs.dtype)
        return after.replace(regs=regs)

    monkeypatch.setattr(engine.TorchEngine, "run", bump)
    correct, checks, seen = _rehearse(monkeypatch)
    assert correct is False
    assert checks["lanes_wrong"] >= seen["kinds"].count("rehearsal/spin")
