"""``correct`` has to come out false: for the control (the port with its
TLB switched off) and for each fault a cell can have, planted under the
timed path.  The run skips the harness's look for a card and drives the
rest on the CPU (the port's eager engine), at a tiny size."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import control, run
from repro_torch.core.hext import engine

# a guest and a native fft, two short chunks
CONFIG = {"harts": 2, "mem_words": 32768, "guests_per_hart": 1,
          "timeslice": None}
MIX = {"kind": "solo", "workloads": ["fft"], "modes": ["native", "guest"],
       "poll_ticks": 64}
POD = ({"harts": 1, "mem_words": 57344, "guests_per_hart": 4,
        "timeslice": 1000},
       {"kind": "pod", "cohorts": [["sha", "fft", "crc32", "qsort"]],
        "poll_ticks": 64})


def _checks(config=CONFIG, mix=MIX, seed=11, rounds=2):
    rec = run.measure(config, mix, seed, 1e9, False, "cpu",
                      time.perf_counter(), max_rounds=rounds)
    out = run.result(rec, [], {}, False)
    return out["correct"], {k: v["value"] for k, v in out["checks"].items()}


def test_a_sound_run_is_correct():
    assert _checks() == (True, {"lanes_wrong": 0, "jobs_wrong": 0,
                                "exit_codes_wrong": 0})


@pytest.mark.parametrize("case", ["solo", "pod"])
def test_the_control_comes_out_incorrect(case):
    config, mix = (CONFIG, MIX) if case == "solo" else POD
    # the boot code runs untranslated, so the TLB matters only once the
    # kernels have turned paging on, a few hundred ticks in
    with control.tlb_off():
        correct, checks = _checks(config, mix, rounds=6)
    assert correct is False
    assert checks["lanes_wrong"] == config["harts"]


def _plant(monkeypatch, after):
    """Run the eager engine as it is, then hand ``after(input, output)``
    back in place of its result."""
    sound = engine.TorchEngine.run

    def broken(self, state, max_ticks, chunk=4096):
        return after(state, sound(self, state, max_ticks, chunk))

    monkeypatch.setattr(engine.TorchEngine, "run", broken)


def _rows(state, like, rows):
    """``state`` with the rows ``rows`` taken from ``like``."""
    def mix(a, b):
        if isinstance(a, dict):
            return {k: mix(a[k], b[k]) for k in a}
        out = a.clone()
        out[rows] = b[rows]
        return out

    return type(state).from_raw(mix(state.to_raw(), like.to_raw()))


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    _plant(monkeypatch, lambda before, after: before)
    correct, checks = _checks()
    assert correct is False and checks["lanes_wrong"] == 2


def test_half_of_the_batch_left_out(monkeypatch):
    _plant(monkeypatch, lambda before, after: _rows(after, before,
                                                    slice(1, None)))
    correct, checks = _checks()
    assert correct is False and checks["lanes_wrong"] == 1


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    def flip(before, after):
        regs = after.regs.clone()
        regs[0, 10] ^= 1
        return after.replace(regs=regs)

    _plant(monkeypatch, flip)
    correct, checks = _checks()
    assert correct is False and checks["lanes_wrong"] == 1


def test_a_finished_job_with_a_wrong_exit_code(monkeypatch):
    """A job that reports done with another checksum, as a refill would
    see it."""
    def finish_wrong(before, after):
        c = after.counters
        done = c.done.clone()
        code = c.exit_code.clone()
        done[0], code[0] = True, 12345
        return after.replace(counters=c.__class__(
            **{**{k: getattr(c, k) for k in c.__dataclass_fields__},
               "done": done, "exit_code": code}))

    _plant(monkeypatch, finish_wrong)
    correct, checks = _checks()
    assert correct is False
    assert checks["exit_codes_wrong"] >= 1 and checks["jobs_wrong"] >= 1


def test_planting_the_control_leaves_the_port_as_it_was():
    from repro_torch.core.hext import tlb
    lookup = tlb.lookup
    with control.tlb_off():
        assert tlb.lookup is not lookup
    assert tlb.lookup is lookup
    assert torch.is_tensor(tlb.init_tlb(1, "cpu")["ptr"])
