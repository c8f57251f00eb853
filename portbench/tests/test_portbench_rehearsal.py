"""The harness rehearsed on the CPU at a tiny size: the frozen assembler
and constants against the port's, the traffic generator, and a whole run
(set-up, window, trace, comparison) on the port's eager engine with every
answer held to the frozen reference."""
from __future__ import annotations

import json
import time

import numpy as np
import pytest

from portbench import bench, roofline, run, traffic
from portbench import trace as tracing
from portbench.reference import consts
from portbench.reference import programs as frozen

# a guest and a native fft: the native one finishes at 1,159 ticks and
# is refilled, the guest one is still running when the window closes
SOLO = ({"harts": 2, "mem_words": 32768, "guests_per_hart": 1,
         "timeslice": None},
        {"kind": "solo", "workloads": ["fft"], "modes": ["native", "guest"],
         "poll_ticks": 128}, 11)
# one pod with a short timeslice, so the scheduler switches guests
POD = ({"harts": 1, "mem_words": 57344, "guests_per_hart": 4,
        "timeslice": 100},
       {"kind": "pod", "cohorts": [["fft", "sha", "crc32", "stringsearch"]],
        "poll_ticks": 100}, 2)


def test_frozen_images_equal_the_ports():
    from repro_torch.core.hext import programs as port
    by_name = {w.name: w for w in port.WORKLOADS}
    for w in frozen.WORKLOADS:
        for guest in (False, True):
            np.testing.assert_array_equal(
                frozen.build_image(w, guest),
                port.build_image(by_name[w.name], guest))
        assert int(w.golden()) == int(by_name[w.name].golden())
    cohort = ("fft", "sha", "crc32", "qsort")
    f = {w.name: w for w in frozen.WORKLOADS}
    np.testing.assert_array_equal(
        frozen.build_image_nguest(tuple(f[n] for n in cohort),
                                  timeslice=1000),
        port.build_image_nguest(tuple(by_name[n] for n in cohort),
                                timeslice=1000))


def test_frozen_constants_equal_the_ports():
    from repro_torch.core.hext import csr, isa, translate
    names = [n for n in vars(consts) if n.isupper()]
    assert len(names) > 100
    for n in names:
        src = next(m for m in (csr, translate, isa) if hasattr(m, n))
        assert getattr(consts, n) == getattr(src, n), n


def test_plan_gives_every_seed_the_same_jobs_in_another_order():
    mix = bench.mix("mibench-guest")
    kinds = traffic.module(mix).kinds(mix, {"guests_per_hart": 1})
    assert len(kinds) == 9
    first, backlog = traffic.plan(kinds, 36, 2 ** 31 + 5)
    assert sorted(first) == sorted(kinds * 4)
    block = [next(backlog) for _ in range(9)]
    assert sorted(block) == sorted(kinds)
    again, _ = traffic.plan(kinds, 36, 2 ** 31 + 5)
    other, _ = traffic.plan(kinds, 36, 6)
    assert again == first and other != first


def test_every_cell_names_files_that_exist():
    b = bench.load()
    for cell in b["workloads"]:
        config = bench.config(b, cell["config"])
        assert config["chips"] == cell["chips"] == 1
        mix = bench.mix(cell["traffic"])
        # the mix's kind module, portbench/kinds/<kind>.py
        mod = traffic.module(mix)
        assert all(callable(getattr(mod, f))
                   for f in ("kinds", "image", "golden"))
        kinds = mod.kinds(mix, config)
        assert config["harts"] % len(kinds) == 0
        img = traffic.image(mod, kinds[0], config)
        assert img.shape == (config["mem_words"],)
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(bench.reader(m["name"]))
        for cell in m.get("workloads", []):
            bench.cell(b, cell)


def test_device_idle_share_lays_the_traced_busy_time_over_the_window():
    idle = bench.reader("device_idle_share")
    # 1,000 ticks of 8 traced ms in a 10 s window: 2 s idle, all of it
    # between kernels inside the runs
    rec = {"window_ticks": 1000, "window_s": 10.0, "rounds": 2,
           "refills": 0,
           "trace": {"busy_ms_per_tick": 8.0, "run_busy_s": 0.0,
                     "control_busy_s": 0.0, "refill_busy_s": 0.0}}
    assert idle(rec) == pytest.approx(20.0)
    # the card's time around the ticks counts as busy
    rec["refills"] = 100
    rec["trace"].update(run_busy_s=0.05, control_busy_s=0.2,
                        refill_busy_s=0.01)
    assert idle(rec) == pytest.approx(100 * (1 - (8.0 + 0.5 + 1.0) / 10))
    # a run with no device trace has nothing to read
    assert idle({"trace": {"busy_s": 0.1}}) is None


def test_tick_roofline_counts_a_lower_bound():
    # the state alone: 2 x 4,608 harts x the architectural bytes
    assert roofline.tick_bytes(4608, 0, 0) == \
        2 * 4608 * roofline.HART_STATE_BYTES
    assert roofline.HART_STATE_BYTES < 1500
    # 4,608 harts in 1 ms of device time reads well under the roofline
    assert 0 < roofline.tick_roofline_pct(4608, 4608, 100, 1e-3) < 10


@pytest.mark.parametrize("case", ["solo", "pod"])
def test_the_reference_holds_the_eager_engine(case, monkeypatch):
    config, mix, rounds = SOLO if case == "solo" else POD
    # the traced part at its shortest: the eager tick is slow under the
    # profiler on the CPU
    monkeypatch.setattr(tracing, "SHORT", 1)
    monkeypatch.setattr(tracing, "LONG", 2)
    rec = run.measure(config, mix, 2 ** 31 + 99, 1e9, True, "cpu",
                      time.perf_counter(), max_rounds=rounds)
    ck = rec["checks"]
    assert ck["lanes"] == config["harts"]
    assert (ck["lanes_wrong"], ck["jobs_wrong"],
            ck["exit_codes_wrong"]) == (0, 0, 0)
    assert rec["window_ticks"] == rounds * mix["poll_ticks"]
    assert rec["retired"] > 0
    if case == "solo":
        assert ck["jobs"] == 1          # the native fft, then refilled
        assert rec["refills"] == 1
        assert sorted(rec["trace"]) == ["busy_s", "control_busy_s", "harts",
                                        "instret_per_tick", "refill_busy_s",
                                        "walks_per_tick", "window_s"]
    b = bench.load()
    out = run.result(rec, b["end_to_end"] + b["per_layer"], {}, True)
    assert out["correct"] is True
    assert list(out)[-1] == "checks"
    # a CPU run has no device trace: those metrics are left out
    assert "tick_device_ms" not in out["metrics"]
    assert set(out["metrics"]) >= {"sim_minstr_per_s", "setup_s",
                                   "control_host_share"}
    json.dumps(out)


@pytest.mark.cuda
def test_the_reference_holds_the_graph_engine_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config, mix, rounds = SOLO
    rec = run.measure(config, mix, 2 ** 31 + 7, 1e9, True, "cuda",
                      time.perf_counter(), max_rounds=rounds)
    ck = rec["checks"]
    assert (ck["lanes_wrong"], ck["jobs_wrong"],
            ck["exit_codes_wrong"]) == (0, 0, 0)
    assert ck["jobs"] >= 1
    assert rec["trace"]["kernels_per_tick"] > 0
    assert rec["peak_bytes"] > 0
