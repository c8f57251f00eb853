"""The port's engine layer: the two gate forms of ``step_batched``, the
engine registry, ``instrs_per_step``, the stale-view guard and the
reference's default chunk.

(a) ``gates="device"`` (every branch runs, a device-side ``any`` selects)
    equals ``gates="host"`` leaf by leaf on every tick of fft native + fft
    guest run to completion and of the first 400 ticks of a 2-guest
    preemptive hart with a short timeslice; over the two runs each of the
    four gates opens at least once and stays shut at least once;
(b) the registry resolves names, instances and the device's default and
    rejects the rest with the reference's errors;
(c) ``instrs_per_step`` 2 and 8 equal 1, and ``_check_ips`` rejects 3;
(d) a ``fleet.harts`` view taken before a run raises after it;
(e) the default chunk is the reference's 4096, so ``run(100)`` of sha
    guest ends done at the golden's 1,649 ticks;
(f) ``store="inplace"`` equals the default ``store="copy"`` leaf by leaf
    on every tick of native, guest and 4-guest preemptive batches, writes
    the input's own memory, while the default leaves its input as it was;
    the graph's captured body stores into its static memory in place.

The graph engine itself needs the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 4).
"""
import collections
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.hext import engine, machine, programs
from repro_torch.core.hext.sim import (Fleet, HartState, StaleHartsError,
                                       run_on_device)

GOLDEN = json.loads((Path(__file__).resolve().parents[1] /
                     "benchmarks/results/hext_runs.json").read_text())
GATES = ("hext.fetch_walk", "hext.data_walk", "hext.system", "hext.trap")


def _wl(name):
    return next(w for w in programs.WORKLOADS if w.name == name)


def _sha_pair(**kw):
    sha = _wl("sha")
    return Fleet.boot([sha, sha], guest=[False, True], device="cpu", **kw)


def _leaves(raw, prefix=""):
    for k, v in raw.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _differing(a, b):
    lb = dict(_leaves(b))
    return [k for k, v in _leaves(a) if not torch.equal(v, lb[k])]


def _lockstep(raw, ticks):
    """Step host- and device-gated copies of ``raw`` side by side; return
    (first tick where a leaf differs and which, or None; final state)."""
    host = dev = raw
    with torch.no_grad():
        for t in range(1, ticks + 1):
            host = machine.step_batched(host, gates="host")
            dev = machine.step_batched(dev, gates="device")
            bad = _differing(host, dev)
            if bad:
                return (t, bad), host
            if bool(host["done"].all()):
                break
    return None, host


@pytest.fixture(scope="module")
def gate_runs():
    """Both runs, with every host gate's verdict counted per gate."""
    opened = collections.defaultdict(set)
    real = machine._gated

    def counting(need, gates, span, branch, neutral):
        if gates == "host":
            opened[span].add(bool(need.any()))
        return real(need, gates, span, branch, neutral)

    machine._gated = counting
    try:
        fft = _wl("fft")
        pair = HartState.stack([HartState.boot(fft, guest=g, device="cpu")
                                for g in (False, True)])
        fft_bad, fft_end = _lockstep(pair.to_raw(), 2000)
        pre = HartState.boot_preemptive(fft, _wl("sha"), timeslice=100,
                                        device="cpu")
        pre_bad, pre_end = _lockstep(pre.to_raw(), 400)
    finally:
        machine._gated = real
    return {"fft": (fft_bad, fft_end), "preempt": (pre_bad, pre_end),
            "opened": opened}


def test_device_gates_match_host_gates_fft_to_completion(gate_runs):
    bad, end = gate_runs["fft"]
    assert bad is None, f"tick {bad[0]}: leaves {bad[1]} differ"
    assert bool(end["done"].all())
    ticks = GOLDEN["workloads"]["fft"]
    assert end["ticks"].tolist() == [ticks["native"]["ticks"],
                                     ticks["guest"]["ticks"]]


def test_device_gates_match_host_gates_preemptive(gate_runs):
    bad, end = gate_runs["preempt"]
    assert bad is None, f"tick {bad[0]}: leaves {bad[1]} differ"
    assert int(end["ticks"][0]) == 400
    assert int(end["timer_irqs"][0]) > 0    # the slices preempt in-window


@pytest.mark.parametrize("gate", GATES)
def test_every_gate_opens_and_stays_shut(gate_runs, gate):
    assert gate_runs["opened"][gate] == {True, False}


def test_step_batched_rejects_unknown_gates():
    st = HartState.fresh(64, device="cpu").to_raw()
    with pytest.raises(ValueError, match="gates"):
        machine.step_batched(st, gates="sometimes")


def test_step_batched_rejects_unknown_store():
    st = HartState.fresh(64, device="cpu").to_raw()
    with pytest.raises(ValueError, match="store"):
        machine.step_batched(st, store="sometimes")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_engine_registry_resolution():
    assert engine.resolve(None, "cpu").name == "eager"
    assert engine.resolve(None, "cuda").name == "graph"
    assert engine.resolve(None).name == "graph"      # cuda is the default
    assert engine.resolve("eager").name == "eager"
    assert engine.resolve("graph").name == "graph"
    inst = engine.TorchEngine()
    assert engine.resolve(inst) is inst              # instances pass through
    assert isinstance(inst, engine.Engine)
    assert isinstance(engine.GraphEngine(), engine.Engine)
    assert engine.resolve("oracle").name == "oracle"
    assert engine.resolve("sharded").name == "sharded"
    for name in ("warp-drive", "jit"):
        with pytest.raises(ValueError, match="unknown engine"):
            engine.resolve(name)
    with pytest.raises(TypeError):
        engine.resolve(42)
    # Fleet resolves once, by its device unless the caller names one
    assert _sha_pair().engine.name == "eager"
    assert _sha_pair(engine="graph").engine.name == "graph"
    assert _sha_pair(engine=inst).engine is inst


def test_graph_engine_raises_on_a_cpu_state():
    fleet = _sha_pair(engine="graph")
    with pytest.raises(ValueError, match="CUDA"):
        fleet.run(32, chunk=32)


# ---------------------------------------------------------------------------
# instrs_per_step
# ---------------------------------------------------------------------------

def test_instrs_per_step_bit_identical():
    one = _sha_pair().run(64, chunk=32)
    for ips in (2, 8):
        got = _sha_pair(engine=engine.TorchEngine(instrs_per_step=ips))
        got.run(64, chunk=32)
        for i in range(2):
            assert engine.diff_states(got[i], one[i]) == [], f"ips={ips}"
        assert _differing(got.harts.to_raw(), one.harts.to_raw()) == []
    with pytest.raises(ValueError, match="instrs_per_step"):
        engine._check_ips(1024, 3)        # 1024 % 3 != 0
    for eng in (engine.TorchEngine(3), engine.GraphEngine(3)):
        with pytest.raises(ValueError, match="instrs_per_step must divide"):
            eng.run(_sha_pair().harts.unwrap(), 32, chunk=1024)


# ---------------------------------------------------------------------------
# stale-view guard
# ---------------------------------------------------------------------------

def test_stale_harts_reference_raises():
    fleet = _sha_pair()
    view = fleet.harts
    _ = view.pc                                   # live before the run
    fleet.run(32, chunk=32)
    with pytest.raises(StaleHartsError, match="generation"):
        _ = view.pc
    with pytest.raises(StaleHartsError):
        view.unwrap()
    fresh = fleet.harts                           # re-read after the run
    assert tuple(fresh.pc.shape) == (2,)
    assert fresh.unwrap() is fleet.harts.unwrap()
    assert fleet[1].batch == 1 and fleet[-1].batch == 1
    assert engine.diff_states(fleet[1], fresh.unwrap(), 0, 1) == []
    with pytest.raises(IndexError):
        fleet[2]


# ---------------------------------------------------------------------------
# the reference's default chunk (4096)
# ---------------------------------------------------------------------------

def test_default_chunk_is_the_references():
    for fn in (Fleet.run, engine.TorchEngine.run, engine.GraphEngine.run,
               run_on_device):
        assert inspect.signature(fn).parameters["chunk"].default == 4096


def test_short_budget_reaches_the_golden():
    """``run(100)`` rounds up to one 4096-tick chunk: sha guest ends done
    at the golden's 1,649 ticks (a 256-tick chunk stopped it at 256)."""
    fleet = Fleet.boot([_wl("sha")], guest=True, device="cpu").run(100)
    got = fleet.report()["sha/guest"]
    want = GOLDEN["workloads"]["sha"]["guest"]
    assert got["done"] and got["ok"]
    assert got["ticks"] == want["ticks"] == 1649
    assert got["instret"] == want["instret"]


def test_run_on_device_leaves_the_input_alone():
    st = _sha_pair().harts.unwrap()
    before = st.to_numpy()
    out = run_on_device(st, 32, chunk=32)
    after = st.to_numpy()
    for k, v in _leaves(before):
        assert np.array_equal(v, dict(_leaves(after))[k]), k
    assert int(out.counters.ticks[0]) == 32


# ---------------------------------------------------------------------------
# the in-place store of the captured tick
# ---------------------------------------------------------------------------

STORE_TICKS = 300


def _store_batch(kind):
    """Two harts of short workloads: native, guest, or 4-guest preemptive
    pods whose 100-tick slices switch inside the window."""
    sha, crc, ss, fft = (_wl(n) for n in ("sha", "crc32", "stringsearch",
                                          "fft"))
    if kind == "preempt4":
        states = [HartState.boot_preemptive(*g, timeslice=100, device="cpu")
                  for g in ((sha, crc, ss, fft), (fft, ss, crc, sha))]
    else:
        states = [HartState.boot(w, guest=kind == "guest", device="cpu")
                  for w in (sha, crc)]
    return HartState.stack(states).to_raw()


@pytest.mark.parametrize("kind", ["native", "guest", "preempt4"])
def test_inplace_store_matches_copy_every_tick(kind):
    copy = _store_batch(kind)
    boot_mem = copy["mem"].clone()
    inplace = engine._clone(copy)
    mem = inplace["mem"]
    with torch.no_grad():
        for t in range(1, STORE_TICKS + 1):
            held = engine._clone(copy)
            new = machine.step_batched(copy, gates="device")
            assert _differing(held, copy) == [], f"tick {t}: input written"
            assert new["mem"] is not copy["mem"]
            inplace = machine.step_batched(inplace, gates="device",
                                           store="inplace")
            assert inplace["mem"] is mem, t
            bad = _differing(new, inplace)
            assert not bad, f"tick {t}: leaves {bad} differ"
            copy = new
    assert not torch.equal(copy["mem"], boot_mem)     # the harts stored
    if kind == "preempt4":
        assert int(copy["timer_irqs"].min()) > 0


def test_tick_body_stores_into_static_memory(monkeypatch):
    raw = _store_batch("guest")
    held = engine._clone(raw)
    static = engine._clone(raw)
    mem = static["mem"]
    real, wrote = machine.step_batched, []

    def spy(state, **kw):
        out = real(state, **kw)
        wrote.append(out["mem"] is mem)
        return out

    monkeypatch.setattr(machine, "step_batched", spy)
    with torch.no_grad():
        engine._tick_body(static, 2)
        assert wrote == [True, True]
        want = engine._ticks(raw, 2)
    assert wrote[2:] == [False, False]
    assert static["mem"] is mem
    assert _differing(static, want) == []
    assert _differing(raw, held) == []
