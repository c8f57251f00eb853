"""The port's hext path as a whole against the JAX package.

(a) the port's ``step_batched`` equals a jitted JAX ``step_batched`` state
    for state, leaf for leaf, on every tick of fft native + fft guest run as
    one B=2 batch until both are done;
(b) ``Fleet.boot(..., device="cpu")`` counters equal the committed goldens
    in ``benchmarks/results/hext_runs.json``;
(c) state carried across with ``HartState.from_numpy`` / ``to_numpy``
    round-trips exactly;
(d) the entry points run on CUDA by default and raise without it.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hext import machine as jmachine
from repro.core.hext import programs as jprograms
from repro_torch.core.hext import engine, machine, programs
from repro_torch.core.hext.sim import Fleet, HartState

GOLDEN = json.loads((Path(__file__).resolve().parents[1] /
                     "benchmarks/results/hext_runs.json").read_text())
FIELDS = ("done", "exit_code", "instret", "instret_virt", "ticks",
          "exc_by_level", "int_by_level", "pagefaults", "walks",
          "timer_irqs", "ctx_switches", "ok")


def _wl(mod, name):
    return next(w for w in mod.WORKLOADS if w.name == name)


def _leaves(raw, prefix=""):
    for k, v in raw.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(v)


def _jax_batch(images):
    """Reference raw state for a batch of images, built under a local x64
    switch from ``machine._make_state`` (no ``load_image``/``sim``)."""
    with jax.enable_x64(True):
        states = []
        for img in images:
            st = jmachine._make_state(int(img.shape[0]))
            st["mem"] = jnp.asarray(img)
            states.append(st)
        return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def test_step_batched_matches_reference_every_tick():
    fft = _wl(jprograms, "fft")
    jst = _jax_batch([jprograms.build_image(fft, False),
                      jprograms.build_image(fft, True)])
    with jax.enable_x64(True):
        step = jax.jit(jmachine.step_batched)
        ref = jax.tree.map(np.asarray, jst)
    port = HartState.from_numpy(ref, device="cpu").to_raw()
    ticks = 0
    while not ref["done"].all():
        with jax.enable_x64(True):
            jst = step(jst)
            ref = jax.tree.map(np.asarray, jst)
        port = machine.step_batched(port)
        ticks += 1
        got = dict(_leaves(HartState.from_raw(port).to_numpy()))
        bad = [k for k, v in _leaves(ref)
               if v.dtype != got[k].dtype or not np.array_equal(v, got[k])]
        if bad:
            detail = [engine.diff_arrays(got, i, ref, i) for i in range(2)]
            pytest.fail(f"tick {ticks}: leaves {bad} differ; {detail}")
        assert ticks <= 2000, "reference did not finish"
    assert ticks == GOLDEN["workloads"]["fft"]["guest"]["ticks"] == 1544
    assert bool(port["done"].all())


@pytest.fixture(scope="module")
def fleet_report():
    wls = [_wl(programs, n) for n in ("sha", "fft")]
    fleet = Fleet.boot(wls * 2, guest=[False, False, True, True],
                       device="cpu")
    fleet.run(4096, chunk=128)
    assert fleet.all_done
    return fleet.report()


@pytest.mark.parametrize("label", ["sha/native", "fft/native", "sha/guest",
                                   "fft/guest"])
def test_fleet_counters_match_goldens(fleet_report, label):
    name, mode = label.split("/")
    want = GOLDEN["workloads"][name][mode]
    got = fleet_report[label]
    assert {f: got[f] for f in FIELDS} == {f: want[f] for f in FIELDS}
    assert got["ok"] and got["golden"] == GOLDEN["workloads"][name]["golden"]


def test_numpy_round_trip_exact():
    sha = _wl(programs, "sha")
    st = HartState.stack([HartState.boot(sha, guest=g, device="cpu")
                          for g in (False, True)])
    for _ in range(150):          # a state with a warm TLB and live CSRs
        st = st.step()
    raw = st.to_numpy()
    back = HartState.from_numpy(raw, device="cpu").to_numpy()
    a, b = dict(_leaves(raw)), dict(_leaves(back))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert engine.diff_states(st, HartState.from_numpy(raw, device="cpu"),
                              0, 0) == []


def test_from_numpy_takes_reference_layout():
    """A reference state (single hart, 0-d leaves, uint64 words) comes
    across with the reference's dtypes preserved on the way back."""
    img = jprograms.build_image(_wl(jprograms, "crc32"), True)
    with jax.enable_x64(True):
        st = jmachine._make_state(int(img.shape[0]))
        st["mem"] = jnp.asarray(img)
        ref = jax.tree.map(np.asarray, st)
    got = dict(_leaves(HartState.from_numpy(ref, device="cpu").to_numpy()))
    for k, v in _leaves(ref):
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k][0], v, err_msg=k)


@pytest.mark.parametrize("n", [2, 3])
def test_preemptive_boot_matches_reference_image(n):
    tenants = tuple(programs.WORKLOADS[i] for i in range(n))
    fleet = Fleet.boot([tenants], guests_per_hart=n, device="cpu")
    ref = jprograms.build_image_nguest(
        [jprograms.WORKLOADS[i] for i in range(n)])
    np.testing.assert_array_equal(
        fleet.harts.to_numpy()["mem"][0], ref)
    assert fleet.specs[0].label.endswith(f"/{n}guest-preempt")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sha = _wl(programs, "sha")
    with pytest.raises(RuntimeError, match="CUDA"):
        Fleet.boot([sha])
    with pytest.raises(RuntimeError, match="CUDA"):
        HartState.boot(sha)
    with pytest.raises(RuntimeError, match="CUDA"):
        HartState.fresh()
    # an explicit CPU request is honoured
    assert HartState.fresh(1024, device="cpu").device.type == "cpu"


def test_load_image_writes_at_base():
    st = machine._make_state(512, 2, "cpu")
    img = np.arange(1, 9, dtype=np.uint64) | np.uint64(1 << 63)
    out = machine.load_image(st, img, base=0x40)
    want = np.zeros((2, 512), np.uint64)
    want[:, 8:16] = img
    np.testing.assert_array_equal(out["mem"].numpy().view(np.uint64), want)
    assert not bool(st["mem"].any())       # the input state is untouched
