"""The port's fleet operations: corpus constructors, the oracle and sharded
engines, guest migrate/park/resume and lane replacement.

(a) ``or_image`` / ``from_states`` / ``from_images`` / ``from_corpus``:
    padding, power-of-two sizing, the oversized-image error, and the boot
    state of a corpus equal to the reference's ``Fleet.from_corpus``;
(b) engines: ``resolve("oracle")`` / ``resolve("sharded")``;
    ``OracleEngine`` equals the eager engine leaf by leaf (TLB included)
    and runs the rounded-up budget; a state goes through it bit-exactly;
    ``ShardedEngine(devices=["cpu", "cpu"])`` equals the eager engine on
    an odd batch (pad, split and cut on one device);
(c) guest operations on short workloads hit the goldens: a migration mid
    run, and a park whose file the reference's ``load_guest`` reads, with
    the resume taken from a file the reference's ``save_guest`` wrote;
(d) every precondition error, and the state a migrate/park/resume leaves,
    equal the reference's on the same crafted states (the reference runs
    under a test-local ``jax.enable_x64(True)``: ROADMAP R1);
(e) ``replace_hart``: the shape errors, the fleet's engine kept, the stale
    view guard, and a replaced lane run to its golden.

Migration, park and replace on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase (e).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hext import checkpoint as jckpt
from repro.core.hext import engine as jengine
from repro.core.hext import programs as jprograms
from repro.core.hext import sim as jsim
from repro_torch.core.hext import checkpoint, engine, programs, torture
from repro_torch.core.hext.sim import (MASK64, Fleet, HartSpec, HartState,
                                       MigrationError, StaleHartsError)

CHUNK = 256


def _wl(name, mod=programs):
    return next(w for w in mod.WORKLOADS + mod.WORKLOADS_EXTRA
                if w.name == name)


@pytest.fixture
def ref_x64(monkeypatch):
    """The reference's facade under ``jax.enable_x64(True)`` (R1)."""
    for mod in (jsim, jengine, jckpt):
        monkeypatch.setattr(mod, "_x64", lambda: jax.enable_x64(True))


def _leaves(raw, prefix=""):
    for k, v in raw.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _assert_states_equal(a: HartState, b: HartState):
    lb = dict(_leaves(b.to_raw()))
    for k, v in _leaves(a.to_raw()):
        assert v.dtype == lb[k].dtype and torch.equal(v, lb[k]), k


# ---------------------------------------------------------------------------
# (a) corpus constructors
# ---------------------------------------------------------------------------

def test_or_image_merges_at_base():
    st = HartState.fresh(64, batch=2, device="cpu").or_image(
        np.array([1, 2], np.uint64), base=16)
    st = st.or_image(np.array([4, 1 << 63], np.uint64), base=16)
    assert st.mem[:, 2].tolist() == [5, 5]
    assert st.mem[:, 3].tolist() == [2 - (1 << 63)] * 2
    assert int(st.mem.count_nonzero()) == 4


def test_from_images_pads_and_rejects_oversized():
    imgs = [np.arange(1, 5, dtype=np.uint64),
            np.array([MASK64], np.uint64)]
    f = Fleet.from_images(imgs, mem_words=16, names=["a", "b"],
                          device="cpu")
    mem = f.harts.mem
    assert mem.shape == (2, 16) and mem.dtype == torch.int64
    assert mem[0, :5].tolist() == [1, 2, 3, 4, 0]
    assert mem[1, :2].tolist() == [-1, 0]
    assert [s.label for s in f.specs] == ["a/native", "b/native"]
    with pytest.raises(ValueError, match="4 words > mem_words=3"):
        Fleet.from_images(imgs, mem_words=3, device="cpu")


def test_from_corpus_sizes_to_a_power_of_two():
    f = Fleet.from_corpus([np.ones(100, np.uint64), np.ones(300, np.uint64)],
                          device="cpu")
    assert f.harts.mem.shape == (2, 512)
    assert [s.name for s in f.specs] == ["case0", "case1"]
    assert f.engine.name == "eager"
    g = Fleet.from_states([f[1], f[0]])
    assert [s.name for s in g.specs] == ["hart0", "hart1"]
    assert torch.equal(g.harts.mem, f.harts.mem.flip(0))
    with pytest.raises(ValueError, match="at least one"):
        Fleet.from_corpus([], device="cpu")


def test_from_corpus_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        Fleet.from_corpus([np.ones(8, np.uint64)])


def test_corpus_boot_equals_reference(ref_x64):
    scens = torture.generate(torture.DEFAULT_SEED, 8)
    imgs = [s.image for s in scens]
    port = engine.state_arrays(
        Fleet.from_corpus(imgs, device="cpu").harts.unwrap())
    ref = jengine.state_arrays(jsim.Fleet.from_corpus(imgs).harts.unwrap())
    assert port["mem"].shape == ref["mem"].shape == (8, 32768)
    for k, v in ref.items():
        np.testing.assert_array_equal(port[k].astype(v.dtype), v,
                                      err_msg=k)


# ---------------------------------------------------------------------------
# (b) engines
# ---------------------------------------------------------------------------

def test_registry_resolves_oracle_and_sharded():
    assert isinstance(engine.resolve("oracle"), engine.OracleEngine)
    assert isinstance(engine.resolve("sharded"), engine.ShardedEngine)
    assert {"eager", "graph", "oracle", "sharded"} <= set(engine.ENGINES)
    with pytest.raises(ValueError, match="unknown engine"):
        engine.resolve("jit")


def test_oracle_engine_equals_eager_every_leaf():
    def boot(eng):
        return Fleet.boot([_wl("sha"), _wl("fft")], guest=[True, False],
                          device="cpu", engine=eng)

    a = boot("eager").run(500, chunk=CHUNK)
    b = boot("oracle").run(500, chunk=CHUNK)
    # both run the budget rounded up to whole chunks: 512 ticks
    assert a.harts.counters.ticks.tolist() == [512, 512]
    _assert_states_equal(a.harts.unwrap(), b.harts.unwrap())
    assert len(b.engine.last_events) == 2
    b.run(30000, chunk=4096)
    rep = b.report()
    assert rep["sha/guest"]["ok"] and rep["fft/native"]["ok"]


def test_oracle_engine_carries_every_bit_pattern():
    """Zero ticks through the oracle: the snapshot and the adoption are
    exact on random 64-bit patterns (2**63 and above included)."""
    rng = np.random.default_rng(2026)
    st = HartState.fresh(256, batch=3, device="cpu")
    rnd = lambda *s: torch.as_tensor(
        rng.integers(0, 1 << 64, s, dtype=np.uint64).view(np.int64))
    tlb = dict(st.tlb, vpn=rnd(3, 16), ppn=rnd(3, 16),
               valid=torch.as_tensor(rng.random((3, 16)) < 0.5))
    st = st.replace(pc=rnd(3), regs=rnd(3, 32), csrs=rnd(*st.csrs.shape),
                    mem=rnd(3, 256), tlb=tlb,
                    counters=dataclasses.replace(st.counters,
                                                 exit_code=rnd(3)))
    out = engine.OracleEngine().run(st, 0)
    _assert_states_equal(out, st)


def test_sharded_engine_equals_eager_on_an_odd_batch():
    imgs = [s.image for s in torture.generate(torture.DEFAULT_SEED, 7)
            if s.family == "fuzz"][:5]

    def run(eng):
        return Fleet.from_corpus(imgs, mem_words=torture.T_MEM_WORDS,
                                 device="cpu", engine=eng).run(
            torture.MAX_TICKS, chunk=torture.CHUNK).harts.unwrap()

    sharded = engine.ShardedEngine(devices=["cpu", "cpu"])
    want = run("eager")
    got = run(sharded)
    assert got.batch == 5
    _assert_states_equal(got, want)
    one = engine.ShardedEngine(devices=["cpu"])
    _assert_states_equal(run(one), want)
    assert [e.name for e in sharded._engines.values()] == ["eager"]


# ---------------------------------------------------------------------------
# (c) guest operations mid run, to the goldens
# ---------------------------------------------------------------------------

def _retry(op, fleet, tries=12):
    for _ in range(tries):
        try:
            return op()
        except MigrationError:
            fleet.run(300, chunk=300)
    pytest.fail("the guest never became movable")


def test_migrate_guest_mid_run_hits_goldens():
    """fft moves mid-flight from hart 0 into hart 1's slot 1 (the fft
    tenant there is discarded) and reaches its golden on hart 1."""
    sha, ss, fft = (_wl(n) for n in ("sha", "stringsearch", "fft"))
    moved = programs.FFT()
    fleet = Fleet.boot([(sha, moved), (ss, fft)], guests_per_hart=2,
                       timeslice=300, device="cpu")
    fleet.run(1000, chunk=500)
    assert not fleet.all_done
    view = fleet.harts
    _retry(lambda: fleet.migrate_guest(0, 1, guest=1), fleet)
    with pytest.raises(StaleHartsError):
        view.pc
    assert fleet.specs[0].guests[1] is None
    assert fleet.specs[1].guests[1] is moved
    fleet.run(30000, chunk=1024)
    rep = fleet.report()
    src = rep["sha+moved/2guest-preempt"]
    assert src["done"] and src["ok"] and src["ok_guests"] == [True, None]
    assert src["checksums"][1] == 0
    dst = rep["stringsearch+fft/2guest-preempt"]
    assert dst["done"] and dst["ok"] and dst["ok_guests"] == [True, True]
    assert dst["checksums"][1] == int(fft.golden()) & MASK64


def test_park_and_resume_across_packages_hit_goldens(tmp_path):
    """fft is parked from hart 0 slot 1; the reference's ``load_guest``
    reads the port's file; the reference's ``save_guest`` writes it again
    and the port resumes that file into hart 1's reserved slot 1."""
    sha, fft, ss = _wl("sha"), _wl("fft"), _wl("stringsearch")
    fleet = Fleet.boot([(sha, fft), (ss, None)], guests_per_hart=2,
                       timeslice=300, device="cpu")
    fleet.run(1000, chunk=500)
    path = _retry(lambda: fleet.park_guest(0, 1, tmp_path / "fft.npz"),
                  fleet)
    assert fleet.specs[0].name == "sha+parked"
    regions, meta = jckpt.load_guest(path)
    port_regions, port_meta = checkpoint.load_guest(path)
    assert meta == port_meta and meta["workload"] == "fft"
    for name in checkpoint.GUEST_REGIONS:
        np.testing.assert_array_equal(regions[name], port_regions[name])
    ref_path = jckpt.save_guest(str(tmp_path / "fft-ref.npz"), regions,
                                n=meta["n"], slot=meta["slot"],
                                timeslice=meta["timeslice"],
                                workload=meta["workload"])
    _retry(lambda: fleet.resume_guest(1, ref_path), fleet)
    assert fleet.specs[1].guests == (ss, fft)
    fleet.run(30000, chunk=1024)
    rep = fleet.report()
    assert rep["sha+parked/2guest-preempt"]["ok_guests"] == [True, None]
    assert rep["sha+parked/2guest-preempt"]["ok"]
    dst = rep["stringsearch+fft/2guest-preempt"]
    assert dst["ok"] and dst["ok_guests"] == [True, True]


# ---------------------------------------------------------------------------
# (d) preconditions and effects against the reference, on crafted states
# ---------------------------------------------------------------------------

NAMES = (("sha", "crc32"), ("stringsearch", "fft"))


def _pair_fleets(poke):
    """The port's and the reference's fleet over one crafted state: two
    N=2 harts and a native one (one memory size, 32,768 words); ``poke``
    edits the port's raw state before both are built."""
    states = [HartState.boot_preemptive(*(_wl(n) for n in g), timeslice=300,
                                        device="cpu") for g in NAMES]
    states.append(HartState.boot(_wl("qsort"), device="cpu"))
    raw = HartState.stack(states).to_raw()
    poke(raw)
    port = HartState.from_raw(raw)

    def specs(mod):
        out = [HartSpec(_wl(g[0], mod), True, "+".join(g),
                        guests=tuple(_wl(n, mod) for n in g), timeslice=300)
               for g in NAMES]
        return out + [HartSpec(_wl("qsort", mod), False, "qsort")]

    with jax.enable_x64(True):
        jraw = jax.tree.map(jnp.asarray, port.to_numpy())
        jharts = jsim.HartState.from_raw(jraw)
    return (Fleet(port, specs(programs)),
            jsim.Fleet(jharts, [jsim.HartSpec(**dataclasses.asdict(s))
                                for s in specs(jprograms)]))


def _set(raw, hart, virt=None, done=None, cur=None, gdone=None):
    lay = programs.sched_layout(2)
    if virt is not None:
        raw["virt"][hart] = virt
    if done is not None:
        raw["done"][hart] = done
    if cur is not None:
        raw["mem"][hart, programs.SCHED_CUR >> 3] = cur
    for g, v in (gdone or {}).items():
        raw["mem"][hart, (lay.ginfo0 + g * programs.GINFO_SIZE + 24) >> 3] \
            = v


def _guest_ready(raw):
    """Both N=2 harts in guest code with slot 1 scheduled (slot 0 idle)."""
    for h in (0, 1):
        _set(raw, h, virt=True, cur=1)


CASES = {
    "different": (lambda r: None, "migrate_guest", (0, 0, 0), "different"),
    "hart range": (lambda r: None, "migrate_guest", (0, 5, 0),
                   "out of range"),
    "guest range": (lambda r: None, "migrate_guest", (0, 1, 5),
                    "out of range"),
    "not preemptive": (lambda r: None, "migrate_guest", (0, 2, 0),
                       "preemptive"),
    "V=0 at boot": (lambda r: None, "migrate_guest", (0, 1, 0), "V=0"),
    "scheduled": (lambda r: (_guest_ready(r), _set(r, 0, cur=0)),
                  "migrate_guest", (0, 1, 0), "currently scheduled"),
    "dst exited": (lambda r: (_guest_ready(r), _set(r, 1, done=True)),
                   "migrate_guest", (0, 1, 0), "already exited"),
    "finished": (lambda r: (_guest_ready(r), _set(r, 0, gdone={0: 1})),
                 "migrate_guest", (0, 1, 0), "already finished"),
    "park V=0": (lambda r: None, "park_guest", (0, 0), "V=0"),
    "park native": (lambda r: None, "park_guest", (2, 0), "preemptive"),
    "park range": (lambda r: None, "park_guest", (0, 3), "out of range"),
    "park finished": (lambda r: (_guest_ready(r), _set(r, 0, gdone={0: 1})),
                      "park_guest", (0, 0), "already finished"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_precondition_errors_equal_reference(case, ref_x64, tmp_path):
    poke, op, args, words = CASES[case]
    port, ref = _pair_fleets(poke)
    if op == "park_guest":
        args = args + (str(tmp_path / "g.npz"),)
    msgs = []
    for fleet in (port, ref):
        with pytest.raises(Exception) as exc:
            getattr(fleet, op)(*args)
        assert type(exc.value).__name__ == "MigrationError"
        msgs.append(str(exc.value))
    assert words in msgs[0] and msgs[0] == msgs[1]


def _ref_mem(ref):
    with jax.enable_x64(True):
        return np.asarray(ref.harts.unwrap().mem).view(np.int64)


def test_migrate_park_resume_effects_equal_reference(ref_x64, tmp_path):
    port, ref = _pair_fleets(_guest_ready)
    for f in (port, ref):
        f.migrate_guest(0, 1, guest=0)
    assert np.array_equal(port.harts.mem.numpy(), _ref_mem(ref))
    assert [s.name for s in port.specs] == [s.name for s in ref.specs]
    for f in (port, ref):
        with pytest.raises(Exception, match="already migrated away"):
            f.migrate_guest(0, 1, guest=0)
    # park slot 0 of hart 1 (the migrated sha), in both packages
    paths = [port.park_guest(1, 0, tmp_path / "p.npz"),
             ref.park_guest(1, 0, str(tmp_path / "r.npz"))]
    assert np.array_equal(port.harts.mem.numpy(), _ref_mem(ref))
    a, ma = checkpoint.load_guest(paths[0])
    b, mb = jckpt.load_guest(paths[1])
    assert ma == mb
    for name in checkpoint.GUEST_REGIONS:
        np.testing.assert_array_equal(a[name], b[name])
    for f in (port, ref):
        with pytest.raises(Exception, match="empty slot"):
            f.park_guest(1, 0, str(tmp_path / "x.npz"))
    # each resumes the OTHER package's file into hart 0's free slot 0
    port.resume_guest(0, paths[1])
    ref.resume_guest(0, paths[0])
    assert np.array_equal(port.harts.mem.numpy(), _ref_mem(ref))
    assert [s.name for s in port.specs] == [s.name for s in ref.specs]
    # slot 0 of hart 0 is live again: a second resume is refused
    for f in (port, ref):
        with pytest.raises(Exception, match="still live"):
            f.resume_guest(0, paths[0])


def test_resume_layout_and_workload_errors_equal_reference(ref_x64,
                                                           tmp_path):
    port, ref = _pair_fleets(_guest_ready)
    lay3 = programs.sched_layout(3)
    regions = {name: np.zeros(size >> 3, np.uint64) for name, (_, size) in
               zip(checkpoint.GUEST_REGIONS, programs.guest_regions(lay3, 0))}
    n3 = checkpoint.save_guest(str(tmp_path / "n3.npz"), regions, n=3,
                               slot=0, workload="sha")
    lay2 = programs.sched_layout(2)
    regions = {name: np.zeros(size >> 3, np.uint64) for name, (_, size) in
               zip(checkpoint.GUEST_REGIONS, programs.guest_regions(lay2, 0))}
    anon = checkpoint.save_guest(str(tmp_path / "anon.npz"), regions, n=2,
                                 slot=0)
    for path, words in ((n3, "N=3 layout"), (anon, "cannot resolve")):
        msgs = []
        for f in (port, ref):
            with pytest.raises(Exception) as exc:
                f.resume_guest(0, path)
            msgs.append(str(exc.value))
        assert words in msgs[0] and msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# (e) replace_hart
# ---------------------------------------------------------------------------

def test_replace_hart_errors():
    fleet = Fleet.boot([_wl("sha")], guest=True, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        fleet.replace_hart(0, HartState.fresh(1024, device="cpu"))
    with pytest.raises(ValueError, match="batch of one"):
        fleet.replace_hart(0, HartState.fresh(programs.MEM_WORDS, batch=2,
                                              device="cpu"))
    with pytest.raises(ValueError, match="out of range"):
        fleet.replace_hart(3, HartState.fresh(programs.MEM_WORDS,
                                              device="cpu"))


def test_replace_hart_keeps_the_engine_and_hits_the_golden():
    sha, fft = _wl("sha"), _wl("fft")
    fleet = Fleet.boot([sha, sha], guest=True, device="cpu")
    eng = fleet.engine
    fleet.run(400, chunk=200)
    view = fleet.harts
    before = fleet[0]
    fleet.replace_hart(1, HartState.boot(fft, device="cpu"),
                       HartSpec(fft, False, "fft"))
    with pytest.raises(StaleHartsError):
        view.pc
    assert fleet.engine is eng
    _assert_states_equal(fleet[0], before)
    assert int(fleet.harts.counters.ticks[1]) == 0
    fleet.run(30000, chunk=1024)
    rep = fleet.report()
    assert rep["sha/guest"]["ok"] and rep["fft/native"]["ok"]
    assert rep["fft/native"]["ticks"] == 1159
