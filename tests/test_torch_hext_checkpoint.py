"""The port's checkpoint module and ``Fleet.snapshot`` / ``Fleet.restore``.

(a) snapshot mid-run → restore → run on equals the run that never
    stopped, leaf by leaf: a native + guest pair and an N = 4 preemptive
    hart; specs come back by workload name;
(b) truncated, foreign, wrong-version, missing-field and edited-hash files
    raise ``CheckpointError``; custom workloads restore without a
    workload, and an unknown preemptive guest name is refused;
(c) ``save_guest`` / ``load_guest`` round-trip, write atomically and
    validate their regions;
(d) across the packages: a port snapshot has the reference's keys,
    dtypes and ``schema_sha256`` and the reference's ``load`` reads it to
    an equal state; a reference ``save`` of a JAX state restores in the
    port, and both step on equal for 200 ticks.

JAX runs only under a test-local ``jax.enable_x64(True)``; the reference
checkpoint module's own ``_x64`` is swapped for it with ``monkeypatch``.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.hext import checkpoint as jckpt
from repro.core.hext import machine as jmachine
from repro.core.hext import programs as jprograms
from repro.core.hext import sim as jsim
from repro_torch.core.hext import checkpoint, engine, programs
from repro_torch.core.hext.sim import Fleet, HartSpec, HartState, MASK64


def _wl(mod, name):
    return next(w for w in mod.WORKLOADS if w.name == name)


def _sha_pair():
    sha = _wl(programs, "sha")
    return Fleet.boot([sha, sha], guest=[False, True], device="cpu")


def _quad():
    quad = tuple(_wl(programs, n) for n in ("sha", "fft", "crc32",
                                            "bitcount"))
    return Fleet.boot([quad], guests_per_hart=4, timeslice=100,
                      device="cpu")


def _leaves(raw, prefix=""):
    for k, v in raw.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(v)


def _assert_same(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k]), k


@pytest.fixture
def ref_x64(monkeypatch):
    """The reference checkpoint module under a working x64 switch."""
    monkeypatch.setattr(jckpt, "_x64", lambda: jax.enable_x64(True))


# ---------------------------------------------------------------------------
# (a) snapshot → restore → run on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("boot,labels,preempts", [
    (_sha_pair, ["sha/native", "sha/guest"], False),
    (_quad, ["sha+fft+crc32+bitcount/4guest-preempt"], True)],
    ids=["native+guest", "n4-preemptive"])
def test_snapshot_resume_bit_identical(tmp_path, boot, labels, preempts):
    fleet = boot().run(200, chunk=100)
    assert not fleet.all_done                      # genuinely mid-run
    path = fleet.snapshot(tmp_path / "fleet.npz")
    restored = Fleet.restore(path, device="cpu")
    _assert_same(restored.harts.to_numpy(), fleet.harts.to_numpy())
    assert restored.engine.name == "eager"
    fleet.run(200, chunk=100)                      # the run never stopped
    restored.run(200, chunk=100)
    _assert_same(restored.harts.to_numpy(), fleet.harts.to_numpy())
    # the N = 4 window spans timer preemptions and context switches
    assert (int(restored.harts.counters.ctx_switches.sum()) > 0) == preempts
    # specs survived by name: the report still carries the goldens
    rep = restored.report()
    assert list(rep) == labels
    want = fleet.report()
    for label in labels:
        assert rep[label]["golden"] == want[label]["golden"]
    assert [s.workload.name for s in restored.specs] == \
        [s.workload.name for s in fleet.specs]


def test_checkpoint_rejects_corruption_and_schema_mismatch(tmp_path):
    fleet = _sha_pair()                            # boot only — no run
    path = tmp_path / "ok.npz"
    fleet.snapshot(path)
    Fleet.restore(path, device="cpu")              # sanity: loads clean

    blob = path.read_bytes()
    trunc = tmp_path / "trunc.npz"
    trunc.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(checkpoint.CheckpointError):
        Fleet.restore(trunc, device="cpu")

    junk = tmp_path / "junk.npz"
    junk.write_bytes(b"\x00" * 512)
    with pytest.raises(checkpoint.CheckpointError):
        Fleet.restore(junk, device="cpu")

    def rewrite(dst, mutate_meta=None, drop=None):
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            meta = json.loads(str(z["__meta__"][()]))
        if mutate_meta:
            mutate_meta(meta)
        if drop:
            arrays.pop(drop)
        np.savez_compressed(dst, __meta__=np.array(json.dumps(meta)),
                            **arrays)

    vbad = tmp_path / "vbad.npz"
    rewrite(vbad, mutate_meta=lambda m: m.update(version=999))
    with pytest.raises(checkpoint.CheckpointError, match="version"):
        Fleet.restore(vbad, device="cpu")

    fbad = tmp_path / "fbad.npz"
    rewrite(fbad, drop="csrs")
    with pytest.raises(checkpoint.CheckpointError):
        Fleet.restore(fbad, device="cpu")

    hbad = tmp_path / "hbad.npz"
    rewrite(hbad, mutate_meta=lambda m: m.update(schema_sha256="0" * 64))
    with pytest.raises(checkpoint.CheckpointError, match="schema"):
        Fleet.restore(hbad, device="cpu")

    with pytest.raises(ValueError):
        Fleet.restore(path, specs=fleet.specs[:1], device="cpu")


class _CustomWl(programs.Workload):
    name = "notinregistry"

    def asm(self, a):
        a.label("workload_entry")
        a.li("a0", 1234)
        a.ret()

    def golden(self):
        return 1234


def test_restore_unknown_workload_needs_explicit_specs(tmp_path):
    wl = _CustomWl()
    fleet = Fleet.boot([wl, wl], guest=[False, True], device="cpu")
    path = tmp_path / "custom.npz"
    fleet.snapshot(path)
    restored = Fleet.restore(path, device="cpu")
    assert all(s.workload is None for s in restored.specs)
    assert "ok" not in restored.report()["notinregistry/native"]
    explicit = Fleet.restore(path, specs=fleet.specs, device="cpu")
    assert explicit.specs[0].workload is wl


def test_restore_preemptive_unknown_guest_rejected(tmp_path):
    wl = _CustomWl()
    fleet = Fleet.boot([(wl, _wl(programs, "sha"))], guests_per_hart=2,
                       timeslice=300, device="cpu")
    path = tmp_path / "pcustom.npz"
    fleet.snapshot(path)
    with pytest.raises(checkpoint.CheckpointError, match="registry"):
        Fleet.restore(path, device="cpu")
    explicit = Fleet.restore(path, specs=fleet.specs, device="cpu")
    assert explicit.specs[0].guests[0] is wl


# ---------------------------------------------------------------------------
# (c) per-guest checkpoints
# ---------------------------------------------------------------------------

def _guest_regions(n=2, slot=0):
    lay = programs.sched_layout(n)
    return {name: np.full(size >> 3, 7, np.uint64)
            for name, (base, size) in zip(
                checkpoint.GUEST_REGIONS, programs.guest_regions(lay, slot))}


def test_guest_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "g.npz")
    regions = _guest_regions()
    out = checkpoint.save_guest(path, regions, n=2, slot=0,
                                timeslice=300, workload="sha")
    got, meta = checkpoint.load_guest(out)
    assert meta["n"] == 2 and meta["slot"] == 0
    assert meta["workload"] == "sha" and meta["timeslice"] == 300
    for name in checkpoint.GUEST_REGIONS:
        np.testing.assert_array_equal(got[name], regions[name])


def test_atomic_write_kill_mid_write_keeps_old_file(tmp_path, monkeypatch):
    path = str(tmp_path / "g.npz")
    checkpoint.save_guest(path, _guest_regions(), n=2, slot=0)
    before = pathlib.Path(path).read_bytes()

    real = checkpoint.np.savez_compressed

    def dying_savez(fh, **arrays):
        real(fh, **arrays)                     # bytes hit the temp file
        raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(checkpoint.np, "savez_compressed", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_guest(path, _guest_regions(), n=2, slot=1)
    monkeypatch.undo()
    assert pathlib.Path(path).read_bytes() == before
    regions, meta = checkpoint.load_guest(path)
    assert meta["slot"] == 0
    assert [p.name for p in tmp_path.iterdir()] == ["g.npz"]


def test_guest_checkpoint_validation(tmp_path):
    bad = _guest_regions()
    bad.pop("gtab")
    with pytest.raises(checkpoint.CheckpointError):
        checkpoint.save_guest(str(tmp_path / "a.npz"), bad, n=2, slot=0)
    wrong = _guest_regions()
    wrong["ctx"] = wrong["ctx"][:-1]
    with pytest.raises(checkpoint.CheckpointError):
        checkpoint.save_guest(str(tmp_path / "b.npz"), wrong, n=2, slot=0)
    # a fleet checkpoint is not a guest checkpoint
    st = HartState.fresh(1024, device="cpu")
    checkpoint.save(str(tmp_path / "fleet.npz"), st,
                    [HartSpec(None, False, "vacant")])
    with pytest.raises(checkpoint.CheckpointError):
        checkpoint.load_guest(str(tmp_path / "fleet.npz"))


# ---------------------------------------------------------------------------
# (d) across the packages
# ---------------------------------------------------------------------------

def _jax_batch(workload, guests):
    """Reference raw state of one hart per guest flag, built under a
    local x64 switch from ``machine._make_state``."""
    with jax.enable_x64(True):
        states = []
        for g in guests:
            img = jprograms.build_image(workload, g)
            st = jmachine._make_state(int(img.shape[0]))
            st["mem"] = jnp.asarray(img)
            states.append(st)
        return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def test_port_snapshot_reads_in_the_reference(tmp_path, ref_x64):
    fleet = _sha_pair().run(150, chunk=50)
    path = fleet.snapshot(tmp_path / "port.npz")
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(str(z["__meta__"][()]))
    # the reference's keys and dtypes, and the schema hash of a reference
    # state of the same geometry
    expected = jckpt._expected_keys_and_dtypes()
    assert {k: a.dtype for k, a in arrays.items()} == expected
    ref = jckpt._flatten(jsim.HartState.from_raw(
        _jax_batch(_wl(jprograms, "sha"), (False, True))))
    assert meta["schema_sha256"] == \
        jckpt.schema_sha256(jckpt.schema_of(ref))
    assert meta["format"] == jckpt.FORMAT and meta["version"] == \
        jckpt.VERSION
    harts, specs = jckpt.load(str(path))
    got = jckpt._flatten(harts)
    for k, a in arrays.items():
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k
    assert [(s.name, s.guest) for s in specs] == [("sha", False),
                                                  ("sha", True)]
    assert specs[1].workload.golden() & MASK64 == \
        fleet.specs[1].workload.golden() & MASK64


def test_reference_snapshot_restores_in_the_port(tmp_path, ref_x64):
    sha = _wl(jprograms, "sha")
    jst = _jax_batch(sha, (False, True))
    with jax.enable_x64(True):
        step = jax.jit(jmachine.step_batched)
        for _ in range(150):                  # a warm TLB, live CSRs
            jst = step(jst)
        path = jckpt.save(str(tmp_path / "ref.npz"),
                          jsim.HartState.from_raw(jst),
                          [jsim.HartSpec(sha, False, "sha"),
                           jsim.HartSpec(sha, True, "sha")])
    fleet = Fleet.restore(path, device="cpu")
    assert fleet.engine.name == "eager"
    assert [s.label for s in fleet.specs] == ["sha/native", "sha/guest"]
    with jax.enable_x64(True):
        ref = jax.tree.map(np.asarray, jst)
    _assert_same(fleet.harts.to_numpy(), ref)
    with jax.enable_x64(True):
        for _ in range(200):
            jst = step(jst)
        ref = jax.tree.map(np.asarray, jst)
    fleet.run(200, chunk=200)
    got = fleet.harts.to_numpy()
    for i in range(2):
        assert engine.diff_arrays(got, i, ref, i) == [], i
    _assert_same(got, ref)
    assert fleet.harts.counters.ticks.tolist() == [350, 350]
