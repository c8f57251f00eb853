"""The port's torture harness and oracle against the JAX package's, and
the port's engines against the port's oracle.

(a) ``generate(2026, 256)`` gives byte-identical images and equal configs
    to the reference's;
(b) the port's ``oracle.run`` equals the reference's on all 256 scenarios:
    every final-state field and the event set (the oracle is pure Python,
    so the reference runs here without JAX's x64 mode);
(c) a 16-case fuzz sub-corpus and the reference's 2-case sched smoke at
    3,072 ticks, each one ``Fleet.from_corpus`` boot, show 0 mismatches
    against ``OracleEngine`` on the eager engine (host gates) and on ticks
    of ``step_batched(gates="device")`` — the gate form the card's graph
    engine captures;
(d) the mutation tests: a change to any leaf of the compared state is
    caught, and the failure's repro line re-runs the case;
(e) ``--case`` on the CLI exits 0 on a clean case (fuzz and sched) and
    non-zero on an injected fault; the machine reset equals the oracle's.

The 256-case corpus on the graph engine needs the card (``chip_smoke.py``
phase (d); a 32-case corpus in ``tests/test_torch_cuda.py``).
"""
import shlex

import numpy as np
import pytest
import torch

from repro.core.hext import oracle as joracle
from repro.core.hext import torture as jtorture
from repro_torch.core.hext import csr as C
from repro_torch.core.hext import engine, machine, oracle, torture

SEED = torture.DEFAULT_SEED
SUB_FUZZ = 16
SCHED_SMOKE_TICKS = 3072


@pytest.fixture(scope="module")
def corpora():
    return torture.generate(SEED, 256), jtorture.generate(SEED, 256)


def test_generator_equals_reference(corpora):
    port, ref = corpora
    assert len(port) == len(ref) == 256
    for a, b in zip(port, ref):
        assert a.image.dtype == b.image.dtype == np.uint64
        assert np.array_equal(a.image, b.image), a.case
        assert a.cfg == b.cfg, a.case
        assert (a.name, a.family, a.max_ticks) == (b.name, b.family,
                                                   b.max_ticks)
    assert sum(s.family == "sched" for s in port) == 256 // 8


def test_gen_scenario_replays_a_case(corpora):
    port, _ = corpora
    for case in (0, 7, 42):
        s = torture.gen_scenario(SEED, case)
        assert np.array_equal(s.image, port[case].image)
        assert s.cfg == port[case].cfg


@pytest.mark.parametrize("family", ["fuzz", "sched"])
def test_oracle_equals_reference(corpora, family):
    port, _ = corpora
    for s in port:
        if s.family != family:
            continue
        image = torture._pad_image(s.image, torture._fleet_words(s.image))
        a = oracle.run(image, s.max_ticks)
        b = joracle.run(image, s.max_ticks)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == b[k], f"case {s.case}: {k}"


def _sched_smoke_scenarios(n_cases=2):
    """The reference's sched smoke (``tests/hext/test_torture.py``): seeded
    sched scenarios forced to N=2 and a timeslice of at most 150."""
    scens = []
    for k in range(n_cases):
        rng = torture._case_rng(SEED + 1000, k)
        cfg = torture._sample_sched_cfg(rng)
        cfg["n_guests"], cfg["mode"] = 2, "SCHED2"
        cfg["guests"] = cfg["guests"][:2]
        cfg["timeslice"] = min(cfg["timeslice"], 150)
        scens.append(torture.Scenario(
            seed=SEED + 1000, case=k,
            image=torture._build_sched_image(cfg), cfg=cfg))
    return scens


class DeviceGated:
    """``step_batched(gates="device")`` ticks on any device: every gated
    branch runs and a device-side select keeps its result, as in the
    graph engine's captured tick (``all(done)`` read once a chunk)."""

    name = "device-gates"

    def run(self, state, max_ticks, chunk=4096):
        raw = state.to_raw()
        with torch.no_grad():
            for t in range(engine._n_chunks(max_ticks, chunk) * chunk):
                if t % chunk == 0 and bool(raw["done"].all()):
                    break
                raw = machine.step_batched(raw, gates="device")
        return type(state).from_raw(raw)


@pytest.mark.parametrize("gates", ["host", "device"])
def test_sub_corpus_zero_mismatches_against_oracle(corpora, gates):
    port, _ = corpora
    eng = None if gates == "host" else DeviceGated()
    fuzz = [s for s in port if s.family == "fuzz"][:SUB_FUZZ]
    for scens, budget, words in (
            (fuzz, torture.MAX_TICKS, torture.T_MEM_WORDS),
            (_sched_smoke_scenarios(), SCHED_SMOKE_TICKS, None)):
        legs = torture._run_both(scens, budget, torture.CHUNK,
                                 mem_words=words, device="cpu", engine=eng)
        assert legs["engine"].name == ("eager" if eng is None
                                       else "device-gates")
        bad = {s.case: torture.diff_pair(legs["mach"], i, legs["orac"], i)
               for i, s in enumerate(scens)}
        assert not any(bad.values()), bad
        assert len(legs["events"]) == len(scens)
    # the composition ran guest code under the scheduler, not just boot
    assert all(int(x) >= 2 for x in legs["mach"]["ctx_switches"])


def test_run_corpus_reports_coverage_and_walls(monkeypatch):
    """``run_corpus`` end to end on an 8-case corpus (one sched case, its
    budget cut to 3,072 ticks): no failures, the static and event buckets
    counted, walls and the machine engine recorded per family."""
    monkeypatch.setattr(torture, "SCHED_MAX_TICKS", SCHED_SMOKE_TICKS)
    rep = torture.run_corpus(SEED, 8, device="cpu")
    assert rep["failures"] == []
    static = set()
    for s in torture.generate(SEED, 8):
        static |= {torture._bucket_key(b)
                   for b in torture._static_buckets(s.cfg)}
    hist = rep["coverage"]["histogram"]
    assert static < set(hist) and rep["coverage"]["buckets"] == len(hist)
    assert set(rep["families"]) == {"fuzz", "sched"}
    assert rep["families"]["fuzz"]["mem_words"] == torture.T_MEM_WORDS
    assert rep["families"]["sched"]["engine"] == "eager"
    assert rep["wall_machine"] > 0 and rep["wall_oracle"] > 0


# ---------------------------------------------------------------------------
# mutation tests: a change to any compared leaf is caught
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def final3():
    s = torture.gen_scenario(SEED, 3)
    return oracle.run(s.image, torture.MAX_TICKS)


MUTATIONS = {
    "pc": lambda m: m["pc"].__setitem__(0, int(m["pc"][0]) ^ 4),
    "x7": lambda m: m["regs"].__setitem__((0, 7), 0xDEAD),
    "x31": lambda m: m["regs"].__setitem__((0, 31), 1),
    "csr": lambda m: m["csrs"].__setitem__((0, C.R_MCAUSE), 99),
    "priv": lambda m: m["priv"].__setitem__(0, int(m["priv"][0]) ^ 1),
    "virt": lambda m: m["virt"].__setitem__(0, 1 - int(m["virt"][0])),
    "halted": lambda m: m["halted"].__setitem__(0, 1 - int(m["halted"][0])),
    "done": lambda m: m["done"].__setitem__(0, 1 - int(m["done"][0])),
    "exit_code": lambda m: m["exit_code"].__setitem__(
        0, int(m["exit_code"][0]) ^ 1),
    "console": lambda m: m["console"].__setitem__(0, 7),
    "mem": lambda m: m["mem"].__setitem__((0, 0x3000 // 8), 1),
    "exc_by_level": lambda m: m["exc_by_level"].__setitem__((0, 2), 5),
    "int_by_level": lambda m: m["int_by_level"].__setitem__((0, 1), 5),
    **{k: (lambda m, k=k: m[k].__setitem__(0, int(m[k][0]) + 1))
       for k in engine.DIFF_COUNTERS},
}


def test_identical_states_diff_clean(final3):
    assert torture.diff_case(torture._oracle_arrays(final3), 0, final3) == []


@pytest.mark.parametrize("leaf", sorted(MUTATIONS))
def test_mutated_leaf_is_caught(final3, leaf):
    mach = torture._oracle_arrays(final3)
    MUTATIONS[leaf](mach)
    assert torture.diff_case(mach, 0, final3), f"mutation of {leaf} missed"


def test_failure_repro_line_reruns_the_case(capsys):
    line = torture.repro_line(SEED, 3, "cpu")
    assert "repro_torch.core.hext.torture" in line and "--case 3" in line
    args = shlex.split(line.split(" -m repro_torch.core.hext.torture ")[1])
    assert torture.main(args) == 0
    assert torture.main(args + ["--inject-fault", "walks"]) == 1
    assert line in capsys.readouterr().out
    assert "--device" not in torture.repro_line(SEED, 3, "cuda")


# ---------------------------------------------------------------------------
# the CLI and the reset check
# ---------------------------------------------------------------------------

def test_repro_cli_clean_case_exits_zero(capsys):
    assert torture.main(["--seed", str(SEED), "--case", "3",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "machine == oracle" in out
    for field in torture._CASE_FIELDS:
        assert field in out


@pytest.mark.parametrize("field", ["x7", "walks", "exit_code"])
def test_repro_cli_injected_fault_exits_nonzero(field, capsys):
    rc = torture.main(["--seed", str(SEED), "--case", "3",
                       "--device", "cpu", "--inject-fault", field])
    assert rc == 1
    out = capsys.readouterr().out
    assert "MISMATCH" in out and "--case 3" in out


def test_repro_cli_handles_sched_family_case(capsys):
    case = torture.SCHED_EVERY - 1        # the first sched case: 7
    assert torture.main(["--seed", str(SEED), "--case", str(case),
                         "--device", "cpu", "-v"]) == 0
    assert "family=sched" in capsys.readouterr().out


def test_reset_parity_with_the_oracle():
    torture._check_reset_parity("cpu")
