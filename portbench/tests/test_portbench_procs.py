"""No process outlives a run: the guard of ``portbench.procs`` and the
harness on a machine with no card."""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from portbench import procs

ROOT = Path(__file__).resolve().parents[2]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _session(sid: int):
    """Pids of live processes (not zombies) in session ``sid``."""
    out = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:
            continue
        fields = text[text.rindex(")") + 2:].split()
        if int(fields[3]) == sid and fields[0] != "Z":
            out.append(int(stat.parent.name))
    return out


def test_guard_reaps_a_sleeping_child():
    with procs.Guard():
        child = subprocess.Popen(["sleep", "30"])
        assert child.pid in procs.children()
    assert child.pid not in procs.children()
    assert not _alive(child.pid)


def test_children_flags_a_child_not_reaped():
    child = subprocess.Popen(["sleep", "30"])
    try:
        assert child.pid in procs.children()
    finally:
        child.kill()
        child.wait()
    assert child.pid not in procs.children()


def test_run_once_waits_on_its_helper():
    before = procs.children()
    assert procs.run_once([sys.executable, "-c", "print(7)"]).strip() == "7"
    assert procs.run_once(["sleep", "5"], timeout_s=0.2) is None
    assert procs.run_once(["/nonexistent/helper"]) is None
    assert procs.children() <= before


def test_sigterm_unwinds_through_the_guard(tmp_path):
    """A run ended by SIGTERM leaves no child behind."""
    script = tmp_path / "victim.py"
    script.write_text(textwrap.dedent(f"""
        import subprocess, sys, time
        sys.path.insert(0, {str(ROOT)!r})
        from portbench import procs
        with procs.Guard():
            child = subprocess.Popen(["sleep", "60"])
            print(child.pid, flush=True)
            time.sleep(60)
    """))
    victim = subprocess.Popen([sys.executable, str(script)],
                              stdout=subprocess.PIPE, text=True)
    grandchild = int(victim.stdout.readline())
    assert _alive(grandchild)
    victim.send_signal(signal.SIGTERM)
    assert victim.wait(timeout=30) == 128 + signal.SIGTERM
    deadline = time.monotonic() + 10
    while _alive(grandchild) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _alive(grandchild)


def test_run_without_a_card_fails_fast_and_leaves_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    t0 = time.monotonic()
    run = subprocess.Popen(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mibench-guest-sweep", "--seed", "0", "--seconds", "1",
         "--trace", "0"],
        cwd=ROOT, start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    out, err = run.communicate(timeout=120)
    assert run.returncode != 0
    assert "{" not in out
    assert "CUDA" in err
    assert time.monotonic() - t0 < 60
    assert _session(run.pid) == []
