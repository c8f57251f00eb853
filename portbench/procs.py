"""No process outlives a run.

A run is one process.  The only children it starts are one-shot helpers
(:func:`run_once`, ``subprocess.run`` with a timeout).  :class:`Guard`
turns ``SIGTERM`` and ``SIGINT`` into exceptions, so every exit path
unwinds through its ``__exit__``, which ends and waits on every child
the process still has.  The harness calls :func:`children` before it
prints its last line; a child still alive then makes the run incorrect.

Children are read from ``/proc/self/task/*/children``: every child of
every thread of this process, whoever started it.
"""
from __future__ import annotations

import glob
import os
import signal
import subprocess
import time
from typing import List, Optional, Sequence, Set


def children() -> Set[int]:
    """Pids of this process's children (a zombie not yet waited on
    counts)."""
    pids: Set[int] = set()
    for path in glob.glob("/proc/self/task/*/children"):
        try:
            with open(path) as f:
                pids.update(int(p) for p in f.read().split())
        except OSError:            # the thread ended while we read
            continue
    return pids


def _wait(pid: int, deadline: float) -> bool:
    """Wait on child ``pid`` until ``deadline``; True once it is reaped
    (or is not our child)."""
    while True:
        try:
            done, _ = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            return True
        if done == pid:
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)


def reap(pids: Optional[Sequence[int]] = None,
         grace_s: float = 2.0) -> List[int]:
    """End and wait on ``pids`` (default: every child): ``SIGTERM``, then
    ``SIGKILL`` after ``grace_s``.  Returns the pids that were running."""
    pids = sorted(children() if pids is None else pids)
    for pid in pids:
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + grace_s
    for pid in pids:
        if not _wait(pid, deadline):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            _wait(pid, time.monotonic() + grace_s)
    return pids


def run_once(cmd: Sequence[str], timeout_s: float = 10.0) -> Optional[str]:
    """Standard output of a one-shot helper, or None when it is missing,
    fails or overruns (``subprocess.run`` kills and waits on it then)."""
    try:
        out = subprocess.run(list(cmd), capture_output=True, text=True,
                             timeout=timeout_s, check=True,
                             stdin=subprocess.DEVNULL)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout


class Guard:
    """``with Guard():`` — signals become :class:`SystemExit` (code 128 +
    signal), and leaving the block, however, reaps every child."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __enter__(self) -> "Guard":
        self._old = {s: signal.signal(s, self._raise) for s in self.SIGNALS}
        return self

    @staticmethod
    def _raise(signum, frame):
        raise SystemExit(128 + signum)

    def __exit__(self, *exc) -> None:
        try:
            reap()
        finally:
            for s, h in self._old.items():
                signal.signal(s, h)
