"""Run loops of the port — counterpart of ``repro.core.hext.engine``.

An :class:`Engine` advances a batched ``HartState`` by up to ``max_ticks``
ticks and returns the final state.  Engines are resolved by name through
the registry (:func:`resolve`); any object with a ``run(state, max_ticks,
chunk=...)`` method is taken as an engine.  Four backends are registered:

* ``"eager"`` — :class:`TorchEngine`, a Python loop of
  ``machine.step_batched`` with the four batch-level gates read on the
  host (four syncs a tick).  It runs on any device and is the CPU's
  engine and the card's eager reference.
* ``"graph"`` — :class:`GraphEngine`, the counterpart of the reference's
  ``JitEngine``: ``instrs_per_step`` ticks of ``step_batched(...,
  gates="device")`` captured once as a CUDA graph and replayed, with one
  ``all(done)`` host read a chunk.  It runs only on a CUDA state.
* ``"oracle"`` — :class:`OracleEngine`, the pure-Python architectural
  oracle (:mod:`.oracle`) behind the same interface: the state comes to
  the host in one batched copy, each hart is stepped by ``oracle.step``,
  and the final states go back to the input's device.  The torture
  harness's reference leg.
* ``"sharded"`` — :class:`ShardedEngine`, the batch padded, split across
  devices and run on each device's default engine.

All keep the reference's semantics: the budget rounds up to whole
chunks, the run stops once every hart is done (the oracle: each hart on
its own), and done harts are frozen, so any extra ticks change nothing.
None writes into the caller's tensors.

:func:`diff_states` is the field-by-field architectural differential
compare of the reference (``DIFF_SCALARS``/``DIFF_COUNTERS``, every
register, CSR and memory word).
"""
from __future__ import annotations

import time
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core.hext import csr as C
from repro_torch.core.hext import machine as _machine
from repro_torch.core.hext import oracle as _oracle
from repro_torch.core.hext import tracing

__all__ = ["Engine", "TorchEngine", "GraphEngine", "OracleEngine",
           "ShardedEngine", "ENGINES",
           "register_engine", "resolve",
           "CapturedTicks",
           "diff_states", "diff_arrays", "state_arrays", "DIFF_SCALARS",
           "DIFF_COUNTERS"]

DIFF_SCALARS = ("pc", "priv", "virt", "halted", "done", "exit_code",
                "console")
DIFF_COUNTERS = ("instret", "instret_virt", "pagefaults", "walks",
                 "ticks", "timer_irqs", "ctx_switches")

# the eager loop reads ``done`` every this many ticks (done harts are
# frozen, so stopping between polls changes no state)
EAGER_POLL = 256
# ticks a graph replay advances: 1, 8 and 32 run at one rate on the
# H100 and capture time grows with it (PERF.md §6)
GRAPH_IPS = 1


def _n_chunks(max_ticks: int, chunk: int) -> int:
    """Tick budgets round UP to whole chunks (the reference's semantics)."""
    return -(-int(max_ticks) // int(chunk))


def _check_ips(chunk: int, ips: int) -> int:
    ips = int(ips)
    if ips < 1 or int(chunk) % ips != 0:
        raise ValueError(
            f"instrs_per_step must divide chunk: chunk={chunk} ips={ips}")
    return ips


# ---------------------------------------------------------------------------
# Engine protocol + registry
# ---------------------------------------------------------------------------

@runtime_checkable
class Engine(Protocol):
    """An execution backend: advance ``state`` by up to ``max_ticks``
    ticks and return the new state (the input is left as it was)."""

    name: str

    def run(self, state, max_ticks: int, chunk: int = 4096):
        ...


ENGINES: Dict[str, Callable[[], "Engine"]] = {}


def register_engine(name: str, factory: Callable[[], "Engine"]) -> None:
    """Register a backend under ``name`` (``Fleet.boot(..., engine=name)``)."""
    ENGINES[name] = factory


def resolve(engine: Any = None, device=None) -> "Engine":
    """None → the default engine for ``device``: ``"graph"`` on CUDA (and
    for ``None``, the port's default device), ``"eager"`` elsewhere;
    str → registry lookup; any object with a ``run`` method is taken as
    an engine instance."""
    if engine is None:
        dev = torch.device("cuda" if device is None else device)
        engine = "graph" if dev.type == "cuda" else "eager"
    if isinstance(engine, str):
        if engine not in ENGINES:
            raise ValueError(
                f"unknown engine {engine!r}; registered: "
                f"{sorted(ENGINES)}")
        return ENGINES[engine]()
    if callable(getattr(engine, "run", None)):
        return engine
    raise TypeError(f"engine must be None, a registered name, or an "
                    f"object with .run(state, max_ticks); got {engine!r}")


# ---------------------------------------------------------------------------
# TorchEngine — the eager loop, host gates
# ---------------------------------------------------------------------------

class TorchEngine:
    """Eager backend: ``step_batched`` with host gates on the state's
    device, ``all(done)`` read every :data:`EAGER_POLL` ticks.
    ``instrs_per_step`` is the reference's knob; here it only has to
    divide ``chunk``."""

    name = "eager"

    def __init__(self, instrs_per_step: int = 1):
        self._ips = int(instrs_per_step)

    def run(self, state, max_ticks: int, chunk: int = 4096):
        _check_ips(chunk, self._ips)
        raw = state.to_raw()
        total = _n_chunks(max_ticks, chunk) * int(chunk)
        with torch.no_grad():
            for t in range(total):
                if t % EAGER_POLL == 0 and bool(raw["done"].all()):
                    break
                raw = _machine.step_batched(raw)
        return type(state).from_raw(raw)


# ---------------------------------------------------------------------------
# GraphEngine — a chunk of ticks as replays of one captured CUDA graph
# ---------------------------------------------------------------------------

def _clone(raw: Dict) -> Dict:
    return {k: ({j: u.clone() for j, u in v.items()}
                if isinstance(v, dict) else v.clone())
            for k, v in raw.items()}


def _copy_into(dst: Dict, src: Dict) -> None:
    """Copy every leaf of ``src`` into ``dst``'s, skipping a leaf that
    already is ``dst``'s tensor (the in-place store's memory)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        elif v is not dst[k]:
            dst[k].copy_(v)


def _ticks(raw: Dict, n: int, store: str = "copy") -> Dict:
    for _ in range(n):
        raw = _machine.step_batched(raw, gates="device", store=store)
    return raw


def _tick_body(static: Dict, ips: int) -> None:
    """What a graph captures: ``ips`` device-gated ticks of ``static``,
    each storing into ``static["mem"]`` in place (the next tick reads it
    there), and the copy of the other new leaves back into ``static``,
    under the stage spans."""
    with tracing.span("hext.tick"):
        new = _ticks(static, ips, store="inplace")
        with tracing.span("hext.graph.copy_back"):
            _copy_into(static, new)


class CapturedTicks:
    """``ips`` device-gated ticks captured as one CUDA graph over the
    static state buffers ``static``: each tick stores into
    ``static["mem"]`` in place, and the captured ticks end by copying the
    other new leaves into their buffers, so each :meth:`replay` advances
    them by ``ips`` ticks.  The warm-up tick before the capture stores out
    of place, so it leaves ``static`` as it was.  ``capture_s`` is the
    wall time of warm-up + capture.

    The tick's stage spans (``hext.tick`` over the whole body, its
    stages, ``hext.graph.copy_back``) record timing events into the graph
    (``stages``, a :class:`tracing.Capture`), so every replay times each
    stage."""

    def __init__(self, raw: Dict, ips: int):
        t0 = time.perf_counter()
        dev = raw["pc"].device
        with torch.no_grad():
            self.static = _clone(raw)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                # warm-up: builds the lazily cached device constants
                # (bits.device_const, csr/decode tables, trap priorities)
                # off the capture, where a host→device copy is not allowed;
                # out of place, so ``static`` does not advance
                _ticks(self.static, 1)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            self.stages = tracing.Capture(ips)
            with torch.cuda.graph(self.graph), self.stages:
                _tick_body(self.static, ips)
        torch.cuda.synchronize(dev)
        self.ips = ips
        # whether the latest replay ran with tracing off (GraphEngine.run)
        self.untraced = False
        self.capture_s = time.perf_counter() - t0

    def load(self, raw: Dict) -> None:
        """Copy a state into the static buffers, memory included."""
        _copy_into(self.static, raw)

    def replay(self) -> None:
        self.graph.replay()

    def state(self) -> Dict:
        """A copy of the static buffers (aliases nothing of the cache)."""
        return _clone(self.static)


class GraphEngine:
    """CUDA-graph backend, the counterpart of the reference's ``JitEngine``.

    ``instrs_per_step`` ticks of ``step_batched(..., gates="device")`` are
    captured once per (device, batch, mem_words, ips) and kept by the
    engine (a fleet's engine, or one shared by fleets of one shape), then
    replayed ``chunk // ips`` times a chunk;
    ``all(done)`` is read on the host once a chunk, the run's only sync.
    The state is copied into the static buffers at the start of a run and
    out at its end, so what ``run`` returns aliases nothing of the cache
    and nothing the caller holds changes.  A capture or launch failure
    raises; there is no fallback to the eager engine.  While tracing is
    on, a run whose graph was last replayed with tracing off takes that
    replay as one sample of the stage table, after its first read."""

    name = "graph"

    def __init__(self, instrs_per_step: int = GRAPH_IPS):
        self._ips = int(instrs_per_step)
        self._graphs: Dict[tuple, CapturedTicks] = {}
        self.last_capture_s = 0.0

    @property
    def n_graphs(self) -> int:
        """Graphs this engine has captured and holds."""
        return len(self._graphs)

    def run(self, state, max_ticks: int, chunk: int = 4096):
        ips = _check_ips(chunk, self._ips)
        if state.device.type != "cuda":
            raise ValueError(
                f"GraphEngine runs only on a CUDA state, got one on "
                f"{state.device}; use engine='eager' on the CPU")
        raw = state.to_raw()
        mem = raw["mem"]
        key = (mem.device, int(mem.shape[0]), int(mem.shape[1]), ips)
        if key not in self._graphs:
            self._graphs[key] = CapturedTicks(raw, ips)
        g = self._graphs[key]
        self.last_capture_s = g.capture_s
        g.load(raw)
        done = g.static["done"]
        traced = tracing.enabled()
        replayed = False
        for _ in range(_n_chunks(max_ticks, chunk)):
            if bool(done.all()):
                break
            if traced and not replayed and g.untraced:
                # the read above waited for the graph's latest replay,
                # made with tracing off: its stage events are a sample
                tracing.TRACER.sample(g.stages)
            for _ in range(int(chunk) // ips):
                g.replay()
            replayed = True
        if replayed:
            g.untraced = not traced
        return type(state).from_raw(g.state())


# ---------------------------------------------------------------------------
# OracleEngine — the pure-Python reference model as a backend
# ---------------------------------------------------------------------------

_U64_LEAVES = ("pc", "regs", "csrs", "mem", "exit_code")


def _snapshot_row(arrs: Dict, i: int) -> Dict[str, Any]:
    """Hart ``i`` of the host arrays of :func:`state_arrays` as the
    oracle's plain-Python snapshot (uint64 leaves as non-negative ints)."""
    t = arrs["tlb"]
    snap = {k: arrs[k][i].tolist() for k in arrs if k != "tlb"}
    snap["tlb"] = {k: v[i].tolist() for k, v in t.items()}
    return snap


def _adopt_row(osts: List[Dict]) -> Dict[str, Any]:
    """Oracle final states → the reference's raw-dict layout (numpy, with
    its dtypes) for ``HartState.from_numpy`` on ``device``.  Python ints
    of 2**63 or more become int64 bit patterns through uint64."""
    def u64(key, src=None):
        return np.array([(o if src is None else o[src])[key] for o in osts],
                        dtype=np.uint64)

    def i64(key, src=None):
        return u64(key, src).view(np.int64)

    def flag(key, src=None):
        return np.array([(o if src is None else o[src])[key] for o in osts],
                        dtype=bool)

    raw = {k: u64(k) for k in _U64_LEAVES}
    raw.update({k: i64(k) for k in ("priv", "console", "exc_by_level",
                                    "int_by_level") + DIFF_COUNTERS})
    raw.update({k: flag(k) for k in ("virt", "halted", "done")})
    raw["tlb"] = {k: u64(k, "tlb") for k in ("vpn", "ppn")}
    raw["tlb"].update({k: i64(k, "tlb")
                       for k in ("level", "perm", "priv", "ptr")})
    raw["tlb"].update({k: flag(k, "tlb")
                       for k in ("guest", "sum", "mxr", "valid")})
    return raw


class OracleEngine:
    """The pure-Python architectural oracle behind the Engine interface.

    The state comes to the host in one batched copy (:func:`state_arrays`),
    each hart is stepped by ``oracle.step`` for the same rounded-up budget
    the device engines run (``_n_chunks(max_ticks, chunk) * chunk`` ticks,
    each hart stopping on ``done``), and the final states go back to the
    input's device in one copy per leaf.  The oracle models the software
    TLB and ``walks`` bit-exactly, so every leaf is diffable.

    After :meth:`run`, ``last_events`` holds one frozenset of
    architectural-event tuples per hart (trap / fence / atp / wfi
    signatures) — the torture harness's coverage buckets.  Events are
    never part of the differential comparison."""

    name = "oracle"

    def __init__(self):
        self.last_events: List[frozenset] = []

    def run(self, state, max_ticks: int, chunk: int = 4096):
        total = _n_chunks(max_ticks, chunk) * int(chunk)
        arrs = state_arrays(state)
        outs = []
        for i in range(state.batch):
            ost = _oracle.resume_state(_snapshot_row(arrs, i))
            for _ in range(total):
                if ost["done"]:
                    break
                _oracle.step(ost)
            outs.append(ost)
        self.last_events = [frozenset(o.get("events", ())) for o in outs]
        return type(state).from_numpy(_adopt_row(outs),
                                      device=state.device)


# ---------------------------------------------------------------------------
# ShardedEngine — the batch split across devices
# ---------------------------------------------------------------------------

def _default_engine(device, ips: int):
    return (GraphEngine if torch.device(device).type == "cuda"
            else TorchEngine)(instrs_per_step=ips)


class ShardedEngine:
    """Data-parallel backend: shard the hart batch across ``devices``
    (default: every CUDA device for a CUDA state, the state's device
    otherwise).

    The batch is padded to a device multiple by repeating harts with
    ``done=True`` (frozen, and invisible to each shard's ``all(done)``
    stop), split into contiguous shards, each run on its device's default
    engine (graph on CUDA, eager on the CPU; the shards run one after
    another), then concatenated on the input's device with the padding
    cut off.  Harts are independent, so counters are bit-identical to one
    device's run.  With one device, or one hart, it is that device's
    default engine.  Each device's engine is kept, with its graphs."""

    name = "sharded"

    def __init__(self, devices: Optional[list] = None,
                 instrs_per_step: int = 1):
        self._devices = devices
        self._ips = int(instrs_per_step)
        self._engines: Dict[torch.device, Any] = {}

    def _engine(self, dev: torch.device):
        if dev not in self._engines:
            self._engines[dev] = _default_engine(dev, self._ips)
        return self._engines[dev]

    def _shard(self, state, dev, max_ticks, chunk):
        return self._engine(dev).run(state.to(dev), max_ticks, chunk) \
            .to(state.device)

    def run(self, state, max_ticks: int, chunk: int = 4096):
        _check_ips(chunk, self._ips)
        if self._devices is not None:
            devs = [torch.device(d) for d in self._devices]
        elif state.device.type == "cuda":
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        else:
            devs = [state.device]
        b = state.batch
        if len(devs) < 2 or b < 2:
            return self._shard(state, devs[0], max_ticks, chunk)
        d = min(len(devs), b)
        per = -(-b // d)
        idx = torch.arange(per * d, device=state.device) % b

        def pad(raw):
            return {k: pad(v) if isinstance(v, dict) else v[idx]
                    for k, v in raw.items()}

        raw = pad(state.to_raw())
        raw["done"][b:] = True
        padded = type(state).from_raw(raw)

        def part(raw, k):
            return {j: part(v, k) if isinstance(v, dict)
                    else v[k * per:(k + 1) * per] for j, v in raw.items()}

        outs = [self._shard(type(state).from_raw(part(padded.to_raw(), k)),
                            devs[k], max_ticks, chunk).to_raw()
                for k in range(d)]

        def join(parts):
            if isinstance(parts[0], dict):
                return {j: join([p[j] for p in parts]) for j in parts[0]}
            return torch.cat(parts)[:b]

        return type(state).from_raw(join(outs))


register_engine("eager", TorchEngine)
register_engine("graph", GraphEngine)
register_engine("oracle", OracleEngine)
register_engine("sharded", ShardedEngine)


# ---------------------------------------------------------------------------
# differential compare
# ---------------------------------------------------------------------------

def state_arrays(state) -> Dict[str, np.ndarray]:
    """Host arrays of a batched ``HartState`` shaped for :func:`diff_arrays`
    (the reference's names and dtypes, leading hart dimension)."""
    return state.to_numpy()


def diff_arrays(a: Dict[str, np.ndarray], i: int,
                b: Dict[str, np.ndarray], j: int,
                compare_mem: bool = True) -> List[str]:
    """Field-by-field architectural diff of hart ``i`` of raw numpy dict
    ``a`` against hart ``j`` of ``b`` (``HartState.to_numpy`` layout, which
    is also the reference's raw-dict layout)."""
    d: List[str] = []

    def chk(name, x, y):
        if int(x) != int(y):
            d.append(f"{name}: a={int(x):#x} b={int(y):#x}")

    for k in DIFF_SCALARS + DIFF_COUNTERS:
        chk(k, a[k][i], b[k][j])
    for r in range(1, 32):
        chk(f"x{r}", a["regs"][i, r], b["regs"][j, r])
    for idx in range(C.N_CSR):
        chk(f"csr[{idx}]", a["csrs"][i, idx], b["csrs"][j, idx])
    for lvl, nm in enumerate(("M", "HS", "VS")):
        chk(f"exc@{nm}", a["exc_by_level"][i, lvl],
            b["exc_by_level"][j, lvl])
        chk(f"int@{nm}", a["int_by_level"][i, lvl],
            b["int_by_level"][j, lvl])
    if compare_mem:
        ma, mb = a["mem"][i], b["mem"][j]
        bad = np.nonzero(ma != mb)[0]
        if bad.size:
            w = int(bad[0])
            d.append(f"mem[{w * 8:#x}]: a={int(ma[w]):#x} "
                     f"b={int(mb[w]):#x} (+{bad.size - 1} more words)")
    return d


def diff_states(a, b, i: int = 0, j: int = 0,
                compare_mem: bool = True) -> List[str]:
    """Diff hart ``i`` of ``HartState`` ``a`` against hart ``j`` of ``b``:
    pc / x1..x31 / the full CSR file / priv / virt / halted / done /
    exit_code / console / memory / every counter."""
    return diff_arrays(state_arrays(a), i, state_arrays(b), j,
                       compare_mem=compare_mem)
