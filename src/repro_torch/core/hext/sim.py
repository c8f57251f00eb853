"""Typed simulation API of the port: ``HartState`` + ``Fleet`` —
counterpart of ``repro.core.hext.sim``.

* ``HartState`` — a dataclass of tensors with a leading hart dimension B
  (pc/regs/csrs/mem/tlb and a nested :class:`Counters` record).
  ``to_raw``/``from_raw`` bridge to the raw dict ``machine`` computes on;
  ``from_numpy``/``to_numpy`` carry state across from and to the JAX
  package's raw-dict layout (numpy arrays, uint64 leaves), which is how
  one state is put through both packages.
* ``Fleet`` — ``Fleet.boot(workloads, guest=...)`` assembles system
  images and batches them (``from_states`` / ``from_images`` /
  ``from_corpus`` batch pre-built states or raw images, the torture
  corpus among them), ``fleet.run(max_ticks)`` advances every machine in
  lockstep through its engine (``engine.resolve``: ``"graph"`` on a CUDA
  fleet, ``"eager"`` on a CPU fleet, unless the caller names one),
  ``fleet.counters()`` / ``fleet.report()`` read the paper's counters
  back out, ``fleet.snapshot`` / ``Fleet.restore`` write and read the
  reference's checkpoint format (:mod:`.checkpoint`), and
  ``migrate_guest`` / ``park_guest`` / ``resume_guest`` / ``replace_hart``
  are the control plane's guest and lane operations.  A guest operation
  reads the few words its preconditions need in one small host copy and
  moves the guest's regions with device-side slice copies; only a park or
  a resume moves those regions through the host (the checkpoint file).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.hext import engine as _engine
from repro_torch.core.hext import machine as _machine
from repro_torch.core.hext import programs
from repro_torch.core.hext import tracing
from repro_torch.device import resolve

MASK64 = (1 << 64) - 1

__all__ = ["Counters", "HartState", "Fleet", "HartSpec", "checksum_ok",
           "run_on_device", "StaleHartsError", "MigrationError"]


def checksum_ok(exit_code, golden: int) -> bool:
    """Canonical result check: compare exit code and golden mod 2**64."""
    return (int(exit_code) & MASK64) == (int(golden) & MASK64)


_COUNTER_KEYS = ("done", "exit_code", "instret", "instret_virt",
                 "exc_by_level", "int_by_level", "pagefaults", "walks",
                 "ticks", "timer_irqs", "ctx_switches")
_STATE_KEYS = ("pc", "regs", "csrs", "priv", "virt", "mem", "halted",
               "console")

# the reference's raw-dict dtypes (everything is int64 or bool here)
_U64_KEYS = ("pc", "regs", "csrs", "mem", "exit_code")
_I32_KEYS = ("priv",)
_TLB_U64 = ("vpn", "ppn")
_TLB_I32 = ("level", "perm", "priv", "ptr")


def _words(image) -> np.ndarray:
    """A uint64-word image (numpy, a sequence of ints or an int64 tensor
    of bit patterns) as int64 bit patterns."""
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().numpy().astype(np.int64)
    return np.asarray(image, dtype=np.uint64).view(np.int64)


@dataclasses.dataclass(frozen=True)
class Counters:
    """Architectural counters + run outcome (one hart, or a batch).

    instret / instret_virt — Fig 5 (instructions w/ and w/o VM)
    exc_by_level[3] / int_by_level[3] — Figs 6/7 (M, HS, VS)
    pagefaults, walks — translation activity; ticks — Fig 4 time proxy
    timer_irqs / ctx_switches — preemption activity
    done / exit_code — run outcome (checksum mailbox)
    """

    done: torch.Tensor
    exit_code: torch.Tensor
    instret: torch.Tensor
    instret_virt: torch.Tensor
    exc_by_level: torch.Tensor
    int_by_level: torch.Tensor
    pagefaults: torch.Tensor
    walks: torch.Tensor
    ticks: torch.Tensor
    timer_irqs: torch.Tensor
    ctx_switches: torch.Tensor

    def ok(self, golden: int) -> bool:
        return checksum_ok(self.exit_code, golden)

    def to_dict(self, golden: Optional[int] = None) -> Dict[str, Any]:
        """Host-side dict (JSON-safe) — the benchmark record shape of
        ``benchmarks/results/hext_runs.json``."""
        out = {
            "done": bool(self.done),
            "exit_code": int(self.exit_code) & MASK64,
            "instret": int(self.instret),
            "instret_virt": int(self.instret_virt),
            "ticks": int(self.ticks),
            "exc_by_level": [int(x) for x in self.exc_by_level],
            "int_by_level": [int(x) for x in self.int_by_level],
            "pagefaults": int(self.pagefaults),
            "walks": int(self.walks),
            "timer_irqs": int(self.timer_irqs),
            "ctx_switches": int(self.ctx_switches),
        }
        if golden is not None:
            out["ok"] = self.ok(golden)
        return out


@dataclasses.dataclass(frozen=True)
class HartState:
    """Full architectural state of a batch of harts (leading dim B).

    ``tlb`` is the software-TLB dict (see ``tlb.init_tlb``); ``counters``
    is the nested :class:`Counters` record."""

    pc: torch.Tensor
    regs: torch.Tensor
    csrs: torch.Tensor
    priv: torch.Tensor
    virt: torch.Tensor
    mem: torch.Tensor
    tlb: Dict[str, torch.Tensor]
    halted: torch.Tensor
    console: torch.Tensor
    counters: Counters

    # -- construction -------------------------------------------------------
    @classmethod
    def fresh(cls, mem_words: int = _machine.DEFAULT_MEM_WORDS,
              batch: int = 1, device=None) -> "HartState":
        """Power-on state: pc=0, M mode, zeroed memory and counters."""
        return cls.from_raw(_machine._make_state(mem_words, batch,
                                                 resolve(device)))

    @classmethod
    def boot(cls, workload, guest: bool = False, device=None) -> "HartState":
        """One hart with the full bootable system image for ``workload``
        (native M→S stack, or M→HS xvisor-lite→VS when ``guest``)."""
        image = programs.build_image(workload, guest)
        return cls.fresh(programs.MEM_WORDS, device=device).with_mem(image)

    @classmethod
    def boot_preemptive(cls, *workloads, timeslice: Optional[int] = None,
                        device=None) -> "HartState":
        """One hart running N guest VMs under the preemptive HS scheduler
        (memory sized per N by ``programs.sched_layout``)."""
        ts = programs.DEFAULT_TIMESLICE if timeslice is None else \
            int(timeslice)
        image = programs.build_image_nguest(workloads, timeslice=ts)
        return cls.fresh(int(image.shape[0]), device=device).with_mem(image)

    @classmethod
    def stack(cls, states: Sequence["HartState"]) -> "HartState":
        """Concatenate batches along the hart dimension."""
        if not states:
            raise ValueError("need at least one hart state")
        raws = [s.to_raw() for s in states]

        def cat(key, sub=None):
            return torch.cat([r[key] if sub is None else r[key][sub]
                              for r in raws])

        raw = {k: cat(k) for k in raws[0] if k != "tlb"}
        raw["tlb"] = {k: cat("tlb", k) for k in raws[0]["tlb"]}
        return cls.from_raw(raw)

    # -- raw-dict bridge ------------------------------------------------------
    @classmethod
    def from_raw(cls, raw) -> "HartState":
        return cls(**{k: raw[k] for k in _STATE_KEYS}, tlb=raw["tlb"],
                   counters=Counters(**{k: raw[k] for k in _COUNTER_KEYS}))

    def to_raw(self) -> Dict[str, Any]:
        raw = {k: getattr(self, k) for k in _STATE_KEYS}
        raw["tlb"] = self.tlb
        raw.update({k: getattr(self.counters, k) for k in _COUNTER_KEYS})
        return raw

    # -- carrying state across from/to the reference's raw-dict layout ------
    @classmethod
    def from_numpy(cls, raw: Dict[str, Any], device=None) -> "HartState":
        """Build from the JAX package's raw-dict layout (``machine.
        _make_state`` keys, numpy arrays; uint64 leaves are read as their
        int64 bit patterns).  A leading hart dimension is added when the
        dict holds a single hart (``pc`` is 0-d)."""
        dev = resolve(device)
        single = np.ndim(raw["pc"]) == 0

        def conv(x):
            a = np.asarray(x)
            if a.dtype == np.uint64:
                a = a.view(np.int64)
            elif a.dtype != np.bool_:
                a = a.astype(np.int64)
            if single:
                a = a[None]
            # a copy: the source (e.g. a JAX array's view) may be read-only
            return torch.as_tensor(np.array(a), device=dev)

        out = {k: conv(v) for k, v in raw.items() if k != "tlb"}
        out["tlb"] = {k: conv(v) for k, v in raw["tlb"].items()}
        return cls.from_raw(out)

    def to_numpy(self) -> Dict[str, Any]:
        """The reference's raw-dict layout as numpy arrays with its dtypes
        (uint64 / int32 / bool / int64), keeping the hart dimension."""
        def conv(t, key_u64, key_i32):
            a = t.detach().cpu().numpy()
            if key_u64:
                return a.view(np.uint64)
            if key_i32:
                return a.astype(np.int32)
            return a

        raw = self.to_raw()
        out = {k: conv(v, k in _U64_KEYS, k in _I32_KEYS)
               for k, v in raw.items() if k != "tlb"}
        out["tlb"] = {k: conv(v, k in _TLB_U64, k in _TLB_I32)
                      for k, v in raw["tlb"].items()}
        return out

    # -- functional updates ---------------------------------------------------
    def replace(self, **kw) -> "HartState":
        return dataclasses.replace(self, **kw)

    def with_mem(self, mem) -> "HartState":
        """Replace memory with a uint64-word image ((W,) for every hart or
        (B, W))."""
        img = torch.as_tensor(np.ascontiguousarray(mem).view(np.int64),
                              device=self.mem.device)
        return self.replace(mem=img.expand(self.batch, -1).clone())

    def or_image(self, image, base: int = 0) -> "HartState":
        """OR a uint64-word image into every hart's memory at byte address
        ``base`` (a merge, unlike :meth:`with_mem`: the semantics test
        harnesses want when layering fragments onto a zeroed machine)."""
        img = torch.as_tensor(_words(image), device=self.mem.device)
        w = base >> 3
        mem = self.mem.clone()
        mem[..., w:w + img.shape[-1]] |= img
        return self.replace(mem=mem)

    def to(self, device) -> "HartState":
        """Every leaf on ``device`` (the state itself if already there)."""
        dev = torch.device(device)
        if self.device == dev:
            return self

        def move(raw):
            return {k: move(v) if isinstance(v, dict) else v.to(dev)
                    for k, v in raw.items()}

        return HartState.from_raw(move(self.to_raw()))

    @property
    def batch(self) -> int:
        return int(self.pc.shape[0])

    @property
    def device(self) -> torch.device:
        return self.pc.device

    def step(self) -> "HartState":
        """One tick of the whole batch."""
        return HartState.from_raw(_machine.step_batched(self.to_raw()))


# ---------------------------------------------------------------------------
# run_on_device — the default engine of the state's device
# ---------------------------------------------------------------------------

def run_on_device(state: HartState, max_ticks: int, chunk: int = 4096,
                  donate: bool = True) -> HartState:
    """Run until every hart is done or ``max_ticks`` elapse (rounded up to
    whole chunks) on the default engine of the state's device.

    ``donate`` is the reference's signature and changes nothing here: the
    port never writes into the caller's tensors, so ``state`` stays valid
    after the call either way."""
    del donate
    return _engine.resolve(None, state.device).run(state, max_ticks, chunk)


def _gi_done_word(lay, guest: int) -> int:
    """Word index of slot ``guest``'s ginfo done flag."""
    return (lay.ginfo0 + guest * programs.GINFO_SIZE + 24) >> 3


# ---------------------------------------------------------------------------
# Fleet — the simulation facade
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HartSpec:
    """What one fleet slot is running (for labels and golden checks).

    A preemptive slot carries the full guest tuple in ``guests`` (N ≥ 1;
    ``workload`` aliases guest 0) and the scheduler timeslice."""
    workload: Optional[Any]
    guest: bool
    name: str
    guests: Optional[tuple] = None
    timeslice: int = 0

    @property
    def preemptive(self) -> bool:
        return self.guests is not None

    @property
    def label(self) -> str:
        if self.preemptive:
            return f"{self.name}/{len(self.guests)}guest-preempt"
        return f"{self.name}/{'guest' if self.guest else 'native'}"


class StaleHartsError(RuntimeError):
    """A ``fleet.harts`` reference was used after a later ``fleet.run``
    (or guest operation) replaced the state it viewed."""


class MigrationError(RuntimeError):
    """A guest-operation precondition does not hold (wrong slot kind,
    guest currently scheduled, hart already exited, ...)."""


class _HartsView:
    """Generation-checked view of the fleet's batched ``HartState``.

    ``fleet.run`` replaces the fleet's state, so a reference taken before a
    run would silently read the old one.  The view forwards attribute
    access to the live state while its generation matches, and raises
    :class:`StaleHartsError` afterwards."""

    __slots__ = ("_fleet", "_gen")

    def __init__(self, fleet: "Fleet", gen: int):
        object.__setattr__(self, "_fleet", fleet)
        object.__setattr__(self, "_gen", gen)

    def _live(self) -> HartState:
        if self._fleet._generation != self._gen:
            raise StaleHartsError(
                f"this fleet.harts reference is stale: it was taken at "
                f"run-generation {self._gen} but the fleet is now at "
                f"generation {self._fleet._generation} — re-read "
                f"fleet.harts after each run")
        return self._fleet._harts

    def unwrap(self) -> HartState:
        """The underlying ``HartState`` (generation-checked)."""
        return self._live()

    def __getattr__(self, name):
        return getattr(self._live(), name)

    def __repr__(self):
        return f"<harts view gen={self._gen} of {self._fleet!r}>"


class Fleet:
    """A batch of harts simulated in lockstep on one device.

    >>> fleet = Fleet.boot(programs.WORKLOADS, guest=False)
    >>> fleet.run(30_000)
    >>> fleet.report()["crc32/native"]["ok"]
    True

    ``engine`` is a registered name (``"graph"``, ``"eager"``) or an object
    with ``run(state, max_ticks, chunk)``; ``None`` takes the default of
    the fleet's device, resolved once here.
    """

    def __init__(self, harts: HartState, specs: Sequence[HartSpec],
                 engine: Any = None):
        if harts.batch != len(specs):
            raise ValueError(f"{len(specs)} specs for {harts.batch} harts")
        self._harts = harts
        self._specs = list(specs)
        self._engine = _engine.resolve(engine, harts.device)
        self._generation = 0

    @classmethod
    def boot(cls, workloads, guest: Union[bool, Sequence[bool]] = False,
             guests_per_hart: int = 1, timeslice: Optional[int] = None,
             device=None, engine: Any = None) -> "Fleet":
        """Assemble + batch bootable machines, one per workload.

        ``guest`` is a bool applied fleet-wide or a per-slot sequence.
        ``guests_per_hart=N`` (N ≥ 2, or N=1 with an explicit
        ``timeslice``) boots the preemptive multi-guest images: each slot
        runs N guest VMs under the HS scheduler; a slot entry is a single
        workload (all N guests run it) or a length-N tuple.  ``device``
        defaults to ``cuda``; ``engine`` as in :class:`Fleet`."""
        dev = resolve(device)
        wls = list(workloads) if isinstance(workloads, (list, tuple)) \
            else [workloads]
        n = int(guests_per_hart)
        if n < 1:
            raise ValueError(f"guests_per_hart must be >= 1, got {n}")
        if n >= 2 or timeslice is not None:
            if guest is not False:
                raise ValueError(
                    "guest= does not apply with a preemptive boot "
                    "(every slot runs VS guests under the scheduler)")
            ts = programs.DEFAULT_TIMESLICE if timeslice is None else \
                int(timeslice)
            groups = []
            for i, w in enumerate(wls):
                grp = tuple(w) if isinstance(w, (tuple, list)) else (w,) * n
                if len(grp) != n:
                    raise ValueError(
                        f"slot {i}: expected a workload or a length-{n} "
                        f"tuple, got {len(grp)} entries")
                groups.append(grp)
            specs = [HartSpec(g[0], True,
                              "+".join(w.name if w is not None else "~"
                                       for w in g),
                              guests=g, timeslice=ts) for g in groups]
            states = [HartState.boot_preemptive(*g, timeslice=ts, device=dev)
                      for g in groups]
            return cls(HartState.stack(states), specs, engine=engine)
        guests = list(guest) if isinstance(guest, (list, tuple)) \
            else [bool(guest)] * len(wls)
        if len(guests) != len(wls):
            raise ValueError(
                f"guest has {len(guests)} entries for {len(wls)} workloads")
        specs = [HartSpec(w, g, w.name) for w, g in zip(wls, guests)]
        states = [HartState.boot(w, guest=g, device=dev)
                  for w, g in zip(wls, guests)]
        return cls(HartState.stack(states), specs, engine=engine)

    @classmethod
    def from_states(cls, states: Sequence[HartState],
                    specs: Optional[Sequence[HartSpec]] = None,
                    engine: Any = None) -> "Fleet":
        """Fleet over pre-built states (each a batch of one or more harts,
        all on one device), stacked in order."""
        states = list(states)
        harts = states[0] if len(states) == 1 else HartState.stack(states)
        if specs is None:
            specs = [HartSpec(None, False, f"hart{i}")
                     for i in range(harts.batch)]
        return cls(harts, specs, engine=engine)

    @classmethod
    def from_images(cls, images: Sequence[Any],
                    mem_words: int = _machine.DEFAULT_MEM_WORDS,
                    names: Optional[Sequence[str]] = None,
                    engine: Any = None, device=None) -> "Fleet":
        """Fleet of fresh harts, each booted from a raw uint64-word image
        (shorter images are zero-padded; an oversized one is an error).
        The images go to ``device`` (default ``cuda``) in one copy."""
        imgs = [_words(im) for im in images]
        if not imgs:
            raise ValueError("Fleet needs at least one hart")
        mem = np.zeros((len(imgs), int(mem_words)), dtype=np.int64)
        for i, im in enumerate(imgs):
            if int(im.shape[0]) > mem_words:
                raise ValueError(
                    f"image {i} has {int(im.shape[0])} words > "
                    f"mem_words={mem_words}")
            mem[i, :im.shape[0]] = im
        state = HartState.fresh(int(mem_words), batch=len(imgs),
                                device=device).or_image(mem)
        specs = None if names is None else \
            [HartSpec(None, False, str(n)) for n in names]
        return cls.from_states([state], specs, engine=engine)

    @classmethod
    def from_corpus(cls, images: Sequence[Any],
                    names: Optional[Sequence[str]] = None,
                    mem_words: Optional[int] = None,
                    engine: Any = None, device=None) -> "Fleet":
        """Batch a scenario corpus (possibly differently sized images) as
        ONE fleet: every image is zero-padded to a common word count, so
        the whole corpus runs as one batch (one captured graph on the
        card) — the batched-fuzz mode of the torture harness.
        ``mem_words`` defaults to the largest image rounded up to a power
        of two."""
        if not len(images):
            raise ValueError("from_corpus needs at least one image")
        if mem_words is None:
            m = max(len(im) for im in images)
            mem_words = 1 << max(m - 1, 1).bit_length()
        if names is None:
            names = [f"case{i}" for i in range(len(images))]
        return cls.from_images(images, mem_words, names=names,
                               engine=engine, device=device)

    # -- running --------------------------------------------------------------
    def run(self, max_ticks: int, chunk: int = 4096) -> "Fleet":
        """Advance the whole fleet until every hart is done or the tick
        budget (rounded up to whole chunks) is spent.  Bumps the run
        generation: every earlier ``fleet.harts`` view goes stale."""
        self._harts = self._engine.run(self._harts, max_ticks, chunk=chunk)
        self._generation += 1
        return self

    # -- gem5-style checkpoint / restore ------------------------------------
    def snapshot(self, path) -> str:
        """Write the whole fleet state as a versioned ``.npz`` checkpoint
        in the reference's layout (:mod:`.checkpoint`); a restored fleet
        runs on bit-identically to one that was never stopped."""
        from repro_torch.core.hext import checkpoint
        return checkpoint.save(
            str(path), self._harts, self._specs,
            engine_name=getattr(self._engine, "name", "custom"))

    @classmethod
    def restore(cls, path, specs: Optional[Sequence[HartSpec]] = None,
                engine: Any = None, device=None) -> "Fleet":
        """Rebuild a fleet from a :meth:`snapshot` checkpoint (the
        reference's files too) on ``device`` (default ``cuda``).

        Specs are restored by workload name via the standard registry;
        pass ``specs=`` when the snapshot ran workloads the registry cannot
        resolve.  Raises ``checkpoint.CheckpointError`` on corrupted or
        schema-incompatible files."""
        from repro_torch.core.hext import checkpoint
        harts, saved = checkpoint.load(str(path), decode_specs=specs is None,
                                       device=device)
        specs = list(saved if specs is None else specs)
        if len(specs) != harts.batch:
            raise ValueError(
                f"{len(specs)} specs for {harts.batch} restored harts")
        return cls(harts, specs, engine=engine)

    # -- live guest migration, park / resume, lane replacement ---------------
    def _guest_words(self, harts: Sequence[int], guest: int,
                     lay) -> Dict[int, Dict[str, int]]:
        """``done``, ``virt``, the ``SCHED_CUR`` word and slot ``guest``'s
        ginfo done word of each hart in ``harts``, in one host copy."""
        h = self._harts
        rows = torch.tensor(list(harts), device=h.device)
        cols = torch.tensor([programs.SCHED_CUR >> 3,
                             _gi_done_word(lay, guest)], device=h.device)
        words = torch.cat([h.counters.done[rows, None].long(),
                           h.virt[rows, None].long(),
                           h.mem[rows[:, None], cols[None, :]]], 1)
        return {i: dict(zip(("done", "virt", "cur", "gdone"), row))
                for i, row in zip(harts, words.cpu().tolist())}

    @staticmethod
    def _check_guest_op(w: Dict[str, int], hart: int, guest: int,
                        verb: str) -> None:
        """Shared precondition: the hart is paused while executing guest
        code and slot ``guest`` is not currently scheduled.  Paused in M
        firmware or inside the HS scheduler, a context switch may be in
        flight (target chosen but ``SCHED_CUR`` not yet updated), so
        neither ``SCHED_CUR`` nor the context slots are authoritative."""
        if w["done"]:
            raise MigrationError(f"hart {hart} has already exited")
        if not w["virt"]:
            raise MigrationError(
                f"hart {hart} is not executing guest code (V=0 — "
                f"possibly mid context-switch); run a little longer "
                f"and retry")
        if w["cur"] == guest:
            raise MigrationError(
                f"guest {guest} is currently scheduled on hart {hart}; "
                f"{verb} only descheduled guests (run a little longer "
                f"and retry)")

    def _preemptive_spec(self, hart: int) -> HartSpec:
        if not (0 <= hart < len(self._specs)):
            raise MigrationError(f"hart {hart} out of range")
        spec = self._specs[hart]
        if not spec.preemptive:
            raise MigrationError(
                f"hart {hart} ({spec.label}) is not a preemptive "
                f"multi-guest slot")
        return spec

    def _set_mem(self, mem: torch.Tensor) -> None:
        self._harts = self._harts.replace(mem=mem)
        self._generation += 1          # invalidate handed-out views

    def migrate_guest(self, src: int, dst: int, guest: int = 0) -> "Fleet":
        """Move a descheduled guest VM from hart ``src`` to hart ``dst``.

        Copies guest slot ``guest``'s migratable state — saved context
        (GPRs, sepc, the VS CSR bank, the frozen virtual clock), private
        G-stage table block, 64 KiB window, result mailbox and scheduler
        info block (``programs.guest_regions``) — to the same addresses on
        the destination, as device-side slice copies.  The destination's
        scheduler picks the guest up at its next switch and resumes it
        mid-flight.  On the source the slot is marked done with a zeroed
        mailbox, and both specs are updated so ``report()`` checks the
        guest's golden on its new hart.  The destination slot's own tenant
        is discarded.

        Preconditions (else :class:`MigrationError`): both slots are
        preemptive, neither hart has exited, both are paused while
        executing guest code (V=1), and the guest is live and not
        currently scheduled on either hart."""
        if src == dst:
            raise MigrationError("src and dst must be different harts")
        s_spec = self._preemptive_spec(src)
        d_spec = self._preemptive_spec(dst)
        n = len(s_spec.guests)
        if not 0 <= guest < n:
            raise MigrationError(f"guest {guest} out of range for N={n}")
        if s_spec.guests[guest] is None:
            raise MigrationError(
                f"hart {src} guest {guest} was already migrated away")
        lay = programs.sched_layout(n)
        words = self._guest_words((src, dst), guest, lay)
        for i in (src, dst):
            self._check_guest_op(words[i], i, guest, "migrate")
        if words[src]["gdone"] != 0:
            raise MigrationError(
                f"hart {src} guest {guest} already finished — "
                f"nothing to migrate")
        mem = self._harts.mem.clone()
        for base, size in programs.guest_regions(lay, guest):
            w0, w1 = base >> 3, (base + size) >> 3
            mem[dst, w0:w1] = mem[src, w0:w1]
        # source: the slot is gone — mark it done and zero its mailbox so
        # the hart's combined exit checksum covers only remaining guests
        mem[src, _gi_done_word(lay, guest)] = 1
        mem[src, (lay.guest_res + 8 * guest) >> 3] = 0
        self._set_mem(mem)

        moved = s_spec.guests[guest]
        self._respec_slot(src, tuple(None if k == guest else w
                                     for k, w in enumerate(s_spec.guests)))
        self._respec_slot(dst, tuple(moved if k == guest else w
                                     for k, w in enumerate(d_spec.guests)))
        return self

    def _respec_slot(self, i: int, new_guests: tuple,
                     hole: str = "moved") -> None:
        """Rewrite slot i's spec after a guest-level mutation; ``hole``
        names empty (None) guest entries in the label."""
        spec = self._specs[i]
        name = "+".join(w.name if w is not None else hole
                        for w in new_guests)
        self._specs[i] = dataclasses.replace(
            spec, guests=new_guests, workload=new_guests[0], name=name)

    def park_guest(self, hart: int, guest: int, path) -> str:
        """Evict a descheduled guest VM to a per-guest checkpoint file.

        The regions :meth:`migrate_guest` moves are copied to the host in
        one copy and written with ``checkpoint.save_guest`` (a migration
        whose destination is a file); the slot is then marked done with a
        zeroed mailbox and its spec entry cleared.  :meth:`resume_guest`
        later splices the file into slot ``guest`` of any same-layout
        hart.  Preconditions as :meth:`migrate_guest`."""
        from repro_torch.core.hext import checkpoint
        spec = self._preemptive_spec(hart)
        n = len(spec.guests)
        if not 0 <= guest < n:
            raise MigrationError(f"guest {guest} out of range for N={n}")
        if spec.guests[guest] is None:
            raise MigrationError(f"hart {hart} guest {guest} is an "
                                 f"empty slot — nothing to park")
        lay = programs.sched_layout(n)
        words = self._guest_words((hart,), guest, lay)[hart]
        self._check_guest_op(words, hart, guest, "park")
        if words["gdone"] != 0:
            raise MigrationError(
                f"hart {hart} guest {guest} already finished — "
                f"nothing to park")
        spans = [(base >> 3, (base + size) >> 3)
                 for base, size in programs.guest_regions(lay, guest)]
        host = torch.cat([self._harts.mem[hart, w0:w1]
                          for w0, w1 in spans]).cpu().numpy()
        cuts = np.cumsum([w1 - w0 for w0, w1 in spans])[:-1]
        # the saved ginfo block carries done=0, so the region splice alone
        # revives the guest on resume
        regions = {name: part.view(np.uint64) for name, part in
                   zip(checkpoint.GUEST_REGIONS, np.split(host, cuts))}
        out = checkpoint.save_guest(
            str(path), regions, n=n, slot=guest, timeslice=spec.timeslice,
            workload=getattr(spec.guests[guest], "name", None))
        mem = self._harts.mem.clone()
        mem[hart, _gi_done_word(lay, guest)] = 1
        mem[hart, (lay.guest_res + 8 * guest) >> 3] = 0
        self._set_mem(mem)
        self._respec_slot(hart, tuple(None if k == guest else w
                                      for k, w in enumerate(spec.guests)),
                          hole="parked")
        return out

    def resume_guest(self, hart: int, path,
                     workload: Optional[Any] = None) -> "Fleet":
        """Splice a parked guest checkpoint into its slot on hart ``hart``
        (one host→device copy of its regions).  The restored info block
        carries ``done=0``, so the scheduler picks the guest up at its next
        timer tick and resumes it mid-flight.

        The slot must not be live: a ``None`` entry or a finished tenant
        (whose mailbox is then overwritten).  ``workload`` sets the spec
        entry for golden checks; by default the stored name is resolved
        through the standard registry.  Preconditions (else
        :class:`MigrationError`): preemptive slot with the checkpoint's
        layout (same N), hart not exited, paused in guest code (V=1),
        slot not live."""
        from repro_torch.core.hext import checkpoint
        regions, meta = checkpoint.load_guest(str(path))
        spec = self._preemptive_spec(hart)
        n = len(spec.guests)
        if n != int(meta["n"]):
            raise MigrationError(
                f"guest checkpoint has an N={meta['n']} layout but hart "
                f"{hart} runs N={n}")
        guest = int(meta["slot"])
        if workload is None and meta.get("workload"):
            workload = checkpoint.workload_registry().get(meta["workload"])
        if workload is None:
            raise MigrationError(
                f"cannot resolve workload {meta.get('workload')!r} from "
                f"the guest checkpoint — pass workload= explicitly")
        lay = programs.sched_layout(n)
        words = self._guest_words((hart,), guest, lay)[hart]
        self._check_guest_op(words, hart, guest, "resume")
        if spec.guests[guest] is not None and words["gdone"] == 0:
            raise MigrationError(
                f"hart {hart} guest slot {guest} is still live — "
                f"park or migrate it first")
        spans = [(base >> 3, (base + size) >> 3)
                 for base, size in programs.guest_regions(lay, guest)]
        dev = torch.as_tensor(np.concatenate(
            [regions[name].view(np.int64)
             for name in checkpoint.GUEST_REGIONS]),
            device=self._harts.device)
        mem = self._harts.mem.clone()
        at = 0
        for w0, w1 in spans:
            mem[hart, w0:w1] = dev[at:at + w1 - w0]
            at += w1 - w0
        self._set_mem(mem)
        self._respec_slot(hart, tuple(workload if k == guest else w
                                      for k, w in enumerate(spec.guests)))
        return self

    def replace_hart(self, i: int, state: HartState,
                     spec: Optional[HartSpec] = None) -> "Fleet":
        """Splice one hart's full state (and optionally its spec) into the
        batch — the control plane's provision/recover primitive: lanes
        keep the fleet's shapes (batch, mem_words), dtypes and device, so
        a graph engine's captured graph is reused.  ``state`` is a batch
        of one with the fleet's per-hart shapes; a state on another device
        is moved onto the fleet's.  Traced as ``hext.fleet.replace_hart``:
        host ms, the device ms of its clones and the bytes cloned."""
        if not (0 <= i < len(self._specs)):
            raise ValueError(f"hart {i} out of range")
        if state.batch != 1:
            raise ValueError(f"hart {i}: the state holds {state.batch} "
                             f"harts; replace_hart takes a batch of one")
        want = tuple(self._harts.mem.shape[1:])
        got = tuple(state.mem.shape[1:])
        if got != want:
            raise ValueError(
                f"hart {i}: state.mem shape {got} != fleet per-hart shape "
                f"{want} (lanes must keep the compiled shape)")
        dev = self._harts.device

        with tracing.span("hext.fleet.replace_hart", device=dev) as sp:
            def splice(b, s):
                if isinstance(b, dict):
                    return {k: splice(b[k], s[k]) for k in b}
                out = b.clone()
                out[i] = s[0].to(device=dev, dtype=b.dtype)
                sp.nbytes += out.nbytes
                return out

            self._harts = HartState.from_raw(
                splice(self._harts.to_raw(), state.to_raw()))
        if spec is not None:
            self._specs[i] = spec
        self._generation += 1
        return self

    # -- introspection --------------------------------------------------------
    @property
    def engine(self) -> Any:
        """The resolved execution backend this fleet runs on."""
        return self._engine

    @property
    def harts(self) -> _HartsView:
        """Generation-checked view of the batched state: a view taken
        before a ``run`` raises :class:`StaleHartsError` after it.  Use
        ``.unwrap()`` (or ``fleet[i]``) for the ``HartState`` itself."""
        return _HartsView(self, self._generation)

    def __getitem__(self, i: int) -> HartState:
        """Hart ``i`` as a batch of one (the port keeps the hart
        dimension; ``engine.diff_states(fa[i], fb[i])`` compares two)."""
        i = range(len(self))[i]

        def one(raw):
            return {k: one(v) if isinstance(v, dict) else v[i:i + 1].clone()
                    for k, v in raw.items()}

        return HartState.from_raw(one(self._harts.to_raw()))

    @property
    def specs(self) -> List[HartSpec]:
        return list(self._specs)

    @property
    def all_done(self) -> bool:
        return bool(self._harts.counters.done.all())

    def __len__(self) -> int:
        return len(self._specs)

    def counters(self) -> List[Counters]:
        """Per-hart :class:`Counters` on the host, in fleet order (one
        device→host copy for the whole batch).  Traced as
        ``hext.fleet.counters`` (host ms)."""
        with tracing.span("hext.fleet.counters"):
            host = {k: getattr(self._harts.counters, k).cpu()
                    for k in _COUNTER_KEYS}
            return [Counters(**{k: v[i] for k, v in host.items()})
                    for i in range(len(self))]

    def _preempt_entry(self, i: int, spec: HartSpec,
                       c: Counters) -> Dict[str, Any]:
        """Report entry for an N-guest slot: per-guest checksum mailboxes
        are read straight from the hart's memory."""
        n = len(spec.guests)
        res_w = programs.sched_layout(n).guest_res // 8
        cks = [int(x) & MASK64
               for x in self._harts.mem[i, res_w:res_w + n].cpu()]
        goldens = [None if w is None else int(w.golden()) & MASK64
                   for w in spec.guests]
        oks = [None if g is None else ck == g
               for ck, g in zip(cks, goldens)]
        total = sum(g for g in goldens if g is not None) & MASK64
        entry = c.to_dict()
        entry.update({
            "golden": total,
            "guests": n,
            "checksums": cks,
            "ok_guests": oks,
            "ok": bool(c.done) and all(o for o in oks if o is not None)
            and c.ok(total),
            "timeslice": spec.timeslice,
        })
        if n == 2:       # legacy 2-guest report keys
            entry.update({"checksum_a": cks[0], "checksum_b": cks[1],
                          "ok_a": oks[0], "ok_b": oks[1]})
        return entry

    def report(self) -> Dict[str, Dict[str, Any]]:
        """``{label: counter-dict}`` with golden checks where known.
        Duplicate labels get a ``#<slot>`` suffix."""
        out: Dict[str, Dict[str, Any]] = {}
        for i, (spec, c) in enumerate(zip(self._specs, self.counters())):
            if spec.preemptive:
                entry = self._preempt_entry(i, spec, c)
            else:
                golden = spec.workload.golden() if spec.workload is not None \
                    else None
                entry = c.to_dict(golden)
                if golden is not None:
                    entry["golden"] = int(golden) & MASK64
            label = spec.label
            if label in out:
                label = f"{label}#{i}"
            out[label] = entry
        return out
