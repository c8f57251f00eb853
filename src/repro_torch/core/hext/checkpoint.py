"""gem5-style checkpointing for hext fleets — port of
``repro.core.hext.checkpoint``.

A checkpoint is a single versioned ``.npz`` holding every leaf of the
batched ``HartState`` plus a JSON metadata record, in the reference's
layout exactly, so a file moves between the two packages in both
directions:

* one array per architectural field (``pc``, ``regs``, ``csrs``, …),
  ``tlb.<key>`` for the software TLB and ``counters.<key>`` for the
  counter record — host numpy with the reference's dtypes (uint64 words,
  int32 ``priv``/TLB fields, bool flags; ``HartState.to_numpy``) and the
  leading fleet dimension;
* ``__meta__`` — ``{format, version, schema, schema_sha256, specs,
  engine}``.  ``schema`` is the sorted ``(key, dtype, shape)`` table of
  the saved arrays and ``schema_sha256`` its hash; on restore the schema
  is recomputed from the arrays actually present and must hash to the
  stored value, so a truncated or edited file, or one written by an
  incompatible ``HartState`` layout, raises :class:`CheckpointError`
  instead of resuming silently wrong.

``HartSpec`` metadata travels by workload *name* and is resolved against
the standard registry (``programs.WORKLOADS``); custom workloads restore
with ``workload=None`` unless the caller passes explicit specs.

Per-guest checkpoints (:func:`save_guest` / :func:`load_guest`) hold the
migratable regions of one guest VM of an N-guest hart.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.hext import programs as _programs
from repro_torch.core.hext.sim import HartSpec, HartState

FORMAT = "hext-fleet-checkpoint"
VERSION = 1
GUEST_FORMAT = "hext-guest-checkpoint"
GUEST_VERSION = 1
# per-guest migratable regions, in programs.guest_regions order
GUEST_REGIONS = ("ctx", "gtab", "window", "mailbox", "ginfo")

__all__ = ["CheckpointError", "FORMAT", "VERSION", "GUEST_FORMAT",
           "GUEST_VERSION", "GUEST_REGIONS", "save", "load", "save_guest",
           "load_guest", "schema_of", "schema_sha256", "workload_registry"]


class CheckpointError(RuntimeError):
    """A checkpoint file is unreadable, corrupted, or schema-incompatible."""


_STATE_KEYS = ("pc", "regs", "csrs", "priv", "virt", "mem", "halted",
               "console")
_COUNTER_KEYS = ("done", "exit_code", "instret", "instret_virt",
                 "exc_by_level", "int_by_level", "pagefaults", "walks",
                 "ticks", "timer_irqs", "ctx_switches")


def _flatten(harts: HartState) -> Dict[str, np.ndarray]:
    raw = harts.to_numpy()
    out = {k: raw[k] for k in _STATE_KEYS}
    out.update({f"tlb.{k}": v for k, v in raw["tlb"].items()})
    out.update({f"counters.{k}": raw[k] for k in _COUNTER_KEYS})
    return out


def _expected_keys_and_dtypes() -> Dict[str, np.dtype]:
    """What the current ``HartState`` layout looks like (a one-word
    reference state) — the restore side's notion of a compatible schema."""
    ref = _flatten(HartState.fresh(1, device="cpu"))
    return {k: v.dtype for k, v in ref.items()}


def schema_of(arrays: Dict[str, np.ndarray]) -> List[List[Any]]:
    """Canonical, JSON-stable ``[key, dtype, shape]`` table."""
    return [[k, arrays[k].dtype.str, list(arrays[k].shape)]
            for k in sorted(arrays)]


def schema_sha256(schema: List[List[Any]]) -> str:
    return hashlib.sha256(
        json.dumps(schema, separators=(",", ":")).encode()).hexdigest()


# ---------------------------------------------------------------------------
# HartSpec (de)serialization — workloads travel by name
# ---------------------------------------------------------------------------

def workload_registry() -> Dict[str, Any]:
    reg = {}
    for w in _programs.WORKLOADS + _programs.WORKLOADS_EXTRA:
        # several workloads materialize their input buffer (and hence
        # their golden) in write_data; a restored spec may be the first
        # user of the shared instance in this process, so warm it against
        # a scratch image (write_data is seeded → idempotent)
        w.write_data(_programs.Image(_programs.MEM_WORDS))
        reg[w.name] = w
    return reg


def _encode_spec(spec: HartSpec) -> Dict[str, Any]:
    return {
        "name": spec.name,
        "guest": bool(spec.guest),
        "timeslice": int(spec.timeslice),
        "workload": None if spec.workload is None else spec.workload.name,
        "guests": None if spec.guests is None else
        [None if w is None else w.name for w in spec.guests],
    }


def _decode_spec(d: Dict[str, Any], reg: Dict[str, Any]) -> HartSpec:
    wl = reg.get(d["workload"]) if d["workload"] is not None else None
    guests = None
    if d["guests"] is not None:
        # a stored null is a migrated-away slot (legitimately None); an
        # unknown *name* must NOT decode to None — the report would read
        # it as migrated-away and mis-total the expected checksum
        unknown = [n for n in d["guests"]
                   if n is not None and n not in reg]
        if unknown:
            raise CheckpointError(
                f"spec {d['name']!r} references guest workloads not in "
                f"the registry: {unknown} — restore with explicit "
                f"Fleet.restore(path, specs=...)")
        guests = tuple(None if n is None else reg[n]
                       for n in d["guests"])
    return HartSpec(workload=wl, guest=bool(d["guest"]),
                    name=str(d["name"]), guests=guests,
                    timeslice=int(d["timeslice"]))


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _atomic_savez(path: str, **payload) -> str:
    """Write an ``.npz`` atomically: serialize to a temp file in the same
    directory, fsync, then ``os.replace`` over the target.  A crash (or
    kill) mid-write leaves the previous file intact, never a truncated
    ``.npz``."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt-", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez_compressed(fh, **payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def _meta_record(arrays: Dict[str, np.ndarray], fmt: str, version: int,
                 **extra) -> np.ndarray:
    schema = schema_of(arrays)
    return np.array(json.dumps({"format": fmt, "version": version,
                                "schema": schema,
                                "schema_sha256": schema_sha256(schema),
                                **extra}))


def save(path: str, harts: HartState, specs: Sequence[HartSpec],
         engine_name: str = "eager") -> str:
    """Write the fleet's full state + spec metadata as a versioned .npz
    (atomically — see :func:`_atomic_savez`)."""
    arrays = _flatten(harts)
    if len(specs) != harts.batch:
        raise ValueError(f"{len(specs)} specs for {harts.batch} harts")
    meta = _meta_record(arrays, FORMAT, VERSION,
                        specs=[_encode_spec(s) for s in specs],
                        engine=engine_name)
    return _atomic_savez(path, __meta__=meta, **arrays)


def _read(path: str, fmt: str, version: int,
          what: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Arrays and metadata of a checkpoint of format ``fmt``, with the
    format, version and schema hash checked."""
    try:
        z = np.load(path, allow_pickle=False)
    except Exception as e:
        raise CheckpointError(f"unreadable {what} {path!r}: {e}") from e
    with z:
        if "__meta__" not in z.files:
            raise CheckpointError(f"{path!r} has no __meta__ record — "
                                  f"not a {fmt} file")
        try:
            meta = json.loads(str(z["__meta__"][()]))
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        except Exception as e:
            raise CheckpointError(f"corrupted {what} {path!r}: "
                                  f"{e}") from e
    if meta.get("format") != fmt:
        raise CheckpointError(
            f"{path!r}: format {meta.get('format')!r} != {fmt!r}")
    if meta.get("version") != version:
        raise CheckpointError(
            f"{path!r}: {what} version {meta.get('version')} is not "
            f"supported (this build reads version {version})")
    schema = schema_of(arrays)
    if schema_sha256(schema) != meta.get("schema_sha256") or \
            schema != meta.get("schema"):
        raise CheckpointError(
            f"{path!r}: schema hash mismatch — the file is corrupted or "
            f"was edited after save")
    return arrays, meta


def load(path: str, decode_specs: bool = True,
         device=None) -> Tuple[HartState, List[HartSpec]]:
    """Read a checkpoint → ``(HartState on device, [HartSpec])``.

    Raises :class:`CheckpointError` on anything that cannot restore
    bit-for-bit: unreadable/corrupted files, a version or schema-hash
    mismatch, and fields missing/extra/retyped relative to the current
    ``HartState`` layout.  ``decode_specs=False`` skips workload-name
    resolution (returns ``[]``).  ``device`` defaults to ``cuda``."""
    arrays, meta = _read(path, FORMAT, VERSION, "checkpoint")
    expected = _expected_keys_and_dtypes()
    missing = sorted(set(expected) - set(arrays))
    extra = sorted(set(arrays) - set(expected))
    if missing or extra:
        raise CheckpointError(
            f"{path!r}: field set does not match this build's HartState "
            f"(missing {missing}, unexpected {extra}) — snapshot from an "
            f"incompatible version")
    for k, dt in expected.items():
        if arrays[k].dtype != dt:
            raise CheckpointError(
                f"{path!r}: field {k!r} has dtype {arrays[k].dtype}, "
                f"this build expects {dt}")
    raw = {k: arrays[k] for k in _STATE_KEYS}
    raw["tlb"] = {k.split(".", 1)[1]: v for k, v in arrays.items()
                  if k.startswith("tlb.")}
    raw.update({k: arrays[f"counters.{k}"] for k in _COUNTER_KEYS})
    harts = HartState.from_numpy(raw, device=device)
    specs: List[HartSpec] = []
    if decode_specs:
        reg = workload_registry()             # built once per load
        specs = [_decode_spec(d, reg) for d in meta.get("specs", [])]
    return harts, specs


# ---------------------------------------------------------------------------
# per-guest checkpoints ("parking")
# ---------------------------------------------------------------------------

def _region_sizes(n: int, slot: int) -> Dict[str, int]:
    lay = _programs.sched_layout(int(n))
    return {name: size // 8 for name, (_, size) in
            zip(GUEST_REGIONS, _programs.guest_regions(lay, int(slot)))}


def save_guest(path: str, regions: Dict[str, np.ndarray], *, n: int,
               slot: int, timeslice: int = 0,
               workload: Any = None) -> str:
    """Write one guest VM's migratable state as a versioned ``.npz``.

    ``regions`` maps the :data:`GUEST_REGIONS` names to the uint64 word
    arrays lifted from the owning hart's memory (``programs.guest_regions``
    order).  The region addresses are slot-determined, so the file records
    ``n`` (the scheduler layout) and ``slot``.  Written atomically."""
    expect = _region_sizes(n, slot)
    if set(regions) != set(GUEST_REGIONS):
        raise CheckpointError(
            f"regions must be exactly {sorted(GUEST_REGIONS)}, "
            f"got {sorted(regions)}")
    arrays = {}
    for name in GUEST_REGIONS:
        a = np.asarray(regions[name], dtype=np.uint64)
        if a.shape != (expect[name],):
            raise CheckpointError(
                f"region {name!r}: shape {a.shape} != ({expect[name]},) "
                f"for an N={n} layout")
        arrays[f"region.{name}"] = a
    meta = _meta_record(arrays, GUEST_FORMAT, GUEST_VERSION, n=int(n),
                        slot=int(slot), timeslice=int(timeslice),
                        workload=None if workload is None else str(workload))
    return _atomic_savez(path, __meta__=meta, **arrays)


def load_guest(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Read a parked-guest checkpoint → ``({region: words}, meta)``.

    Raises :class:`CheckpointError` on unreadable/corrupted files, a
    format/version mismatch, a schema-hash mismatch, or region sizes
    inconsistent with the recorded ``(n, slot)`` layout."""
    arrays, meta = _read(path, GUEST_FORMAT, GUEST_VERSION,
                         "guest checkpoint")
    want = {f"region.{name}" for name in GUEST_REGIONS}
    if set(arrays) != want:
        raise CheckpointError(
            f"{path!r}: region set {sorted(arrays)} does not match "
            f"{sorted(want)}")
    try:
        n, slot = int(meta["n"]), int(meta["slot"])
        sizes = _region_sizes(n, slot)
    except Exception as e:
        raise CheckpointError(
            f"{path!r}: bad layout metadata (n={meta.get('n')!r}, "
            f"slot={meta.get('slot')!r}): {e}") from e
    regions = {}
    for name in GUEST_REGIONS:
        a = arrays[f"region.{name}"]
        if a.dtype != np.uint64 or a.shape != (sizes[name],):
            raise CheckpointError(
                f"{path!r}: region {name!r} is {a.dtype}{a.shape}, "
                f"expected uint64 ({sizes[name]},) for the recorded "
                f"N={n}/slot={slot} layout")
        regions[name] = a
    return regions, meta
