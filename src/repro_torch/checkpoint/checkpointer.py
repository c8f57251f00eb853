"""Atomic, async-capable checkpointing, as the JAX package's
``repro.checkpoint.checkpointer``: the same layout and commit protocol.

Layout (one directory per step):
    <root>/step_000123.tmp/      — written first
        manifest.json            — keys with shapes/dtypes, extra, specs
        shard_0.npz              — every leaf (flat key → array)
    <root>/step_000123/          — atomic rename AFTER fsync (commit point)

Readers only ever see committed directories; a crash mid-write leaves a
.tmp that is garbage-collected on the next save.  ``gc`` leaves the .tmp
of a write still in flight alone (the JAX package's deletes every .tmp,
so a save in the background can lose its checkpoint to the ``gc`` right
after it: ROADMAP R13).

A tree is nested dicts (flattened in sorted key order, as JAX flattens
a dict) and named tuples (a field ``f`` is the path entry ``.f``, as in
JAX's keys: ``opt/.step``, ``opt/.m/<name>``) of tensors.  ``save``
copies every tensor to the host before it returns, so training can go
on writing the tensors in place while the bytes reach the disk.  numpy
has no bf16: a bf16 tensor is stored as its 16-bit patterns (uint16),
with ``bfloat16`` in the manifest, and restored bit for bit.

On a mesh a leaf may be a DTensor: ``save`` writes its full value, and
``restore(..., shardings=)`` places each saved leaf on its DTensor
placements (``distribute_tensor``), as JAX's ``device_put`` onto
``NamedSharding``s.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten_with_paths(tree, prefix=""):
    """{"a/b/.c": leaf} of a tree of dicts and named tuples."""
    out = {}
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = (("." + f, getattr(tree, f)) for f in tree._fields)
    else:
        return {prefix: tree}
    for name, sub in items:
        out.update(_flatten_with_paths(sub, f"{prefix}/{name}" if prefix
                                       else name))
    return out


def _to_host(x) -> np.ndarray:
    """A host copy of a tensor (a DTensor's full value; bf16 as its
    uint16 patterns)."""
    if type(x).__name__ == "DTensor":
        x = x.full_tensor()
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _replace(tree, new: Dict[str, Any], prefix=""):
    """``tree`` with the leaves at the paths of ``new`` replaced (dicts
    are updated in place, named tuples rebuilt)."""
    if isinstance(tree, dict):
        for k in tree:
            path = f"{prefix}/{k}" if prefix else str(k)
            if path in new:
                tree[k] = new[path]
            else:
                tree[k] = _replace(tree[k], new, path)
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        vals = []
        for f in tree._fields:
            path = f"{prefix}/.{f}" if prefix else "." + f
            vals.append(new[path] if path in new
                        else _replace(getattr(tree, f), new, path))
        return type(tree)(*vals)
    return tree


class Checkpointer:
    def __init__(self, root: str, async_save: bool = True):
        self.root = root
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._in_flight: Optional[str] = None
        os.makedirs(root, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, specs: Any = None,
             extra: Optional[Dict] = None) -> str:
        """Snapshot on the host, then write (optionally) in the background —
        training continues while bytes hit disk."""
        flat = _flatten_with_paths(tree)
        host = {k: _to_host(v) for k, v in flat.items()}
        dtypes = {k: str(v.dtype).removeprefix("torch.")
                  for k, v in flat.items()}
        self.wait()
        self._in_flight = os.path.basename(self._final_dir(step)) + ".tmp"
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, dtypes, specs, extra))
            self._thread.start()
        else:
            self._write(step, host, dtypes, specs, extra)
        return self._final_dir(step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _final_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def _write(self, step: int, host, dtypes, specs, extra):
        final = self._final_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                     for k, v in host.items()},
            "extra": extra or {},
        }
        if specs is not None:
            sflat = _flatten_with_paths(specs)
            manifest["specs"] = {k: [list(ax) if isinstance(ax, tuple)
                                     else ax for ax in tuple(v)]
                                 for k, v in sflat.items()}
        np.savez(os.path.join(tmp, "shard_0.npz"),
                 **{k.replace("/", "|"): v for k, v in host.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # commit point (atomic)

    # -- restore ----------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    steps.append(int(d[5:]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None,
                mesh=None) -> Any:
        """Restore into ``like`` (a tree of tensors, e.g. a freshly built
        state) in place: each leaf takes the saved values on its own
        device and in its own dtype.  Returns ``like``.

        ``shardings`` (a tree of ``like``'s structure whose leaves are
        DTensor placements, ``ShardingPolicy.tree_shardings``) places
        each saved leaf on ``mesh`` (default: the mesh of ``like``'s
        DTensors) by ``distribute_tensor``: a DTensor leaf of ``like``
        on those placements takes the values in place, a plain one is
        replaced (in its dict or named tuple) by the new DTensor."""
        d = self._final_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            keys = json.load(f)["keys"]
        data = np.load(os.path.join(d, "shard_0.npz"))
        flat = _flatten_with_paths(like)
        places = (None if shardings is None
                  else _flatten_with_paths(shardings))
        if places is not None and mesh is None:
            mesh = next((x.device_mesh for x in flat.values()
                         if type(x).__name__ == "DTensor"), None)
            if mesh is None:
                raise ValueError("restore(shardings=...) needs a mesh: "
                                 "pass mesh= or DTensor leaves")
        new = {}
        for key, leaf in flat.items():
            t = torch.from_numpy(np.array(data[key.replace("/", "|")],
                                          copy=True))
            if keys[key]["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: saved shape {tuple(t.shape)}, "
                                 f"restoring into {tuple(leaf.shape)}")
            if places is not None:
                from torch.distributed.tensor import distribute_tensor
                t = distribute_tensor(
                    t.to(device=mesh.device_type, dtype=leaf.dtype), mesh,
                    places[key])
                if type(leaf).__name__ != "DTensor":
                    new[key] = t
                    continue
                if list(leaf.placements) != list(t.placements):
                    raise ValueError(f"{key}: restoring onto "
                                     f"{t.placements}, the leaf is on "
                                     f"{leaf.placements}")
            with torch.no_grad():
                leaf.copy_(t)
        return _replace(like, new) if new else like

    def gc(self, keep: int):
        all_steps = sorted(int(d[5:]) for d in os.listdir(self.root)
                           if d.startswith("step_") and not
                           d.endswith(".tmp"))
        for s in all_steps[:-keep] if keep else []:
            shutil.rmtree(self._final_dir(s), ignore_errors=True)
        busy = self._thread is not None and self._thread.is_alive()
        for d in os.listdir(self.root):   # orphaned tmp dirs from crashes
            if d.endswith(".tmp") and not (busy and d == self._in_flight):
                shutil.rmtree(os.path.join(self.root, d),
                              ignore_errors=True)
