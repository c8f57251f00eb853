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
    """A host copy of a tensor (bf16 as its uint16 patterns)."""
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


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

    def restore(self, step: int, like: Any) -> Any:
        """Restore into ``like`` (a tree of tensors, e.g. a freshly built
        state) in place: each leaf takes the saved values on its own
        device and in its own dtype.  Returns ``like``."""
        d = self._final_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            keys = json.load(f)["keys"]
        data = np.load(os.path.join(d, "shard_0.npz"))
        for key, leaf in _flatten_with_paths(like).items():
            t = torch.from_numpy(np.array(data[key.replace("/", "|")],
                                          copy=True))
            if keys[key]["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: saved shape {tuple(t.shape)}, "
                                 f"restoring into {tuple(leaf.shape)}")
            with torch.no_grad():
                leaf.copy_(t)
        return like

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
