"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, found by the name the cell gives:

* ``portbench/configs/<config>.json`` — the fleet (the cell's ``config``;
  ``BENCHMARK.json`` names the file);
* ``portbench/mixes/<traffic>.json`` — the job mix, whose ``kind``
  names the module of its jobs;
* ``portbench/kinds/<kind>.py`` — a kind of job: the jobs' names, images
  and goldens (:mod:`portbench.kinds`), with any frozen generator it
  needs under ``portbench/reference/``;
* ``portbench/metrics/<metric>.py`` — one reader per metric, a function
  ``read(record) -> float | None`` (``None``: nothing to read, and the
  metric is left out of the result line).

So a later change adds a cell, a configuration, a mix, a kind of job or a
metric by adding files and entries, and edits none of these modules.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load() -> Dict[str, Any]:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: "
                         f"{', '.join(cells)}")
    return cells[name]


def config(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    entry = {c["name"]: c for c in bench["configs"]}[name]
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def mix(name: str) -> Dict[str, Any]:
    with open(HERE / "mixes" / f"{name}.json") as f:
        return json.load(f)


def metrics(bench: Dict[str, Any], cell_name: str,
            trace: bool) -> List[Dict[str, Any]]:
    """The cell's metrics: its end-to-end ones, or with ``trace`` its
    per-layer ones (a metric with ``workloads`` only in those cells)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    return importlib.import_module(f"portbench.metrics.{name}").read
