"""The port's dry run (``launch/dryrun.py``) and its collective counter
(``launch/roofline.CollectiveCounter``), on the ``fake`` process group.

Three subprocesses side by side (each a fake world of 8 ranks, CPU fake
tensors) run, between them:

* the counter on hand-sized cases on a (data=4, model=2) mesh: an FSDP
  all-gather of a [d, ff] bf16 weight counts d·ff·2 bytes a device, a
  row-parallel matmul's all-reduce its output's bytes;
* ``run_cell`` for every arch (reduced) at train_4k and decode_32k on a
  (2, 4) mesh (train cells with one microbatch, MiniCPM's with two, to
  keep the suite's time), and MiniCPM's train cell on (1, 8), where its
  4 heads do not divide the model axis;
* the command line on one cell, writing its record to ``--out``.

The process group lives and dies with the subprocess, so no later test
file in the same worker sees it.  The kernel's fake binding is traced
only by a prefill cell on the card (``chip_smoke.py``); on the CPU the
prefill attention is the plain version.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import analytic, dryrun
from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS

ROOT = Path(__file__).resolve().parents[1]
CELL_SHAPES = ("train_4k", "decode_32k")
D, FF, ROWS, N = 64, 96, 8, 48

SCRIPT = r"""
import json, sys
import torch
from repro_torch.launch import dryrun

out = {}
dryrun._fake_world(8, "cpu")
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.roofline import CollectiveCounter

D, FF, ROWS, N = (int(x) for x in sys.argv[2:6])
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
with FakeTensorMode():
    w = distribute_tensor(torch.empty(D, FF, dtype=torch.bfloat16), mesh,
                          [Shard(0), Replicate()])
    with CollectiveCounter() as c:
        w.redistribute(mesh, [Replicate(), Replicate()])
    out["fsdp_gather"] = c.by_kind
    x = distribute_tensor(torch.empty(ROWS, D, dtype=torch.bfloat16), mesh,
                          [Replicate(), Shard(1)])
    w = distribute_tensor(torch.empty(D, N, dtype=torch.bfloat16), mesh,
                          [Replicate(), Shard(0)])
    with CollectiveCounter() as c:
        y = x @ w
        y = y.redistribute(mesh, [Replicate(), Replicate()])
    out["row_parallel"] = c.by_kind
    out["row_parallel_flops"] = c.flops

cells = []
for arch, shape, mesh in json.loads(sys.argv[7]):
    mb = (2 if arch == "minicpm_2b" else 1) if shape == "train_4k" else None
    rec = dryrun.run_cell(arch, shape, mesh_shape=mesh, reduced=True,
                          device="cpu", microbatches=mb)
    rec.pop("traceback", None)
    cells.append(rec)
out["cells"] = cells
if sys.argv[6] != "-":
    recs = dryrun.main(["--arch", "mamba2_130m", "--shape", "decode_32k",
                        "--reduced", "--mesh", "2,4", "--device", "cpu",
                        "--out", sys.argv[6]])
    out["cli"] = [r["status"] for r in recs]
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cells = [(a, s, (2, 4)) for s in CELL_SHAPES for a in configs.ARCHS]
    # the three slowest cells (the SSD's and RG-LRU's scans, MoE's
    # dispatch in training) one to each subprocess, the others dealt out
    # after them, MiniCPM's 4 heads over a model axis of 8 as well
    slow = [c for c in cells if c[1] == "train_4k" and c[0] in (
        "mamba2_130m", "recurrentgemma_9b", "qwen3_moe_30b_a3b")]
    rest = [c for c in cells if c not in slow] + \
        [("minicpm_2b", "train_4k", (1, 8))]
    parts = [[c] + rest[i::3] for i, c in enumerate(slow)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp / f"out{i}.json"),
         *map(str, (D, FF, ROWS, N)), str(tmp / "cli") if i == 1 else "-",
         json.dumps(part)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i, part in enumerate(parts)]
    outs = []
    for i, p in enumerate(procs):
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads((tmp / f"out{i}.json").read_text()))
    out = dict(outs[1])
    out["cells"] = [c for o in outs for c in o["cells"]]
    out["cli_dir"] = tmp / "cli"
    return out


def test_counter_fsdp_all_gather(dry):
    """An FSDP all-gather of a [d, ff] bf16 weight over data = 4 counts
    d·ff·2 bytes a device (its result), and nothing else."""
    assert dry["fsdp_gather"] == {"all-gather": D * FF * 2}


def test_counter_row_parallel_all_reduce(dry):
    """A row-parallel matmul (the contraction sharded over model = 2)
    gives a partial sum; replicating it is one all-reduce of the output's
    bytes.  The local product counts its own FLOPs (2·rows·d/2·n)."""
    assert dry["row_parallel"] == {"all-reduce": ROWS * N * 2}
    assert dry["row_parallel_flops"] == 2 * ROWS * (D // 2) * N


@pytest.mark.parametrize("shape", CELL_SHAPES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_run_cell_ok(dry, arch, shape):
    """Every reduced arch traces its train step (or decode step) on a fake
    (2, 4) world: ``ok``, live bytes a device counted, the collective
    bytes by kind, and the roofline fields ``analytic``'s exactly (the
    H100 constants, the collective term from the counter)."""
    rec = next(r for r in dry["cells"] if r["arch"] == arch and
               r["shape"] == shape and r.get("mesh") == [2, 4])
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 8 and rec["mesh"] == [2, 4]
    mem = rec["memory"]
    assert mem["per_device_live_bytes"] > 0
    assert mem["fits_h100_80g"] == (mem["per_device_live_bytes"] <= 80e9)
    cfg = configs.get_config(arch, reduced=True)
    if "remat" in dryrun.ARCH_OVERRIDES[arch]:
        cfg = dataclasses.replace(cfg,
                                  remat=dryrun.ARCH_OVERRIDES[arch]["remat"])
    shp = SHAPES[shape]
    mode = shp.kind
    r = rec["roofline"]
    pbytes = 4 if mode == "train" and rec["param_dtype"] == "float32" else 2
    ex = analytic.exec_flops(cfg, shp, mode, cfg.remat)
    hbm = analytic.hbm_bytes(cfg, shp, mode, pbytes)
    us = analytic.useful_flops(cfg, shp, mode)
    assert r["exec_flops"] == ex and r["model_flops"] == us
    assert r["analytic_hbm_bytes"] == hbm
    np.testing.assert_allclose(r["t_compute_s"], ex / (8 * PEAK_FLOPS),
                               rtol=1e-12)
    np.testing.assert_allclose(r["t_memory_s"], hbm / (8 * HBM_BW),
                               rtol=1e-12)
    coll = sum(r["collective_by_kind"].values())
    assert r["collective_bytes_per_dev"] == coll > 0
    np.testing.assert_allclose(r["t_collective_s"], coll / LINK_BW,
                               rtol=1e-12)
    terms = {"compute": r["t_compute_s"], "memory": r["t_memory_s"],
             "collective": r["t_collective_s"]}
    assert r["dominant"] == max(terms, key=terms.get)
    assert r["traced_flops_per_dev"] > 0
    np.testing.assert_allclose(r["t_compute_traced_s"],
                               r["traced_flops_per_dev"] / PEAK_FLOPS,
                               rtol=1e-12)
    if mode == "train":     # the gradients' reduction ran
        assert set(r["collective_by_kind"]) & {"reduce-scatter",
                                               "all-reduce"}


def test_heads_that_do_not_divide_split_the_query_rows(dry):
    """MiniCPM (reduced: 4 heads) on a (1, 8) mesh, where its heads do not
    divide the model axis: the attention runs on each device's query rows
    (JAX's "scores" layout), so the FLOPs a device stay within 25 % of
    those on (2, 4), where the heads divide; repeated on every model
    device they were 7 times as many."""
    cell = {tuple(r.get("mesh", ())): r for r in dry["cells"]
            if r["arch"] == "minicpm_2b" and r["shape"] == "train_4k"}
    assert cell[(1, 8)]["status"] == "ok", cell[(1, 8)].get("error")
    rows, heads = (cell[m]["roofline"]["traced_flops_per_dev"]
                   for m in ((1, 8), (2, 4)))
    assert rows <= 1.25 * heads, (rows, heads)


def test_command_line_writes_the_record(dry):
    """``main`` (the command line) runs a cell and writes its record as
    ``<arch>__<shape>__sp.json`` under ``--out``."""
    assert dry["cli"] == ["ok"]
    rec = json.loads((dry["cli_dir"] / "mamba2_130m__decode_32k__sp.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["shape"] == "decode_32k"
