"""The port's examples (``examples/torch_*.py``) run as a user runs them,
each in a subprocess on ``--device cpu`` with a short workload: the
quickstart's crc32 native and guest on the eager engine reach their
golden checksum, and the small training run's loss falls.  They import
nothing of JAX or of the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
RUNS = {
    "quickstart": ["examples/torch_quickstart.py", "crc32", "eager",
                   "--device", "cpu", "--chunk", "1024"],
    "train_small": ["examples/torch_train_small.py", "--steps", "4",
                    "--device", "cpu"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs = {}
    for name, args in RUNS.items():
        extra = ["--ckpt-dir", str(tmp / "ckpt")] if name == "train_small" \
            else []
        procs[name] = subprocess.Popen(
            [sys.executable, *args, *extra], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        out[name] = (p.returncode, stdout, stderr)
    return out


def test_examples_exist():
    assert {p.name for p in EXAMPLES} == {
        "torch_quickstart.py", "torch_batched_fleet_sim.py",
        "torch_serve_demo.py", "torch_train_small.py"}


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_quickstart_reaches_the_goldens(runs):
    rc, out, err = runs["quickstart"]
    assert rc == 0, err[-2000:]
    assert "engine: eager" in out
    assert out.count("checksum_ok=True") == 2, out


def test_train_small_loss_falls(runs):
    rc, out, err = runs["train_small"]
    assert rc == 0, err[-2000:]
    assert "OK: loss fell" in out, out
