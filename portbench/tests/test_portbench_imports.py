"""What the benchmark loads: never JAX or the JAX package, never the JAX
package's benchmark folder, and a reference that imports nothing of the
port."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PORTBENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter at the root of the checkout."""
    probe = (f"import sys; sys.path.insert(0, 'src'); {code}; "
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = "; ".join(
        ["import portbench.run, portbench.sweep, portbench.trace",
         "import portbench.control, portbench.check"]
        + [f"import portbench.{d}.{m}" for d, m in _modules("metrics")]
        + [f"import portbench.{d}.{m}" for d, m in _modules("kinds")])
    names = _loaded(code)
    assert "repro_torch" in names
    assert not names & FORBIDDEN
    # names are compared whole: the port's name starts with the JAX
    # package's
    assert "repro" not in names


def _modules(folder: str) -> list:
    return [(folder, p.stem) for p in (PORTBENCH / folder).glob("*.py")
            if p.stem != "__init__"]


def test_the_reference_imports_nothing_of_the_port():
    # the kinds build the images that both sides are handed
    names = _loaded("; ".join(
        ["import portbench.check, portbench.roofline, portbench.traffic"]
        + [f"import portbench.{d}.{m}" for d, m in _modules("kinds")]))
    assert not names & (FORBIDDEN | {"repro_torch", "torch"})
    for path in (PORTBENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top in sys.stdlib_module_names or \
                    top in {"numpy", "portbench"}, (path.name, m)


def test_nothing_in_the_harness_reads_the_jax_benchmark_folder():
    pattern = re.compile(r"\bbenchmarks\b")
    for path in PORTBENCH.rglob("*"):
        if path.is_dir() or "tests" in path.parts or \
                path.suffix not in (".py", ".json"):
            continue
        assert not pattern.search(path.read_text()), path
