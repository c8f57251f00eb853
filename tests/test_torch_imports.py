"""The port stands alone: no module under ``src/repro_torch`` imports JAX
or anything of the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]


def test_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES}
    for mod in ("device.py", "core/hext/machine.py", "core/hext/sim.py",
                "core/hext/engine.py", "core/hext/checkpoint.py",
                "core/hext/oracle.py", "core/hext/torture.py",
                "core/hext/policies.py", "core/hext/service.py",
                "core/hext/tracing.py",
                "kernels/pagewalk/kernel.py", "indexing.py",
                "core/vmem/page_table.py", "core/vmem/allocator.py",
                "core/vmem/kvcache.py", "kernels/paged_attention/ref.py",
                "kernels/paged_attention/kernel.py",
                "kernels/paged_attention/ops.py",
                "configs/base.py", "configs/__init__.py",
                "configs/h2o_danube_3_4b.py", "models/layers.py",
                "models/mlp.py", "models/moe.py", "models/attention.py",
                "models/rglru.py", "models/ssm.py",
                "models/activation_sharding.py",
                "models/transformer.py", "models/weights.py",
                "kernels/flash_attention/ref.py",
                "kernels/flash_attention/kernel.py",
                "kernels/flash_attention/ops.py", "optim/adamw.py",
                "optim/schedule.py", "data/pipeline.py",
                "runtime/sharding.py", "runtime/train_loop.py",
                "checkpoint/checkpointer.py", "checkpoint/manager.py",
                "launch/train.py", "launch/mesh.py", "launch/specs.py",
                "launch/analytic.py", "launch/roofline.py",
                "launch/dryrun.py"):
        assert mod in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PORT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [r for r in _imported_roots(tree) if r in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
