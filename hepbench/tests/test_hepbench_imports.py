"""Nothing in the benchmark imports JAX, the JAX package, the JAX
package's benchmarks or ``chip_smoke``; the reference imports nothing of
the port.  Top-level names are compared whole: ``repro_torch`` begins
with ``repro``."""

import ast
from pathlib import Path

import pytest

FOLDER = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_scan_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.api\nfrom repro.core import x\n"
                 "from . import y\nimport jax.numpy as jnp\n")
    assert top_level_imports(f) == {"repro_torch", "repro", "jax"}


@pytest.mark.parametrize("path", sorted(FOLDER.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(FOLDER)))
def test_no_banned_import(path):
    names = top_level_imports(path)
    assert not names & BANNED
    if "reference" in path.relative_to(FOLDER).parts:
        assert names <= {"__future__", "dataclasses", "re", "typing",
                         "numpy", "torch"}
