"""Nothing in the benchmark imports JAX, the JAX package, the JAX
package's benchmarks or ``chip_smoke``; the reference imports nothing of
the port; the harness leaves the paper's networks to their family file.
Top-level names are compared whole: ``repro_torch`` begins with
``repro``."""

import ast
from pathlib import Path

import pytest

FOLDER = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}
# the harness's files, and the modules that only ``families/hepbnn.py``
# may import of them
HARNESS = ("harness.py", "run.py", "trace.py", "plans.py", "sweep.py",
           "control.py")
FAMILY_ONLY = ("hepbench.reference.bnn", "hepbench.inputs",
               "repro_torch.bnn")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def imported_names(path: Path) -> set:
    """Every dotted name an absolute import of `path` may bind: a module,
    and for ``from m import n`` both ``m`` and ``m.n``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def family_only_imports(path: Path) -> set:
    return {n for n in imported_names(path) for m in FAMILY_ONLY
            if n == m or n.startswith(m + ".")}


def test_scan_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.api\nfrom repro.core import x\n"
                 "from . import y\nimport jax.numpy as jnp\n"
                 "from hepbench import inputs, traffic\n"
                 "from hepbench.reference.bnn import parse\n"
                 "import repro_torch.bnn.models\n")
    assert top_level_imports(f) == {"repro_torch", "repro", "jax",
                                    "hepbench"}
    assert family_only_imports(f) == {"hepbench.inputs",
                                      "hepbench.reference.bnn",
                                      "hepbench.reference.bnn.parse",
                                      "repro_torch.bnn.models"}


@pytest.mark.parametrize("path", sorted(FOLDER.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(FOLDER)))
def test_no_banned_import(path):
    names = top_level_imports(path)
    assert not names & BANNED
    if "reference" in path.relative_to(FOLDER).parts:
        assert names <= {"__future__", "dataclasses", "re", "typing",
                         "numpy", "torch"}


@pytest.mark.parametrize("name", HARNESS)
def test_harness_leaves_the_network_to_its_family(name):
    """Only a family file (``families/hepbnn.py``) reaches the paper's
    reference, its seeded inputs and the port's BNN models."""
    assert not family_only_imports(FOLDER / name)
