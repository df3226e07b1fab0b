"""The port stands alone: no JAX or JAX-package import anywhere in
``src/repro_torch`` or ``chip_smoke.py``, an ``__all__`` in every
package ``__init__``, and entry points that refuse to run without a card
unless the caller asks for the CPU."""

from __future__ import annotations

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCANNED = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def forbidden_imports(source: str) -> list:
    """(line, module) of every import of jax or of the JAX package."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names
                    if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append((node.lineno, node.module))
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append((node.lineno, node.args[0].value))
    return bad


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert forbidden_imports(path.read_text()) == []


@pytest.mark.parametrize("src", [
    "import jax",
    "import jax.numpy as jnp",
    "from jax import lax",
    "import repro",
    "from repro.bnn import layers",
    "import repro.core.mapper as m",
    "importlib.import_module('repro.core')",
    "def f():\n    from jax.experimental import pallas",
])
def test_scan_catches_forbidden_imports(src):
    assert forbidden_imports(src)


def test_scan_allows_the_port_itself():
    assert forbidden_imports(
        "import repro_torch\nfrom repro_torch.core import mapper\n"
        "import torch\nimport numpy as np"
    ) == []


def test_scan_covers_the_whole_port():
    names = {p.name for p in SCANNED}
    assert {"chip_smoke.py", "xnor_popcount.py", "segment_fused.py",
            "engine.py", "profiler.py", "flash_attention.py", "ops.py",
            "transformer.py", "steps.py", "serve.py", "telemetry.py",
            "drift.py", "controller.py", "hillclimb.py", "profile_store.py",
            "backends.py", "workqueue.py", "jobs.py", "service.py",
            "api.py", "ledger.py", "scheduler.py", "router.py", "subnet.py",
            "planner.py", "dispatch.py", "placement.py", "host.py",
            "cluster.py", "tree.py", "train.py", "optimizers.py",
            "schedules.py", "compression.py", "synthetic.py", "loader.py",
            "checkpoint.py", "loop.py", "moe.py", "mamba2.py",
            "dryrun.py", "trace_analysis.py", "mesh.py"} <= names
    packages = {p.parent.name for p in SCANNED if p.name == "__init__.py"}
    assert {"adapt", "store", "cachesvc", "fleet", "elastic",
            "cluster", "optim", "data", "ckpt", "runtime"} <= packages


@pytest.mark.parametrize(
    "pkg", sorted(p.parent for p in PORT.rglob("__init__.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_every_package_defines_all(pkg):
    tree = ast.parse((pkg / "__init__.py").read_text())
    names = [
        t.id for n in tree.body if isinstance(n, ast.Assign)
        for t in n.targets if isinstance(t, ast.Name)
    ]
    assert "__all__" in names
    mod = importlib.import_module(
        ".".join(pkg.relative_to(ROOT / "src").parts))
    for name in mod.__all__:
        assert hasattr(mod, name), name


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")


def _small():
    from repro_torch.bnn.models import build_model, pack_params, random_fp_params
    from repro_torch.core.mapper import price_mapping
    from repro_torch.core.profiler import ProfileTable
    from repro_torch.core.parallel_config import CONFIGS

    m = build_model("fashion_mnist", scale=0.25)
    packed = pack_params(m.specs, random_fp_params(m.specs, 0), device="cpu")
    n = len(m.specs)
    row = [{c: 1e-4 for c in CONFIGS} for _ in range(n)]
    table = ProfileTable(
        m.name, (2,), tuple(f"L{s.idx}:{s.notation}" for s in m.specs),
        {2: row}, kernel_times={2: row},
        h2d_times={2: [0.0] * n}, d2h_times={2: [0.0] * n},
    )
    return m, packed, price_mapping(table, 2, ("XYZ",) * n), table


def test_resolve_device_defaults_to_cuda_and_raises_without_it():
    from repro_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


@pytest.mark.parametrize("entry", [
    "ServingEngine", "SegmentPipeline", "profile_bnn_model",
    "build_mapped_model", "pack_params", "fuse_mapping",
    "greedy_decode", "init_params", "launch.serve", "api.plan_single",
    "api.plan_fleet", "api.Deployment.plan", "api.Deployment.serve",
    "cluster.Cluster", "elastic.ElasticEngine", "elastic.plan_family",
    "init_train_state", "BNNModel.init", "fp_params_from_numpy",
    "train_state_from_numpy",
])
def test_entry_points_raise_without_a_card(entry):
    from repro_torch import api, configs
    from repro_torch.bnn.models import (
        fp_params_from_numpy, pack_params, random_fp_params,
    )
    from repro_torch.bnn.train import init_train_state, train_state_from_numpy
    from repro_torch.cluster import Cluster
    from repro_torch.elastic import ElasticEngine, plan_family
    from repro_torch.core import (
        build_mapped_model, fuse_mapping, profile_bnn_model,
    )
    from repro_torch.core.profiler import ProfileTable
    from repro_torch.launch import serve
    from repro_torch.models import greedy_decode, init_params
    from repro_torch.serving import SegmentPipeline, ServingEngine

    _no_card()
    m, packed, ec, table = _small()
    tp = api.TenantPlan(name=m.name, model=m, packed=packed, table=table,
                        config=ec)
    planned = api.Deployment.plan(
        (m, packed), batch_sizes=(2,), time_source="analytic", repeats=1,
        device="cpu", elastic=(1.0, 0.5))
    levels = planned.tenants[m.name].elastic
    cfg = configs.get_smoke("qwen2_0_5b")
    gen = torch.Generator().manual_seed(0)
    calls = {
        "ServingEngine": lambda: ServingEngine(m, packed, ec),
        "SegmentPipeline": lambda: SegmentPipeline(m, packed, ec),
        "profile_bnn_model": lambda: profile_bnn_model(
            m, packed, batch_sizes=(1,), repeats=1),
        "build_mapped_model": lambda: build_mapped_model(m, packed, ec),
        "pack_params": lambda: pack_params(
            m.specs, random_fp_params(m.specs, 0)),
        "fuse_mapping": lambda: fuse_mapping(
            m, packed, ProfileTable(m.name, (2,), ec.layer_labels, {}), ec),
        "greedy_decode": lambda: greedy_decode(
            cfg, init_params(cfg, gen, "cpu"), np.zeros((1, 4), np.int64),
            n_steps=2, max_len=8),
        "init_params": lambda: init_params(cfg, gen),
        "launch.serve": lambda: serve.main(["--arch", "qwen2_0_5b"]),
        "api.plan_single": lambda: api.plan_single(
            m, packed, batch_sizes=(2,), repeats=1),
        "api.plan_fleet": lambda: api.plan_fleet(
            {"a": (m, packed)}, batch_sizes=(2,), repeats=1),
        "api.Deployment.plan": lambda: api.Deployment.plan(
            (m, packed), batch_sizes=(2,), repeats=1),
        "api.Deployment.serve": lambda: api.Deployment(
            tenants=planned.tenants).serve(),
        "cluster.Cluster": lambda: Cluster([tp], n_hosts=1,
                                           batch_sizes=(2,)),
        "elastic.ElasticEngine": lambda: ElasticEngine(levels),
        "elastic.plan_family": lambda: plan_family(
            levels.family, batch_sizes=(2,), repeats=1),
        "init_train_state": lambda: init_train_state(m, gen),
        "BNNModel.init": lambda: m.init(gen),
        "fp_params_from_numpy": lambda: fp_params_from_numpy(
            random_fp_params(m.specs, 0)),
        "train_state_from_numpy": lambda: train_state_from_numpy(
            init_train_state(m, gen, device="cpu")[0]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
