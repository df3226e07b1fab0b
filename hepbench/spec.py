"""Finds a cell's configuration, family, traffic mix and metric readers by
name.

Everything that belongs to one configuration, family, mix or metric is a
file of its own under the benchmark's folder, found by the name that
``BENCHMARK.json`` or a configuration gives it:

* a configuration: the file its ``configs`` entry names (JSON);
* its network family: ``hepbench/families/<family>.py``, where
  ``<family>`` is the configuration's ``"family"`` key (``hepbnn``, the
  paper's ``C``/``MP``/``S``/``FLAT``/``FC`` grammar, where it has none);
* a traffic mix: ``hepbench/traffic/<traffic>.json``;
* a metric, end-to-end or per-layer: ``hepbench/metrics/<name>.py``,
  whose ``read(run)`` returns the number, or None where the run holds
  nothing to read (the metric is then left out of the line).

So a later change adds a configuration, a family, a mix, a cell or a
metric by adding files and entries, and edits no file that is there.

Adding a family.  ``families/<family>.py`` holds all that the harness
knows of one kind of network, in five parts:

1. ``inputs(config, seed_weights, seed_images, device, pool)`` returns
   ``(net, weights, images)``: the family's description of the network
   (a run's ``Run.layers``, which its readers read), its weights, and
   ``pool`` images, all made from the two seeds on ``device``, in a few
   large calls of a ``torch.Generator`` there, in the type they are
   served in.  The same seeds give the same tensors.
2. ``build_program(config, weights, images, device, store)`` returns a
   ``harness.Program``: a ``repro_torch.api.Deployment`` planned with
   the profile store `store` and serving, its served configuration, one
   request payload per pool image (what the client submits), and the
   batch sizes the batcher pads to.  The deployment is the one served
   path; whatever the program derives from the weights (packing, scales)
   happens here, and counts as set-up.
3. ``expected(config, net, weights, images, control=False)`` returns one
   expected answer per pool image (an array whose rows compare with the
   answers), from a plain reference under ``hepbench/reference/`` that
   takes nothing the program made; ``control=True`` returns the control:
   the same reference in the precision below the one the configuration
   states.
4. ``agree(config, answers, expected)`` returns ``(ok, checks)``: which
   answered rows agree with their expected rows, and the family's
   compared numbers, ``{name: (value, limit)}``; a run is correct when
   each is at most its limit (the harness adds ``missing_answers``,
   limit 0).  An exact family compares with ``==``.  A float family,
   whose program and reference add in a different order, states its
   tolerance in its configuration file and the reason for it, and each
   limit is set from the program's readings and the control's, as
   ``PERF.md`` records.
5. ``KERNELS``: each counting wrapper of ``repro_torch.kernels`` that
   the family's mapping launches -> the CUDA kernel's name as the
   profiler prints it, so that a traced slice counts and times them.

The operations and bytes of a new kernel are counted in a benchmark file
of the family (as ``roofline.py`` counts ``hepbnn``'s), and its readers
are new files under ``metrics/``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

FOLDER = "hepbench"
DEFAULT_FAMILY = "hepbnn"


class Bench:
    """``BENCHMARK.json`` at `root` and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers: dict = {}
        self._families: dict = {}

    def cell(self, name: str) -> dict:
        for cell in self.doc["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.doc["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def family(self, config: dict):
        """The module ``families/<family>.py`` of a configuration."""
        name = config.get("family", DEFAULT_FAMILY)
        if name not in self._families:
            path = self.root / FOLDER / "families" / f"{name}.py"
            module_name = f"hepbench_family_{name}"
            spec = importlib.util.spec_from_file_location(module_name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[module_name] = module      # dataclasses look it up
            spec.loader.exec_module(module)
            self._families[name] = module
        return self._families[name]

    def traffic(self, name: str) -> dict:
        path = self.root / FOLDER / "traffic" / f"{name}.json"
        return json.loads(path.read_text())

    def metrics(self, cell: str, kind: str) -> list:
        """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
        reports: those that list it, and those with no list that every
        cell reports (end-to-end) or that move an end-to-end metric the
        cell reports (per-layer)."""
        def listed(m):
            return cell in m.get("workloads", (cell,))

        e2e = {m["name"] for m in self.doc["end_to_end"] if listed(m)}
        return [m for m in self.doc[kind] if listed(m) and (
            "workloads" in m or kind == "end_to_end" or m["moves"] in e2e)]

    def reader(self, name: str):
        """The ``read`` function of ``metrics/<name>.py``."""
        if name not in self._readers:
            path = self.root / FOLDER / "metrics" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                f"hepbench_metric_{len(self._readers)}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._readers[name] = module.read
        return self._readers[name]
