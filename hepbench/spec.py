"""Finds a cell's configuration, traffic mix and metric readers by name.

Everything that belongs to one configuration, mix or metric is a file of
its own under the benchmark's folder, found by the name that
``BENCHMARK.json`` gives it:

* a configuration: the file its ``configs`` entry names (JSON);
* a traffic mix: ``hepbench/traffic/<traffic>.json``;
* a metric, end-to-end or per-layer: ``hepbench/metrics/<name>.py``,
  whose ``read(run)`` returns the number, or None where the run holds
  nothing to read (the metric is then left out of the line).

So a later change adds a configuration, a mix, a cell or a metric by
adding files and entries, and edits no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

FOLDER = "hepbench"


class Bench:
    """``BENCHMARK.json`` at `root` and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers: dict = {}

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
