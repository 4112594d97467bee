"""``BENCHMARK.json`` and the files it names, found by name.

A cell names its configuration and its traffic; the configuration's entry
names its file; a traffic mix is ``benchmark/traffic/<traffic>.json``; a
per-layer metric is read by ``benchmark/metrics/<metric>.py`` (a function
``read(record)``); the kernels of a layer are ``benchmark/layers/<layer>.json``.
Every path is taken from the root that holds ``BENCHMARK.json``, so a
checkout, or a test's own folder, adds files without editing any that exist.
"""

import importlib.util
import json
from pathlib import Path


class Spec:
    def __init__(self, root="."):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def find(self, rel: str) -> Path:
        path = self.root / rel
        if not path.exists():
            raise FileNotFoundError(f"benchmark file {rel!r} not found under "
                                    f"{self.root}")
        return path

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == cell["config"]:
                return json.loads(self.find(c["file"]).read_text())
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return json.loads(
            self.find(f"benchmark/traffic/{cell['traffic']}.json").read_text())

    def layer_dir(self) -> Path:
        return self.root / "benchmark" / "layers"

    def metrics(self, kind: str, cell: dict) -> list:
        """The entries of ``kind`` ("end_to_end" or "per_layer") that the
        cell reports: those listing it, and those with no list."""
        return [m for m in self.bench[kind]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.find(f"benchmark/metrics/{metric}.py")
        mod_spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read
