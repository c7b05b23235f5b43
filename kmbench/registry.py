"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

  * ``configs[].file``: the configuration, a JSON file under ``kmbench/configs/``;
  * ``kmbench/traffic/<traffic>.json``: the traffic mix, whose ``driver``
    names ``kmbench/drivers/<driver>.py``;
  * ``kmbench/metrics/<metric>.py``: the reader of each metric, a
    function ``read(data) -> float or None``;
  * ``kmbench/limits/<workload>.json``: the limits of the cell's output
    check.

So a later change adds a configuration, a mix, a driver, a metric or a
cell's limits by adding a file and an entry, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def _json(path: Path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = _json(self.root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
        self.name = name
        self.entry = entries[name]
        config = next(c for c in self.bench["configs"] if c["name"] == self.entry["config"])
        self.config = _json(self.root / config["file"])
        self.traffic = _json(self.root / "kmbench" / "traffic" / f"{self.entry['traffic']}.json")
        limits = self.root / "kmbench" / "limits" / f"{name}.json"
        self.limits = _json(limits) if limits.exists() else {}

    def driver(self):
        return load(self.root / "kmbench" / "drivers" / f"{self.traffic['driver']}.py")

    def end_to_end(self):
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"] if self._has(m)]

    def per_layer(self):
        """The per-layer metrics this cell reports: those that list it, and
        those that list no cells where the cell reports what they move."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in mine)]

    def _has(self, metric) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric_name: str):
        return load(self.root / "kmbench" / "metrics" / f"{metric_name}.py").read


def load(path: Path):
    """Import a module of the benchmark by its file (its name may hold
    dots and dashes)."""
    path = Path(path)
    name = "kmbench_file_" + re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
