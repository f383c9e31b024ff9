"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root names the cells; a cell's configuration is
the file its entry names, its traffic mix ``benchmark/traffic/<traffic>.json``,
its limits ``benchmark/limits/<cell>.json`` and each per-layer metric's
reader ``benchmark/metrics/<metric>.py`` (a function ``read(run)`` that
returns a number or None). Adding a cell, a configuration or a metric is
adding files and entries.

The configuration file names its plain reference (``reference``: a module
with ``build``, ``train_steps``, ``score`` and ``batch_of``) and its
weights maker (``weights``: a module with ``make``); the traffic file
names its generator (``generator``: a module with ``dataset``). Both
files carry a ``program`` dict of the port's ``TrainConfig`` fields, which
the harness passes on unchanged. ``Cell.config`` is the configuration
with its ``program`` fields at the top level, as the yardstick reads it.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path


@dataclasses.dataclass
class Cell:
    root: Path
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def reader(self, metric: str):
        path = self.root / "benchmark" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def generator(self):
        return importlib.import_module(self.traffic["generator"])

    def reference(self):
        return importlib.import_module(self.config["reference"])

    def weights(self):
        return importlib.import_module(self.config["weights"])

    def program(self) -> dict:
        """The ``TrainConfig`` fields that the configuration and the
        traffic set."""
        both = set(self.config["program"]) & set(self.traffic["program"])
        if both:
            raise ValueError(f"{self.name}: {sorted(both)} set by both the "
                             "configuration and the traffic")
        return {**self.config["program"], **self.traffic["program"]}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def flat_config(conf: dict) -> dict:
    """The configuration with its ``program`` fields at the top level."""
    both = set(conf) & set(conf["program"])
    if both:
        raise ValueError(f"{conf['name']}: {sorted(both)} set both inside "
                         "and outside 'program'")
    return {**conf["program"], **conf}


def load(root, workload: str) -> Cell:
    root = Path(root).resolve()
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {', '.join(sorted(cells))}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(root, bench, w, flat_config(_json(root / conf["file"])),
                _json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
                _json(root / "benchmark" / "limits" / f"{workload}.json"))
