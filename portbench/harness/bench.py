"""Discovery by name: a cell of ``BENCHMARK.json`` names its
configuration and its traffic mix; the configuration's entry names its
file, ``portbench/configs/<config>.json``; the traffic mix is
``portbench/traffic/<traffic>.json`` and names its driver,
``portbench/drivers/<driver>.py``; a per-layer metric is
``portbench/metrics/<metric name>.py``, loaded by path so that the dots
in a metric's name need no renaming.  A new cell, mix or metric is new
files and new entries: nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

from harness.env import BENCH_DIR, ROOT


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: Optional[str] = None):
    """The Python file at ``path`` as a module of its own."""
    name = name or "portbench_" + os.path.relpath(path, BENCH_DIR).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str = BENCH_DIR

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self):
        return load_module(os.path.join(self.bench_dir, "drivers",
                                        self.traffic["driver"] + ".py"))

    def metric_readers(self) -> Dict[str, object]:
        """The reader module of each per-layer metric of this cell."""
        return {m["name"]: load_module(os.path.join(
            self.bench_dir, "metrics", m["name"] + ".py"))
            for m in self.per_layer}


def reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: its ``workloads`` list, or,
    without one, every cell (an end-to-end metric, ``e2e_names`` None)
    or every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench: Optional[dict] = None,
              root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``)."""
    bench = bench if bench is not None else load_json(
        os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     entry["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, name, e2e_names)]
    return Cell(name, entry, config, traffic, e2e, per_layer, bench_dir)
