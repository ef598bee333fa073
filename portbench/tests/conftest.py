"""The harness's CPU tests: ``portbench/`` on the path, and the cells of
``BENCHMARK.json`` cut to a size the CPU runs in seconds (narrow heads,
small crops, float32 compute so that a sound run meets the limits)."""

from __future__ import annotations

import copy
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness import bench, env  # noqa: E402

env.prepare()

TINY = {
    "flagship": {"image_size": 64,
                 "options": {"vit_heads": 2, "compute_dtype": "float32"},
                 "model": {"token_dim": 64, "heads": 2}},
    "vip": {"image_size": 32,
            "options": {"compute_dtype": "float32"},
            "model": {"tokens": 65}},
}
TINY_TRAFFIC = {
    "train": {"batch": 4, "trace_steps": 1},
    "serve": {"sizes": [3, 9], "size_bins": 8, "pool": 16,
              "check_requests": 3, "trace_requests": 2},
}


def tiny_cell(name: str) -> bench.Cell:
    """The cell ``name`` at the CPU tests' size."""
    cell = bench.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cut = TINY[cell.entry["config"]]
    cell.config["image_size"] = cut["image_size"]
    for part in ("options", "model"):
        cell.config[part].update(cut[part])
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC[cell.traffic["driver"]])
    return cell


@pytest.fixture(autouse=True)
def _artifacts(tmp_path_factory, monkeypatch):
    """Exported artifacts go to a temporary directory of the session."""
    monkeypatch.setattr(env, "ARTIFACTS",
                        str(tmp_path_factory.getbasetemp() / "artifacts"))
