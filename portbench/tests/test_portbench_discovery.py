"""Cells, configurations, mixes, drivers and per-layer metrics are found
by the names BENCHMARK.json gives them; a new metric is a new file and a
new entry; BENCHMARK.json keeps the contract's form."""

import json
import os
import re

import pytest

from harness import bench, env

BENCH = bench.load_json(os.path.join(env.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert len(m["layer"]) <= 200 and "\n" not in m["layer"]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_found_whole(name):
    cell = bench.load_cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.driver().run
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    readers = cell.metric_readers()
    assert set(readers) == {m["name"] for m in cell.per_layer}
    assert set(cell.config["limits"][cell.traffic["driver"]])


def test_a_new_metric_is_a_new_file(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "busy_ms.train.py").write_text(
        "def read(trace, work, config, traffic):\n"
        "    return 1e3 * work['window_s']\n")
    extended = json.loads(json.dumps(BENCH))
    extended["per_layer"].append(
        {"name": "busy_ms.train", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "device",
         "moves": "train_device_us_per_crop.flagship",
         "workloads": ["flagship-train"]})
    cell = bench.load_cell("flagship-train", extended)
    cell.bench_dir = str(tmp_path)
    cell.per_layer = [m for m in cell.per_layer
                      if m["name"] == "busy_ms.train"]
    readers = cell.metric_readers()
    assert readers["busy_ms.train"].read(None, {"window_s": 0.5}, {}, {}) \
        == 500.0


@pytest.mark.parametrize("name, quantity", [
    ("flagship-train", "train_device_us_per_crop"),
    ("vip-train", "train_crops_per_s"),
    ("flagship-serve", "serve_crops_per_s"), ("vip-serve", "serve_p95_ms")])
def test_a_group_metric_reports_its_quantity(name, quantity):
    """An end-to-end metric <quantity>.<group> carries the value the
    driver gives <quantity>; each cell reports one of a quantity's."""
    cell = bench.load_cell(name)
    mine = [m["name"] for m in cell.end_to_end
            if m["name"].split(".")[0] == quantity]
    assert len(mine) == 1


def test_metric_without_workloads_follows_its_end_to_end_metric():
    metric = {"name": "x", "moves": "serve_p95_ms"}
    assert bench.reports(metric, "any", {"serve_p95_ms"})
    assert not bench.reports(metric, "any", {"train_crops_per_s"})
    assert bench.reports({"name": "setup_s"}, "any")


def test_configurations_state_their_source_and_cuts():
    for c in BENCH["configs"]:
        config = bench.load_json(os.path.join(env.ROOT, c["file"]))
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"] == []
        assert config["name"] == c["name"]


def test_a_full_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
