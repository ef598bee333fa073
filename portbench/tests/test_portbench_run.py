"""A run without the card prints no result and fails; so does one in a
checkout that holds only BENCHMARK.json and the benchmark's files."""

import os
import shutil
import subprocess
import sys

import torch

import run
from harness import env


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "flagship-train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA device" in out.err


def test_fewer_cards_than_the_cell_asks_for(monkeypatch):
    from harness import runner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    try:
        runner.require_devices(1)
    except RuntimeError as err:
        assert "asks for 1" in str(err)
    else:
        raise AssertionError("require_devices passed without a device")


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(os.path.join(env.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(env.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "flagship-train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
