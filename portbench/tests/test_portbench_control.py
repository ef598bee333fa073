"""The control, on the card at each cell's own size: the reference with
every product's operands in float8 e4m3 put in the program's place comes
out not correct against the float32 reference on three seeds
(``calibrate.py --what control`` gives the readings PERF.md lists)."""

import pytest
import torch

import calibrate
from harness import bench

CELLS = ["flagship-train", "flagship-serve", "vip-train", "vip-serve"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's size")
    cell = bench.load_cell(name)
    limits = cell.config["limits"][cell.traffic["driver"]]
    for seed in (21, 22, 23):
        got = calibrate.readings(cell, seed, "control", 0.0, 600)
        assert any(got[k] > limits[k] for k in limits), (seed, got)
