"""The comparison that decides ``correct``, at the CPU tests' size: the
reference holds the port's plain path, a sound run of each cell comes
out correct, and each fault the cell can have comes out not correct.
The runs drive the harness whole (set-up, window, traced stretch,
comparison) with the look for a card skipped."""

import pytest
import torch

from harness import port, runner, seeded

from conftest import tiny_cell

CELLS = ["flagship-train", "flagship-serve", "vip-train", "vip-serve"]
FAULTS = [("flagship-train", "unchanged"), ("flagship-train", "half_batch"),
          ("vip-train", "unchanged"), ("vip-train", "half_batch"),
          ("flagship-serve", "altered"), ("vip-serve", "altered")]


@pytest.mark.parametrize("config", ["flagship", "vip"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_reference_holds_the_ports_plain_path(config, train):
    from reference import common
    cell = tiny_cell(f"{config}-train")
    model = port.build(cell.config, 0, "cpu")
    weights = seeded.weights(seeded.shapes_of(model.state_dict()),
                             cell.config["init"], 5, "cpu")
    model.load_state_dict(weights, strict=True)
    model.train(train)
    ref = port.reference(cell.config)
    gen = torch.Generator().manual_seed(3)
    images = seeded.images(gen, 3, cell.config["image_size"])
    draw = ref.draw(torch.Generator().manual_seed(9), 3,
                    cell.config["model"]) if train else None
    inputs = {}
    if train:
        inputs = model.train_inputs(3, torch.Generator().manual_seed(9))
    with torch.no_grad():
        got = model(images.permute(0, 3, 1, 2), **inputs)[0]
        want = ref.forward(weights, images, cell.config["model"], train,
                           draw, common.F32, common.mean_template("cpu"))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    line = runner.run_cell(tiny_cell(name), 2**31 + 7, 0.3, True, "cpu")
    assert line["correct"], line["check"]
    assert list(line)[-1] == "check"
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_fault_is_not_correct(name, fault):
    line = runner.run_cell(tiny_cell(name), 2**31 + 7, 0.2, False, "cpu",
                           fault)
    assert not line["correct"], line["check"]
