"""The seeded traffic: request sizes, the request plan, the batch pool,
and weights and inputs that repeat for a seed."""

import numpy as np
import pytest
import torch

from harness import runner, seeded

from conftest import tiny_cell


def test_request_sizes_span_the_law_and_its_mean():
    sizes = seeded.log_uniform_sizes(8, 256, 256)
    assert sizes.min() == 8 and 250 <= sizes.max() <= 256
    # the log-uniform law on [8, 256]: mean (256 - 8) / ln 32 = 71.6
    assert abs(sizes.mean() - 248 / np.log(32)) < 0.02 * 71.6
    assert len(set(sizes.tolist())) > 100


def test_one_size_serves_requests_of_that_size_at_seeded_offsets():
    plan = seeded.request_plan(2**31 + 5, 32, 32, 1, 512, 400)
    assert {n for _, n in plan} == {32}
    offsets = [off for off, _ in plan]
    assert min(offsets) >= 0 and max(offsets) <= 512 - 32
    assert len(set(offsets)) > 200


def test_every_seed_serves_the_same_sizes_in_its_own_order():
    a = seeded.request_plan(1, 8, 256, 256, 512, 512)
    b = seeded.request_plan(2**31 + 11, 8, 256, 256, 512, 512)
    assert sorted(n for _, n in a[:256]) == sorted(n for _, n in b[:256])
    assert [n for _, n in a[:256]] != [n for _, n in b[:256]]
    assert a == seeded.request_plan(1, 8, 256, 256, 512, 512)
    for off, n in a + b:
        assert 0 <= off and off + n <= 512


@pytest.mark.parametrize("name", ["flagship-train", "vip-train"])
def test_the_batch_pool_is_distinct_and_repeats_for_a_seed(name):
    from drivers import train
    cell = tiny_cell(name)
    ctx = runner.Context(cell, 2**31 + 3, 0, False, "cpu")
    pool = train.make_batches(ctx)
    assert len(pool) == cell.traffic["pool"]
    size = cell.config["image_size"]
    for b in pool:
        assert b["image"].shape == (cell.traffic["batch"], size, size, 3)
        assert b["image"].abs().max() <= 1.0
        assert b["label"].shape == (cell.traffic["batch"], 105)
    flat = torch.stack([b["image"] for b in pool]).flatten(2)
    for i in range(len(pool)):
        for j in range(i + 1, len(pool)):
            assert not torch.equal(flat[i], flat[j])
    again = train.make_batches(ctx)
    assert all(torch.equal(x["image"], y["image"]) for x, y in zip(pool, again))


def test_weights_follow_the_rules_and_repeat_for_a_seed():
    shapes = {"a.weight": ((64, 32), torch.float32),
              "a.bias": ((64,), torch.float32),
              "bn1.weight": ((8,), torch.float32),
              "bn1.running_var": ((4096,), torch.float32),
              "bn1.num_batches_tracked": ((), torch.int64)}
    rules = [["num_batches_tracked$", "zero"],
             ["running_var$", "uniform", 1.0, 0.25],
             ["bn\\d\\.weight$", "normal", 1.0, 0.1],
             ["(weight|bias)$", "uniform", 0.0, "fan_in"]]
    w = seeded.weights(shapes, rules, 7, "cpu")
    assert w["bn1.num_batches_tracked"].dtype == torch.int64
    assert int(w["bn1.num_batches_tracked"]) == 0
    var = w["bn1.running_var"]
    assert 0.75 <= var.min() and var.max() <= 1.25
    assert w["a.weight"].abs().max() <= 32 ** -0.5
    assert w["a.bias"].abs().max() <= 32 ** -0.5   # the weight's fan_in
    again = seeded.weights(dict(reversed(list(shapes.items()))), rules, 7,
                           "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    with pytest.raises(KeyError):
        seeded.weights({"x.unknown": ((2,), torch.float32)}, rules, 7, "cpu")
