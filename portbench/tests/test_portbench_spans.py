"""The readers of the program's spans (``harness/spans.py``): host time
inside a span a step or a request of the stretch traced with the CPU
activity, and nothing where the program has no such span."""

import pytest

from harness import bench, spans, trace
from harness.trace import Event

# every metric that reads a span, and the cell it is reported in
SPAN_METRICS = {
    "forward_host_ms.train.flagship": "flagship-train",
    "backward_host_ms.train.flagship": "flagship-train",
    "optimizer_host_ms.train.flagship": "flagship-train",
    "encoder_host_ms.train.flagship": "flagship-train",
    "tokens_host_ms.train.flagship": "flagship-train",
    "upload_host_ms.serve.flagship": "flagship-serve",
    "launch_host_ms.serve.flagship": "flagship-serve",
    "fetch_wait_ms.serve.flagship": "flagship-serve",
    "upload_host_ms.serve.vip": "vip-serve",
    "launch_host_ms.serve.vip": "vip-serve",
    "fetch_wait_ms.serve.vip": "vip-serve",
}


def traces(host):
    """A stretch from 1,000 to 9,000 us with the CPU activity, holding
    ``host`` beside its own annotation."""
    with_host = trace.Trace((1000.0, 9000.0), [],
                            [Event(trace.STRETCH, 1000, 9000, 0)] + host)
    return trace.Traces(trace.Trace((0.0, 8000.0), [], []), with_host)


def requests():
    """Two requests' spans in the stretch, one before it and one after."""
    return traces([
        Event("scat.serve.upload", 500, 900, 0),      # before the stretch
        Event("scat.serve.upload", 1100, 1600, 0),
        Event("scat.serve.launch", 1600, 1800, 0),
        Event("scat.serve.fetch", 1800, 5000, 0),
        Event("scat.serve.upload", 5000, 6000, 0),
        Event("scat.serve.launch", 6000, 6100, 0),
        Event("aten::copy_", 6010, 6050, 1),
        Event("scat.serve.fetch", 6100, 8900, 0),
        Event("scat.serve.fetch", 9500, 9900, 0),     # after it
    ])


def test_span_time_is_summed_over_the_stretch_and_divided():
    work = {"trace_sizes": [32, 32]}
    t = requests()
    assert spans.host_ms(t, work, "scat.serve.upload") == pytest.approx(
        (0.5 + 1.0) / 2)
    assert spans.host_ms(t, work, "scat.serve.launch") == pytest.approx(
        (0.2 + 0.1) / 2)
    assert spans.host_ms(t, work, "scat.serve.fetch") == pytest.approx(
        (3.2 + 2.8) / 2)


def test_steps_count_before_requests_and_children_are_included():
    t = traces([Event("scat.train.forward", 1000, 4000, 0),
                Event("scat.model.encoder", 1100, 2500, 1),
                Event("scat.train.forward", 5000, 8000, 0)])
    work = {"trace_steps": 2, "trace_sizes": []}
    assert spans.host_ms(t, work, "scat.train.forward") == pytest.approx(3.0)
    assert spans.host_ms(t, work, "scat.model.encoder") == pytest.approx(
        0.7)


def test_nothing_to_read_is_none():
    t = requests()
    work = {"trace_sizes": [32, 32]}
    assert spans.host_ms(t, work, "scat.serve.request") is None
    assert spans.host_ms(traces([]), work, "scat.serve.fetch") is None
    assert spans.host_ms(None, work, "scat.serve.fetch") is None
    assert spans.host_ms(t, {"trace_sizes": []}, "scat.serve.fetch") is None
    assert spans.host_ms(t, {"trace_steps": 0}, "scat.serve.fetch") is None


@pytest.mark.parametrize("metric, cell", sorted(SPAN_METRICS.items()))
def test_every_span_metric_loads_and_reads_its_span(metric, cell):
    """Each metric is its cell's, in ms, read through its own file, and
    its span is one of the program's (each metric reads another span in
    its cell)."""
    from scat_tpu_torch.utils.profiling import SPANS
    loaded = bench.load_cell(cell)
    entry = next(m for m in loaded.per_layer if m["name"] == metric)
    assert entry["workloads"] == [cell] and entry["unit"] == "ms"
    reader = loaded.metric_readers()[metric]
    phase = {"forward": "train.forward", "backward": "train.backward",
             "optimizer": "train.optimizer", "encoder": "model.encoder",
             "tokens": "model.tokens", "upload": "serve.upload",
             "launch": "serve.launch", "fetch": "serve.fetch"}[
        metric.split("_")[0]]
    name = f"scat.{phase}"
    assert name in SPANS
    t = traces([Event(name, 2000, 2600, 0), Event(name, 3000, 3200, 0)])
    work = {"trace_steps": 2} if ".train." in metric else \
        {"trace_sizes": [32, 32]}
    assert reader.read(t, work, loaded.config, loaded.traffic) == \
        pytest.approx(0.4)
    assert reader.read(traces([]), work, loaded.config,
                       loaded.traffic) is None
