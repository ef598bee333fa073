"""The port's spans (``utils/profiling.span``) on the CPU: no-op while no
profiler records, ``record_function`` ranges under one, the train
step's phases with the flagship's model spans inside the forward; and
the CUDA-graph runner's replay tally on a stand-in graph.  The
serving spans are counted in ``tests/test_torch_slice.py``; that no
span reaches an exported program, in ``tests/test_torch_export.py``."""

import contextlib

import pytest
import torch

from scat_tpu_torch import assets, serving
from scat_tpu_torch.models.hand_net import EncoderTransformer
from scat_tpu_torch.ops import COUNTED, attention
from scat_tpu_torch.training import schedule, steps
from scat_tpu_torch.training.state import TrainState
from scat_tpu_torch.utils import profiling

IMG = 32
CPU = [torch.profiler.ProfilerActivity.CPU]


def _events(prof, name):
    return [e for e in prof.events() if e.name == name]


def test_span_without_a_profiler_enters_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = profiling.span(profiling.SPANS[0])
    for name in profiling.SPANS:
        assert profiling.span(name) is off
        with profiling.span(name):
            torch.ones(2).sum()


@pytest.mark.parametrize("name", profiling.SPANS)
def test_span_under_a_profiler_is_a_range_with_its_parent(name):
    with torch.profiler.profile(activities=CPU) as prof:
        with torch.profiler.record_function("outer"):
            with profiling.span(name):
                torch.ones(2).sum()
    (got,) = _events(prof, name)
    assert got.cpu_parent is not None and got.cpu_parent.name == "outer"
    assert "aten::sum" in {c.name for c in got.cpu_children}


def test_a_span_outside_spans_raises():
    with pytest.raises(ValueError, match="unknown span"):
        profiling.span("scat.train.step")
    with torch.profiler.profile(activities=CPU):
        with pytest.raises(ValueError, match="unknown span"):
            profiling.span("scat.serve.request")


def test_train_step_spans_nest_the_model_in_the_forward():
    """One step of a small flagship (resnet18, 32 px, 2 heads) under a
    CPU profiler: the forward, backward and optimizer spans once each,
    outermost (no span around the step), and the encoder and token spans
    once each inside the forward."""
    mean = torch.from_numpy(assets.load_mean_params())
    model = EncoderTransformer(mean, iteration=1, heads=2,
                               token_dim=(IMG // 8) ** 2, mask_rate=0.2,
                               backbone="resnet18", use_kernel=True)
    optimizer, scheduler = schedule.make_optimizer(model, 5e-4, 4)
    state = TrainState.create(model, optimizer, scheduler, seed=0)
    gen = torch.Generator().manual_seed(0)
    joints = mean[3:66].reshape(1, 21, 3) + 0.02 * torch.randn(
        2, 21, 3, generator=gen)
    batch = {"image": torch.rand(2, IMG, IMG, 3, generator=gen) * 2 - 1,
             "label": torch.cat([(joints - joints[:, 1:2]).reshape(2, 63),
                                 torch.rand(2, 42, generator=gen) * IMG],
                                1)}
    step = steps.make_train_step(1e5, 10.0)
    with torch.profiler.profile(activities=CPU) as prof:
        step(state, batch)
    phases = {}
    for phase in ("forward", "backward", "optimizer"):
        (phases[phase],) = _events(prof, f"scat.train.{phase}")
        assert phases[phase].cpu_parent is None, phase
    for part in ("encoder", "tokens"):
        (got,) = _events(prof, f"scat.model.{part}")
        parent = got.cpu_parent
        while parent is not None and parent.name != "scat.train.forward":
            parent = parent.cpu_parent
        assert parent is phases["forward"], part
    fwd = phases["forward"].time_range
    assert fwd.end <= phases["backward"].time_range.start
    assert phases["backward"].time_range.end <= \
        phases["optimizer"].time_range.start


class _StandInGraph:
    """A CUDA graph's stand-in: a replay reruns nothing on the host."""

    def replay(self):
        pass


class _StandInStream:
    def wait_stream(self, other):
        pass


def test_graph_runner_replays_add_their_capture_launches(monkeypatch):
    """The runner notes how far each kernel's launch counter moved in a
    capture (not in the eager warm-up run before it), and every replay
    adds that much to its own tally; the counters count the warm-up run
    and the capture alone."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device=None: _StandInStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _StandInStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())

    def forward(x):   # three attention layers' launches a forward
        attention.flash_attention.launches += 3
        return (x * 2,)

    runner = serving.GraphRunner(forward, "cpu")
    start = {n: w.launches for n, w in COUNTED.items()}
    runner(torch.ones(4))                     # warm-up, capture, replay
    assert runner.replayed == {"flash_attention": 3}
    runner(torch.ones(4))                     # a replay
    runner.capture((4,), torch.float32)       # captured already
    assert runner.replayed == {"flash_attention": 2 * 3}
    moved = {n: w.launches - start[n] for n, w in COUNTED.items()}
    assert moved == dict.fromkeys(start, 0) | {"flash_attention": 3 + 3}
    assert runner.keys == [((4,), torch.float32)]
