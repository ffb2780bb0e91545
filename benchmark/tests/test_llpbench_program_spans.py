"""The readers of the program's spans (``llpbench/program_spans.py`` and
``metrics/step_device_ms.*``, ``eval_device_ms``, ``device_idle_share.step``
and ``.eval``) on a made-up slice and span list: per-step averages, idle
gaps put down to the span open at each gap's start through the program's
marker, and None where there is nothing to read."""

from types import SimpleNamespace

import pytest

from llp_tpu_torch.utils import profiling
from llpbench import program_spans as P
from llpbench import spec
from llpbench.trace import Slice

MARKER = "llp_trace_marker_kernel(int*)"
OFFSET_US = 5_000.0        # trace µs - host µs
TIE_S = 0.001              # the host time of the marker's launch


class Tree:
    """Spans in start order, on the host clock (ms from 0)."""

    def __init__(self):
        self.spans, self.stack = [], []

    def add(self, name, t0_ms, t1_ms, device_ms=None):
        parent = None
        while self.stack and self.stack[-1].t1 < t1_ms * 1e-3:
            self.stack.pop()
        if self.stack:
            parent = self.stack[-1]
        sp = SimpleNamespace(name=name, parent=parent, t0=t0_ms * 1e-3, t1=t1_ms * 1e-3,
                             device_ms=device_ms, counts={})
        self.spans.append(sp)
        self.stack.append(sp)
        return sp


def _tree(model="teacher"):
    """An epoch of two steps (0-20 ms) and an eval (21-30 ms)."""
    t = Tree()
    t.add(f"{model}.epoch", 0, 20, 20.0)
    for i, t0 in enumerate((0.5, 10)):
        t.add(f"{model}.step", t0, t0 + 9, 9.0)
        t.add(f"{model}.sample", t0, t0 + 1, 1.0 + i)
        t.add(f"{model}.forward", t0 + 1, t0 + 4, 3.0)
        t.add(f"{model}.backward", t0 + 4, t0 + 7, 3.0)
        t.add(f"{model}.allreduce", t0 + 5, t0 + 6, 1.0)
        t.add(f"{model}.optimizer", t0 + 7, t0 + 9, 2.0)
    t.add("eval", 21, 30, 8.0)
    t.add("eval.encode", 21, 24, 4.0)
    t.add("eval.score", 24, 27, 3.0)
    t.add("eval.metrics", 27, 30, 1.0)
    return t.spans


def _session(spans):
    s = profiling.Session.__new__(profiling.Session)
    s.spans, s.stack, s.cuda = spans, [], True
    s.marker, s.ties = profiling.MARKER_KERNEL, [TIE_S]
    s.resolve = lambda: None
    return s


def _on_trace(host_ms):
    return host_ms * 1e3 + OFFSET_US


def _slice(busy_ms):
    """A slice over host 0-30 ms whose device is busy in ``busy_ms``
    intervals; the marker kernel at the tie."""
    kernels = [(MARKER, TIE_S * 1e6 + OFFSET_US, 1.0)]
    kernels += [("k", _on_trace(a), (b - a) * 1e3) for a, b in busy_ms]
    return Slice(start_us=_on_trace(0), stop_us=_on_trace(30), kernels=kernels, spans=[])


@pytest.fixture
def ctx(monkeypatch):
    def make(spans, busy_ms=((0, 30),)):
        session = _session(spans)
        monkeypatch.setattr(profiling, "last_session", lambda: session)
        return SimpleNamespace(slice=_slice(busy_ms))
    return make


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


@pytest.mark.parametrize("model", ["teacher", "student"])
def test_per_step_device_ms(ctx, model):
    c = ctx(_tree(model))
    got = {p: _read(f"step_device_ms.{p}", c) for p in ("sample", "forward", "backward",
                                                        "optimizer")}
    # the allreduce is the backward's child and counts once, inside it
    assert got == {"sample": 1.5, "forward": 3.0, "backward": 3.0, "optimizer": 2.0}
    assert _read("eval_device_ms", c) == 8.0


def test_idle_gaps_go_to_the_span_open_at_their_start(ctx):
    # idle: 2-3 ms (sample of step 0 opens at 0.5, forward at 1: forward),
    # 20-21 ms (between the epoch and the eval: neither), 28-29.5 ms (metrics)
    c = ctx(_tree(), busy_ms=((0, 2), (3, 20), (21, 28), (29.5, 30)))
    share = {k: _read(f"device_idle_share.{k}", c) for k in ("step", "eval")}
    assert share["step"] == pytest.approx(100 * 1.0 / 30)
    assert share["eval"] == pytest.approx(100 * 1.5 / 30)
    by_kind = P.idle_by_kind(c)
    assert by_kind[None] == pytest.approx(1000.0) and sum(by_kind.values()) == pytest.approx(
        3500.0)


def test_the_marker_moves_the_spans_onto_the_trace(ctx):
    # a gap from 19.8 ms of the trace's clock opens between the steps and the
    # eval; with the marker 1 ms later every span lands 1 ms later on the
    # trace, and the gap opens inside step 1's optimizer (17-19 ms)
    spans = _tree()
    c = ctx(spans, busy_ms=((0, 19.8), (21, 30)))
    assert _read("device_idle_share.step", c) == 0.0
    c.slice.kernels[0] = (MARKER, TIE_S * 1e6 + OFFSET_US + 1000.0, 1.0)
    assert P.session(c)[1] == pytest.approx(OFFSET_US + 1000.0)
    assert P.innermost(spans, [s.t0 for s in spans], 18.8e-3).name == "teacher.optimizer"
    assert _read("device_idle_share.step", c) == pytest.approx(100 * 1.2 / 30)
    assert _read("device_idle_share.eval", c) == 0.0


def test_nothing_to_read_is_none(ctx, monkeypatch):
    names = ["step_device_ms.sample", "step_device_ms.forward", "step_device_ms.backward",
             "step_device_ms.optimizer", "eval_device_ms", "device_idle_share.step",
             "device_idle_share.eval"]
    c = ctx([])
    assert all(_read(n, c) is None for n in names)          # no spans
    c = ctx(_tree())
    c.slice.kernels = c.slice.kernels[1:]
    assert all(_read(n, c) is None for n in names)          # no marker in the slice
    assert all(_read(n, SimpleNamespace(slice=None)) is None for n in names)  # the CPU
    spans = _tree()
    for s in spans:
        s.device_ms = None
    c = ctx(spans)
    assert all(_read(n, c) is None for n in names[:5])       # no device times
    monkeypatch.setattr(profiling, "last_session", lambda: None)
    assert all(_read(n, c) is None for n in names)
    monkeypatch.delattr(profiling, "last_session")           # a program without spans
    assert all(_read(n, c) is None for n in names)
