"""The program's spans (``llp_tpu_torch.utils.profiling``): off without a
profiler (no span, no event), the span tree of a teacher epoch with its
evaluation and of a student epoch under a CPU profiler, training bit for
bit with and without recording, and ``--profile_dir``'s Chrome trace."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from llp_tpu_torch.cli import train_teacher
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.synthetic import community_features, sbm_graph
from llp_tpu_torch.evaln.transductive import EDGE_SETS, evaluate_transductive
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.train.student import StudentTrainer, init_student
from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
from llp_tpu_torch.utils import profiling

N, D, H = 200, 16, 16
PHASES = ["sample", "forward", "backward", "optimizer"]
DATASET = "synthetic:sbm:300:4:6.0:1:48:gauss"


@pytest.fixture(scope="module")
def problem():
    ei, comm = sbm_graph(N, 4, 6.0, seed=5)
    x = torch.from_numpy(community_features(comm, D, kind="gauss", seed=5).astype(np.float32))
    pos = torch.from_numpy(ei.T.astype(np.int64).copy())
    rng = np.random.default_rng(5)
    edges = {k: torch.from_numpy(rng.integers(0, N, (40, 2)).astype(np.int64))
             for k in EDGE_SETS}
    return build_graph(ei, N, device="cpu"), x, pos, edges


def _teacher(problem):
    graph, x, pos, _ = problem
    model = init_teacher(encoder="sage", in_channels=D, hidden_channels=H, num_layers=2,
                         predictor_mode="mlp", dropout=0.5,
                         generator=torch.Generator().manual_seed(1))
    return TeacherTrainer(model, graph, x, pos, batch_size=-(-pos.shape[0] // 3), lr=0.01,
                          neg_mode="uniform")


def _student(problem):
    graph, x, pos, _ = problem
    model = init_student(in_channels=D, hidden_channels=H, num_layers=2, predictor_mode="mlp",
                         generator=torch.Generator().manual_seed(2))
    t_h = torch.randn(N, H, generator=torch.Generator().manual_seed(3))
    head = LinkPredictor("mlp", H, H, 1, 2, generator=torch.Generator().manual_seed(4))
    return StudentTrainer(model, graph, x, t_h, head, pos,
                          link_batch_size=-(-pos.shape[0] // 2), node_batch_size=N // 2,
                          neg_mode="uniform")


def _teacher_epoch_and_eval(problem):
    graph, x, _, edges = problem
    trainer = _teacher(problem)
    loss = trainer.epoch(torch.Generator().manual_seed(7))
    metrics, _ = evaluate_transductive(trainer.model["encoder"], trainer.model["predictor"],
                                       graph, x, edges)
    return trainer, loss, metrics


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.spans()


def _children(spans, parent):
    return [s.name for s in spans if s.parent is parent]


def test_no_profiler_records_nothing_and_creates_no_event(problem, monkeypatch):
    before = profiling.last_session()

    def refused(*a, **k):
        raise AssertionError("recorded without a profiler")

    monkeypatch.setattr(profiling, "Session", refused)
    monkeypatch.setattr(profiling, "Span", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    _teacher_epoch_and_eval(problem)
    assert profiling.last_session() is before
    assert profiling.span("teacher.step", pairs=1) is profiling.span("eval")


def test_a_teacher_epoch_and_its_eval_record_the_span_tree(problem):
    (trainer, _, _), spans = _recorded(lambda: _teacher_epoch_and_eval(problem))
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["teacher.epoch", "eval"]
    epoch, ev = roots
    assert epoch.counts == {"steps": trainer.steps} and trainer.steps == 3
    steps = [s for s in spans if s.parent is epoch]
    assert [s.name for s in steps] == ["teacher.step"] * 3
    assert sum(s.counts["pairs"] for s in steps) == 2 * trainer.num_pos
    for step in steps:
        assert _children(spans, step) == [f"teacher.{p}" for p in PHASES]
    assert _children(spans, ev) == ["eval.encode", "eval.score", "eval.metrics"]
    score = next(s for s in spans if s.name == "eval.score")
    assert score.counts == {"pairs": 4 * 40}
    for s in spans:  # host times nest; no device time on the CPU
        assert s.t0 <= s.t1 and s.device_ms is None
        if s.parent is not None:
            assert s.parent.t0 <= s.t0 and s.t1 <= s.parent.t1


def test_a_student_epoch_records_the_span_tree(problem):
    trainer = _student(problem)
    _, spans = _recorded(lambda: trainer.epoch(torch.Generator().manual_seed(8)))
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["student.epoch"]
    steps = [s for s in spans if s.parent is roots[0]]
    assert [s.name for s in steps] == ["student.step"] * trainer.steps and trainer.steps == 2
    for step in steps:
        assert _children(spans, step) == [f"student.{p}" for p in PHASES]


def test_training_is_bit_equal_with_and_without_recording(problem):
    plain, loss, metrics = _teacher_epoch_and_eval(problem)
    (rec, rec_loss, rec_metrics), spans = _recorded(lambda: _teacher_epoch_and_eval(problem))
    assert spans and torch.equal(plain.step_losses, rec.step_losses)
    assert torch.equal(loss, rec_loss) and metrics == rec_metrics
    for a, b in zip(plain.model.parameters(), rec.model.parameters()):
        assert torch.equal(a, b)
    student = [_student(problem) for _ in range(2)]
    s_loss = student[0].epoch(torch.Generator().manual_seed(8))
    (s_rec, _) = _recorded(lambda: student[1].epoch(torch.Generator().manual_seed(8)))
    assert torch.equal(s_loss, s_rec)
    for a, b in zip(student[0].model.parameters(), student[1].model.parameters()):
        assert torch.equal(a, b)


def test_profile_dir_writes_the_second_epoch_with_its_spans(tmp_path):
    out = tmp_path / "trace"
    train_teacher.main(["--device=cpu", f"--datasets={DATASET}",
                        f"--dataset_dir={tmp_path / 'data'}", f"--save_dir={tmp_path / 's'}",
                        f"--results_dir={tmp_path / 'r'}", "--epochs=3", "--eval_steps=1",
                        "--runs=1", "--hidden_channels=16", "--batch_size=2048",
                        f"--profile_dir={out}"])
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert [e["name"] for e in spans if e["args"]["parent"] is None] == ["teacher.epoch", "eval"]
    assert {e["name"] for e in spans} >= {"teacher.step", "eval.encode", "eval.score",
                                          "eval.metrics", *(f"teacher.{p}" for p in PHASES)}
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    for e in spans:  # each span lies inside one span of its parent's name
        if e["args"]["parent"] is not None:
            assert any(p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                       for p in by_name[e["args"]["parent"]])
    # on the trace's clock: the operators of the traced epoch fall inside its span
    epoch = by_name["teacher.epoch"][0]
    inside = [o for o in ops if epoch["ts"] <= o["ts"] <= epoch["ts"] + epoch["dur"]]
    assert ops and len(inside) > 0.5 * len(ops)


def test_the_tie_takes_the_marker_that_started_latest_after_its_launch_returned():
    s = profiling.Session.__new__(profiling.Session)
    s.marker, s.ties = profiling.MARKER_KERNEL, [1.0, 2.0]
    k = "llp_trace_marker_kernel(int*)"
    warm, other = (k, 5.0e5, 1.0), ("spin_kernel(long)", 1.5e6, 9.0)
    assert s.offset_us([warm, other, (k, 1.0e6 + 30.0, 1.0), (k, 2.0e6 + 25.0, 1.0)]) == 30.0
    assert s.offset_us([other, (k, 2.0e6 + 25.0, 1.0)]) is None  # a tie launch is missing
