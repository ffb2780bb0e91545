"""The training driver: epochs of the program's trainer, each followed by
its evaluation every ``eval_steps`` epochs, as ``run_teacher`` /
``run_student`` run them.

Set-up applies what the configuration states about precision (``tf32``),
builds the inputs from the seed, the program's graph, model and
trainer (one object; its epoch runs over the training positives, or over
the first ``epoch_pairs`` of them, while its message graph holds them
all), and runs the first epoch (and its evaluation, where
``eval_steps`` owes one) through the window's own calls: that warms every
shape, and its first steps are the
ones the plain reference replays (Adam's state after step 1 and the
parameters after the last compared step are read by an optimizer hook,
each step's loss by a wrapper of the trainer's ``step``; both are removed
before the window).  The window then runs epoch + eval until its time is
up; the rate is every real training pair (positives and negatives) over
the window's whole time.  The window ends on an epoch that evaluated.

After the window, ``check`` judges two stages against the plain reference:
the first steps of set-up's epoch (replayed by the reference from the same
weights, inputs and generator state), and the window's last evaluation
(the encoder's table, every pair's score and the Hits@K and AUC it
reported), which the reference works out again from the program's
parameters at that moment: an evaluation is a function of them alone.  It
also counts the optimizer steps the window took against those its epochs
owe, and reads whether the stated precision was still in force.
"""

from __future__ import annotations

import time
import warnings
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

import llp_tpu_torch.evaln.transductive as transductive
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.models.encoder import precompute_first_aggregation
from llp_tpu_torch.serve.engine import encode_graph_nodes
from llp_tpu_torch.train.student import StudentTrainer, init_student
from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher

from llpbench import roofline
from llpbench.graphgen import CollabGraph, derive, make_graph
from llpbench.weights import make_weights, mlp_leaves, sage_leaves
from reference import compare
from reference.core import MeanGraph, Precision, no_tf32
from reference import evaluation as ref_eval
from reference import student as ref_student
from reference import teacher as ref_teacher

# The keys a training configuration may hold; any other is refused, so that
# a configuration never states something the harness does not apply.  Only
# the teacher takes ``epoch_pairs``: the student's coupled node batch reads
# the training count.
COMMON_KEYS = {"name", "source", "model", "graph", "num_layers", "hidden_channels",
               "predictor", "dropout", "lr", "compute_dtype", "tf32", "eval_steps",
               "hits_ks", "neg_mode", "compare_steps", "limits", "assumed"}
KEYS = {"sage-teacher": COMMON_KEYS | {"encoder", "predictor_layers", "batch_size",
                                       "epoch_pairs"},
        "mlp-student": COMMON_KEYS | {"teacher", "link_batch_size", "true_label", "llp_d",
                                      "llp_r", "margin", "rw_step", "hops", "ns_rate",
                                      "ps_method", "minibatch"}}
GRAPH_KEYS = {"nodes", "features", "train_pairs", "valid_pairs", "test_pairs",
              "valid_negatives", "test_negatives", "degree_exponent", "degree_offset",
              "communities", "mixing", "feature_signal"}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class TrainRun:
    cfg: dict
    device: torch.device
    graph_data: CollabGraph
    weights: Dict[str, torch.Tensor]
    trainer: object
    evaluate: Callable[[], dict]
    generator: torch.Generator
    gen_state: torch.Tensor
    pairs_per_epoch: int
    steps_per_epoch: int
    flops_step: float
    flops_eval: float
    segsum_bytes_step: float
    segsum_bytes_eval: float
    edges: Dict[str, torch.Tensor] = field(default_factory=dict)
    host_spans: Dict[str, float] = field(default_factory=dict)
    captured: dict = field(default_factory=dict)
    final: Optional[Dict[str, torch.Tensor]] = None
    steps_taken: int = 0
    precision_changed: int = 0
    teacher_weights: Optional[Dict[str, torch.Tensor]] = None
    teacher_cfg: Optional[dict] = None
    scores: Dict[str, torch.Tensor] = field(default_factory=dict)
    last_eval: Optional[dict] = None
    epochs: int = 0
    owed_steps: int = 0


class _Capture:
    """Reads the first steps of an epoch: each step's loss (a wrapper of
    the trainer's ``step``), Adam's first moments after step 1 and the
    parameters after step ``steps`` (an optimizer post-step hook)."""

    def __init__(self, trainer, steps: int):
        self.trainer, self.steps, self.count = trainer, steps, 0
        self.losses, self.exp_avg, self.params = [], None, None
        self.names = {id(p): n for n, p in trainer.model.named_parameters()}
        self.hook = trainer.optimizer.register_step_post_hook(self._post)
        step = trainer.step

        def recorded(*args, **kwargs):
            loss = step(*args, **kwargs)
            self.losses.append(loss)
            return loss

        trainer.step = recorded

    def _post(self, opt, args, kwargs):
        self.count += 1
        if self.count == 1:
            self.exp_avg = {self.names[id(p)]: opt.state[p]["exp_avg"].detach().clone()
                            for g in opt.param_groups for p in g["params"] if p in opt.state}
        if self.count == self.steps:
            self.params = {n: p.detach().clone() for n, p in self.trainer.model.named_parameters()}

    def close(self) -> dict:
        self.hook.remove()
        del self.trainer.step
        return {"losses": [float(x) for x in self.losses[:self.steps]],
                "exp_avg": self.exp_avg, "params": self.params}


def coupled_node_batch(num_nodes: int, num_pos: int, link_batch: int) -> int:
    """The node batch that runs out with the link batches (the LLP
    reference's ``main.py:335``)."""
    return max(1, int(num_nodes / (num_pos / min(link_batch, num_pos))))


def check_keys(cfg: dict) -> None:
    """Refuses a configuration key the harness does not apply."""
    known = KEYS.get(cfg.get("model"))
    if known is None:
        raise ValueError(f"unknown model {cfg.get('model')!r}")
    extra = sorted(set(cfg) - known) + sorted(f"graph.{k}" for k in set(cfg["graph"]) - GRAPH_KEYS)
    if extra:
        raise ValueError(f"configuration {cfg['name']!r} states keys the harness does not "
                         f"apply: {extra}")
    if int(cfg["eval_steps"]) < 1:
        raise ValueError("eval_steps is at least 1")
    if "epoch_pairs" in cfg and not 1 <= int(cfg["epoch_pairs"]) <= int(
            cfg["graph"]["train_pairs"]):
        raise ValueError(f"epoch_pairs is 1 to graph.train_pairs "
                         f"({cfg['graph']['train_pairs']}); got {cfg['epoch_pairs']}")


def positives(cfg: dict, g: CollabGraph) -> np.ndarray:
    """The training positives an epoch runs over: the first ``epoch_pairs``
    training pairs where the configuration states it (``make_graph`` puts
    them in a seeded random order, so this is a seeded uniform sample), or
    all of them.  The message graph holds every training pair either way."""
    return g.train[:int(cfg.get("epoch_pairs", g.train.shape[0]))]


def apply_precision(cfg: dict) -> None:
    """TF32 for fp32 products on or off, as the configuration states."""
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])


def precision_changed(cfg: dict) -> int:
    """How many of the stated TF32 switches are no longer as stated."""
    return (int(torch.backends.cuda.matmul.allow_tf32 != bool(cfg["tf32"]))
            + int(torch.backends.cudnn.allow_tf32 != bool(cfg["tf32"])))


@contextmanager
def recording_scores(run: "TrainRun"):
    """The evaluator's pair scores (each edge set's probabilities, as its
    ``score`` returns them) kept by edge set while the block runs; each
    evaluation replaces the last one's."""
    score = transductive.score
    names = {id(v): k for k, v in run.edges.items()}

    def recorded(predictor, h, edges):
        out = score(predictor, h, edges)
        run.scores[names.get(id(edges), "other")] = out
        return out

    transductive.score = recorded
    try:
        yield
    finally:
        transductive.score = score


def _eval_edges(g: CollabGraph, device) -> dict:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
    return {"valid_pos": t(g.valid), "valid_neg": t(g.valid_neg),
            "test_pos": t(g.test), "test_neg": t(g.test_neg)}


def _load(module, weights):
    module.load_state_dict(weights, strict=True)
    return module


def _teacher_model(cfg: dict, din: int, weights, device):
    model = init_teacher(encoder=cfg["encoder"], in_channels=din,
                         hidden_channels=cfg["hidden_channels"], num_layers=cfg["num_layers"],
                         predictor_mode=cfg["predictor"],
                         predictor_layers=cfg["predictor_layers"], conv="sage",
                         dropout=cfg["dropout"]).to(device)
    return _load(model, weights)


def prepare(cfg: dict, seed: int, device, *, teacher_cfg: Optional[dict] = None,
            patch: Optional[Callable] = None) -> TrainRun:
    """Everything before the window, the first epoch and eval included.
    ``patch(run)`` (tests, calibration) breaks the program before that
    epoch."""
    check_keys(cfg)
    apply_precision(cfg)
    spans = {}
    g = make_graph(cfg["graph"], seed)
    n, din = g.x.shape
    t = time.perf_counter()
    graph = build_graph(g.message_edges, n, device=device)
    x = torch.from_numpy(g.x).to(device)
    pos = torch.from_numpy(positives(cfg, g)).to(device)
    edges = _eval_edges(g, device)
    _sync(device)
    spans["graph_build"] = time.perf_counter() - t
    hits = tuple(cfg["hits_ks"])
    e_msg = 2 * g.train.shape[0]
    eval_pairs = sum(int(v.shape[0]) for v in edges.values())
    hidden = cfg["hidden_channels"]
    twts = tcfg = None
    if cfg["model"] == "sage-teacher":
        weights = make_weights(sage_leaves(din, hidden, cfg["num_layers"],
                                           cfg["predictor_layers"]), seed, "teacher", device)
        model = _teacher_model(cfg, din, weights, device)
        trainer = TeacherTrainer(model, graph, x, pos, encoder=cfg["encoder"], conv="sage",
                                 batch_size=cfg["batch_size"], lr=cfg["lr"],
                                 neg_mode=cfg["neg_mode"], compute_dtype=cfg["compute_dtype"])
        x_agg = precompute_first_aggregation(cfg["encoder"], graph, x)

        def evaluate():
            return transductive.evaluate_transductive(model["encoder"], model["predictor"],
                                                      graph, x, edges, hits_ks=hits, x_agg=x_agg)

        batch = trainer.batch
        depth = dict(layers=cfg["num_layers"], head_layers=cfg["predictor_layers"])
        flops_step = roofline.sage_teacher_step(n, e_msg, din, hidden, 2 * batch, **depth)
        flops_eval = roofline.sage_teacher_eval(n, e_msg, din, hidden, eval_pairs, **depth)
        seg_step, seg_eval = roofline.sage_teacher_segsum(n, e_msg, hidden, batch,
                                                          layers=cfg["num_layers"])
    elif cfg["model"] == "mlp-student":
        tcfg = teacher_cfg
        twts = make_weights(sage_leaves(din, tcfg["hidden_channels"], tcfg["num_layers"],
                                        tcfg["predictor_layers"]), seed, "teacher", device)
        teacher = _teacher_model(tcfg, din, twts, device).eval()
        t_h = encode_graph_nodes(teacher["encoder"], graph, x)
        weights = make_weights(mlp_leaves(din, hidden, cfg["num_layers"]), seed, "student",
                               device)
        model = _load(init_student(in_channels=din, hidden_channels=hidden,
                                   num_layers=cfg["num_layers"], predictor_mode=cfg["predictor"],
                                   dropout=cfg["dropout"]).to(device), weights)
        node_bs = coupled_node_batch(n, g.train.shape[0], cfg["link_batch_size"])
        trainer = StudentTrainer(
            model, graph, x, t_h, teacher["predictor"], pos,
            link_batch_size=cfg["link_batch_size"], node_batch_size=node_bs, lr=cfg["lr"],
            true_label=cfg["true_label"], llp_d=cfg["llp_d"], llp_r=cfg["llp_r"],
            margin=cfg["margin"], rw_step=cfg["rw_step"], hops=cfg["hops"],
            ns_rate=cfg["ns_rate"], ps_method=cfg["ps_method"], neg_mode=cfg["neg_mode"],
            minibatch=cfg["minibatch"], compute_dtype=cfg["compute_dtype"])
        del teacher

        def evaluate():
            return transductive.evaluate_transductive(model["encoder"], model["predictor"],
                                                      None, x, edges, hits_ks=hits)

        batch, bn, c = trainer.batch, trainer.node_batch, trainer.num_contexts
        rows = bn * (1 + c) + 4 * batch
        depth = dict(layers=cfg["num_layers"], head_layers=cfg["num_layers"])
        flops_step = roofline.mlp_student_step(rows, din, hidden, bn * c, 2 * batch,
                                               teacher_head_layers=tcfg["predictor_layers"],
                                               **depth)
        flops_eval = roofline.mlp_student_eval(n, din, hidden, eval_pairs, **depth)
        # the gathers' backward: the rank loss's context columns are tiny
        seg_step = seg_eval = 0.0
    else:
        raise ValueError(f"unknown model {cfg['model']!r}")
    gen = torch.Generator(device=device).manual_seed(derive(seed, "train"))
    state = gen.get_state()
    capture = _Capture(trainer, int(cfg["compare_steps"]))
    run = TrainRun(cfg=cfg, device=device, graph_data=g, weights=weights, trainer=trainer,
                   evaluate=evaluate, generator=gen, gen_state=state,
                   pairs_per_epoch=2 * trainer.num_pos, steps_per_epoch=trainer.steps,
                   flops_step=flops_step, flops_eval=flops_eval,
                   segsum_bytes_step=seg_step, segsum_bytes_eval=seg_eval,
                   host_spans=spans, teacher_weights=twts, teacher_cfg=tcfg, edges=edges)
    if patch is not None:
        patch(run)
    _one_epoch(run, None)
    _sync(device)
    run.captured = capture.close()
    return run


def _one_epoch(run: TrainRun, tracer) -> bool:
    """One epoch, and its evaluation where ``eval_steps`` owes one; returns
    whether it evaluated.  Under ``tracer``, inside the benchmark's spans."""
    run.epochs += 1
    run.owed_steps += run.steps_per_epoch
    evaluates = run.epochs % int(run.cfg["eval_steps"]) == 0
    with (tracer.span("bench.epoch") if tracer else nullcontext()):
        run.trainer.epoch(run.generator)
    if evaluates:
        with (tracer.span("bench.eval") if tracer else nullcontext()), recording_scores(run):
            metrics, h = run.evaluate()
        run.last_eval = {"metrics": metrics, "h": h}
    if tracer:
        tracer.work["steps"] = tracer.work.get("steps", 0) + run.steps_per_epoch
        tracer.work["evals"] = tracer.work.get("evals", 0) + int(evaluates)
    return evaluates


def window(run: TrainRun, seconds: float, tracer) -> dict:
    """Epochs with their evals until ``seconds`` have passed and the last
    epoch evaluated; then the program's parameters are kept for the check."""
    epochs = 0
    t0 = time.perf_counter()
    while True:
        traced = tracer.boundary(time.perf_counter() - t0)
        evaluated = _one_epoch(run, tracer if traced else None)
        epochs += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and evaluated:
            break
    tracer.boundary(elapsed)
    tracer.finish()
    run.final = {n: p.detach().clone() for n, p in run.trainer.model.named_parameters()}
    run.steps_taken = adam_steps(run.trainer.optimizer)
    run.precision_changed = precision_changed(run.cfg)
    return {"epochs": epochs, "window_s": elapsed,
            "train_pairs_per_s": epochs * run.pairs_per_epoch / elapsed,
            "attempted": epochs * run.steps_per_epoch}


def adam_steps(optimizer) -> int:
    """The optimizer steps taken, as Adam's state counts them (the fewest
    over the parameters; 0 before any)."""
    counts = [int(st["step"]) for st in optimizer.state.values() if "step" in st]
    return min(counts) if counts else 0


@contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms (``index_add_`` sorts instead of
    adding with atomics), so that a seed reads the same on every run, and
    fp32 products without TF32."""
    no_tf32()
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(before)


def _mean_graph(run: TrainRun, prec: Precision) -> MeanGraph:
    g = run.graph_data
    graph = MeanGraph(torch.from_numpy(g.message_edges).to(run.device), g.num_nodes)
    return graph.reordered() if prec.reordered else graph


def reference_replay(run: TrainRun, prec: Precision) -> dict:
    """The reference's first ``compare_steps`` steps from the same inputs,
    weights and generator state."""
    with _deterministic():
        return _replay(run, prec)


def _replay(run: TrainRun, prec: Precision) -> dict:
    cfg, dev, g = run.cfg, run.device, run.graph_data
    x = torch.from_numpy(g.x).to(dev)
    pos = torch.from_numpy(positives(cfg, g)).to(dev)
    steps = int(cfg["compare_steps"])
    graph = _mean_graph(run, prec)
    if cfg["model"] == "sage-teacher":
        return ref_teacher.replay_steps(run.weights, graph, x, pos, run.gen_state, steps=steps,
                                        batch=cfg["batch_size"], layers=cfg["num_layers"],
                                        dropout_rate=cfg["dropout"], lr=cfg["lr"], prec=prec)
    tcfg = run.teacher_cfg
    with torch.no_grad():
        t_table = ref_teacher.sage_encode(run.teacher_weights, graph, x, prec,
                                          layers=tcfg["num_layers"])
    head = {k: v for k, v in run.teacher_weights.items() if k.startswith("predictor.")}
    csr = ref_student.SenderCSR(g.message_edges, g.num_nodes, dev)
    node_bs = coupled_node_batch(g.num_nodes, g.train.shape[0], cfg["link_batch_size"])
    return ref_student.replay_steps(run.weights, head, t_table, csr, x, pos, run.gen_state,
                                    steps=steps, batch=min(cfg["link_batch_size"], pos.shape[0]),
                                    node_batch=min(node_bs, g.num_nodes), cfg=cfg, prec=prec)


def reference_eval(run: TrainRun, prec: Precision) -> dict:
    """The reference's evaluation with the parameters the program held at
    its last evaluation (the window's end)."""
    g, cfg = run.graph_data, run.cfg
    with _deterministic():
        x = torch.from_numpy(g.x).to(run.device)
        return ref_eval.evaluate(cfg["model"], run.final, x, _mean_graph(run, prec), run.edges,
                                 prec, layers=cfg["num_layers"], ks=cfg["hits_ks"])


def as_program(ref: dict) -> dict:
    """A reference replay in the shape of the program's capture (the
    control stands in the program's place)."""
    return {"losses": ref["losses"],
            "exp_avg": {k: v * (1.0 - compare.ADAM_BETA1) for k, v in ref["grads"].items()},
            "params": ref["params"]}


def program_eval(run: TrainRun) -> dict:
    """The window's last evaluation as the program produced it."""
    if run.last_eval is None:
        return {}
    return {"h": run.last_eval["h"], "scores": run.scores, "metrics": run.last_eval["metrics"]}


def check(run: TrainRun, steps: Optional[dict] = None,
          evaluation: Optional[dict] = None) -> Dict[str, float]:
    """The compared numbers against the fp32 reference: of the program's
    first steps and last evaluation, or of ``steps`` (``as_program``'s
    shape) and ``evaluation`` (``program_eval``'s) in their place."""
    ref = reference_replay(run, Precision("fp32"))
    out = compare.training_numbers(run.captured if steps is None else steps, ref, run.weights)
    ref_e = reference_eval(run, Precision("fp32"))
    out.update(compare.eval_numbers(program_eval(run) if evaluation is None else evaluation,
                                    ref_e, run.cfg["hits_ks"]))
    out["steps_missing"] = float(abs(run.owed_steps - run.steps_taken))
    out["precision_changed"] = float(run.precision_changed)
    return out
