"""Operation and byte counts against hand counts at tiny shapes, at depth 2
and 3, and the accepted configurations' counts pinned to their floats."""

import pytest
import torch

from conftest import BENCH_DIR, ROOT
from llpbench import roofline, spec, train


def test_gemm_and_head():
    assert roofline.gemm(2, 3, 4) == 48
    # 5 pairs, H = 4, 2 layers: Hadamard 4, hidden linear 2·4·4, last 2·4
    assert roofline.mlp_head_flops(5, 4, 2) == 5 * (4 + 32 + 8)


def _seg(rows_in, rows_out, width, nnz, scaled):
    # fp32 rows in and out, int32 indices, int64 offsets, fp32 row scales
    return 4 * width * (rows_in + rows_out) + 4 * nnz + 8 * (rows_out + 1) + \
        (4 * rows_out if scaled else 0)


@pytest.mark.parametrize("layers,head_layers", [(2, 2), (3, 3)])
def test_sage_teacher_step_by_hand(layers, head_layers):
    n, e, din, h, pairs, batch = 10, 30, 3, 4, 6, 5
    l1 = 2 * (2 * n * din * h)          # lin_l(x_agg), lin_r(x)
    later = 2 * (2 * n * h * h)         # each later layer's two products
    head = pairs * (h + (head_layers - 1) * 2 * h * h + 2 * h)
    k = layers - 1
    fwd = l1 + k * later + k * e * h + head
    bwd = l1 + 2 * k * later + k * e * h + 2 * head    # weights only in layer 1
    depth = dict(layers=layers, head_layers=head_layers)
    assert roofline.sage_teacher_step(n, e, din, h, pairs, **depth) == fwd + bwd
    assert roofline.sage_teacher_eval(n, e, din, h, pairs, **depth) == fwd
    seg_step = k * _seg(n, n, h, e, True) + k * _seg(n, n, h, e, False) + \
        _seg(4 * batch, n, h, 4 * batch, False)
    assert roofline.sage_teacher_segsum(n, e, h, batch, layers=layers) == \
        (seg_step, k * _seg(n, n, h, e, True))


@pytest.mark.parametrize("layers,teacher_head", [(2, 2), (3, 3)])
def test_mlp_student_step_by_hand(layers, teacher_head):
    rows, din, h, ctx, link = 7, 3, 4, 5, 2
    l1, later = 2 * rows * din * h, 2 * rows * h * h
    head = lambda p, lay: p * (h + (lay - 1) * 2 * h * h + 2 * h)  # noqa: E731
    k = layers - 1
    want = (l1 + k * later + head(ctx + link, layers)) + \
        (l1 + 2 * k * later + 2 * head(ctx + link, layers)) + head(ctx, teacher_head)
    depth = dict(layers=layers, head_layers=layers)
    assert roofline.mlp_student_step(rows, din, h, ctx, link, teacher_head_layers=teacher_head,
                                     **depth) == want
    assert roofline.mlp_student_eval(10, din, h, 6, **depth) == \
        2 * 10 * din * h + k * 2 * 10 * h * h + head(6, layers)


def test_segsum_bytes_by_hand():
    # 6 fp32 rows of width 2 in, 4 out, 9 int32 indices, 5 int64 offsets, 4 scales
    assert roofline.segsum_bytes(6, 4, 2, 9, True) == 4 * 2 * 10 + 4 * 9 + 8 * 5 + 4 * 4
    assert roofline.segsum_bytes(6, 4, 2, 9, False) == 4 * 2 * 10 + 4 * 9 + 8 * 5


def test_the_accepted_configurations_count_as_before():
    """The floats the two ogbl-collab configurations fed to
    ``train_step_mfu.*`` and ``segsum_roofline`` before the counts took a
    depth (collab: 18 steps of 65,536 pairs; the student's node batch
    13,110 with C = 12 contexts)."""
    t = spec.load_json(BENCH_DIR / "configs" / "sage-teacher-collab.json")
    s = spec.load_json(BENCH_DIR / "configs" / "mlp-student-collab.json")
    g = t["graph"]
    n, din, h, e = g["nodes"], g["features"], t["hidden_channels"], 2 * g["train_pairs"]
    b = t["batch_size"]
    evals = g["valid_pairs"] + g["test_pairs"] + g["valid_negatives"] + g["test_negatives"]
    depth = dict(layers=t["num_layers"], head_layers=t["predictor_layers"])
    assert roofline.sage_teacher_step(n, e, din, h, 2 * b, **depth) == 300374470656.0
    assert roofline.sage_teacher_eval(n, e, din, h, evals, **depth) == 133748236032.0
    assert roofline.sage_teacher_segsum(n, e, h, b, layers=t["num_layers"]) == \
        (1502597352.0, 495320504.0)
    bn = train.coupled_node_batch(n, g["train_pairs"], s["link_batch_size"])
    assert bn == 13110
    rows = bn * (1 + 12) + 4 * s["link_batch_size"]
    depth = dict(layers=s["num_layers"], head_layers=s["num_layers"])
    assert roofline.mlp_student_step(rows, din, h, bn * 12, 2 * s["link_batch_size"],
                                     teacher_head_layers=t["predictor_layers"],
                                     **depth) == 361599229952.0
    assert roofline.mlp_student_eval(n, din, h, evals, **depth) == 86771025664.0


def _counts_before(run):
    """The counts as ``prepare`` worked them out before they took a depth
    (two layers and a two-layer head, written out)."""
    g, cfg, tr = run.graph_data, run.cfg, run.trainer
    n, din = g.x.shape
    h, e = cfg["hidden_channels"], 2 * g.train.shape[0]
    pairs = sum(int(v.shape[0]) for v in run.edges.values())
    head = lambda p: p * (h + 2.0 * h * h + 2.0 * h)  # noqa: E731
    gemm = lambda m, k, o: 2.0 * m * k * o  # noqa: E731
    if cfg["model"] == "sage-teacher":
        l1, l2, sp, hd = 2 * gemm(n, din, h), 2 * gemm(n, h, h), e * h, head(2 * tr.batch)
        seg = lambda i, o, nnz, sc: roofline.segsum_bytes(i, o, h, nnz, sc)  # noqa: E731
        return ((l1 + l2 + sp + hd) + (l1 + 2 * l2 + sp + 2 * hd),
                2 * gemm(n, din, h) + 2 * gemm(n, h, h) + e * h + head(pairs),
                seg(n, n, e, True) + seg(n, n, e, False) + seg(4 * tr.batch, n, 4 * tr.batch,
                                                                False),
                seg(n, n, e, True))
    bn, c = tr.node_batch, tr.num_contexts
    rows = bn * (1 + c) + 4 * tr.batch
    l1, l2, hd = gemm(rows, din, h), gemm(rows, h, h), head(bn * c + 2 * tr.batch)
    return ((l1 + l2 + hd) + (l1 + 2 * l2 + 2 * hd) + head(bn * c),
            gemm(n, din, h) + gemm(n, h, h) + head(pairs), 0.0, 0.0)


@pytest.mark.parametrize("name", ["sage-teacher-train-collab", "mlp-student-distill-collab"])
def test_prepare_feeds_the_accepted_cells_their_counts_as_before(tiny_cell, bench, name,
                                                                 monkeypatch):
    cell = tiny_cell(name)
    tcfg = spec.config_by_name(bench, cell.config["teacher"], ROOT) \
        if "teacher" in cell.config else None
    seen = []
    monkeypatch.setattr(train, "_one_epoch", lambda run, tracer: seen.append(run))
    run = train.prepare(cell.config, 11, torch.device("cpu"), teacher_cfg=tcfg)
    assert seen == [run]
    assert (run.flops_step, run.flops_eval, run.segsum_bytes_step, run.segsum_bytes_eval) == \
        _counts_before(run)
