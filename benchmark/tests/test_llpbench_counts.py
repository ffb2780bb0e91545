"""Operation and byte counts against hand counts at tiny shapes."""

from llpbench import roofline


def test_gemm_and_head():
    assert roofline.gemm(2, 3, 4) == 48
    # 5 pairs, H = 4, 2 layers: Hadamard 4, hidden linear 2·4·4, last 2·4
    assert roofline.mlp_head_flops(5, 4, 2) == 5 * (4 + 32 + 8)


def test_sage_teacher_step_by_hand():
    n, e, din, h, pairs = 10, 30, 3, 4, 6
    l1 = 2 * (2 * n * din * h)          # lin_l(x_agg), lin_r(x)
    l2 = 2 * (2 * n * h * h)
    head = pairs * (h + 2 * h * h + 2 * h)
    fwd = l1 + l2 + e * h + head
    bwd = l1 + 2 * l2 + e * h + 2 * head    # weights only in layer 1
    assert roofline.sage_teacher_step(n, e, din, h, pairs) == fwd + bwd
    assert roofline.sage_teacher_eval(n, e, din, h, pairs) == l1 + l2 + e * h + head


def test_mlp_student_step_by_hand():
    rows, din, h, ctx, link = 7, 3, 4, 5, 2
    l1, l2 = 2 * rows * din * h, 2 * rows * h * h
    head = lambda p: p * (h + 2 * h * h + 2 * h)  # noqa: E731
    want = (l1 + l2 + head(ctx + link)) + (l1 + 2 * l2 + 2 * head(ctx + link)) + head(ctx)
    assert roofline.mlp_student_step(rows, din, h, ctx, link) == want
    assert roofline.mlp_student_eval(10, din, h, 6) == 2 * 10 * din * h + 2 * 10 * h * h + head(6)


def test_segsum_bytes_by_hand():
    # 6 fp32 rows of width 2 in, 4 out, 9 int32 indices, 5 int64 offsets, 4 scales
    assert roofline.segsum_bytes(6, 4, 2, 9, True) == 4 * 2 * 10 + 4 * 9 + 8 * 5 + 4 * 4
    assert roofline.segsum_bytes(6, 4, 2, 9, False) == 4 * 2 * 10 + 4 * 9 + 8 * 5
