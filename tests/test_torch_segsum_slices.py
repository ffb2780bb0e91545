"""The segment sum's feature-slice design, its host side (``llp_tpu_torch/ops/
segsum.py``): the int32 copy of an index array (``index_int32``), the
heavy-first block order (``heavy_first``), the path the wrapper picks and
counts (``_route``), and a numpy replay of
``csrc/segsum.cu``'s vector path: which (feature slice, block of rows) each
block owns (``block_cell``), which row each group of lanes owns, and the
order in which a group adds its row's edges.  The replay covers every
(row, feature) once and every edge of a row once per feature, in edge
order, and its sums equal the plain version's bit for bit (the plain
version adds in edge order on the CPU).  The kernel itself runs only on a
card: ``chip_smoke.py`` holds it against the plain version there."""

import numpy as np
import pytest
import torch

from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.ops.segsum import (
    BLOCK_WARPS,
    HEAVY_EDGES,
    ROWS_PER_WARP,
    _route,
    heavy_first,
    index_int32,
    segsum_plain,
)

LANES = 8  # csrc/segsum.cu: kL, the 16-byte vectors of a row in one slice


def _graph(n=300, e=2400, hub=400, isolated=30, seed=0):
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e + hub)
    recv = np.concatenate([rng.integers(0, n - isolated, e), np.full(hub, 5)])
    return build_graph(np.stack([send, recv]), n, device="cpu")


def block_cell(b, row_blocks, n_slices, order, n_heavy):
    """csrc/segsum.cu::block_cell: block b's (feature slice, row block)."""
    if order is None:
        return b // row_blocks, b % row_blocks
    first = n_heavy * n_slices
    if b < first:
        return b % n_slices, int(order[b // n_slices])
    n_light = row_blocks - n_heavy
    return (b - first) // n_light, int(order[n_heavy + (b - first) % n_light])


def replay(x, senders, in_ptr, scale, weights=None, visits=None, heavy=True):
    """The vector path of ``segsum_vec_kernel`` in numpy, block by block, in
    dispatch order, for fp32 ``x`` (n_src, d), d a multiple of 4.  A warp
    sums 32 / 8 rows; each group of 8 lanes adds its row's edges 8 at a
    time, in edge order.  ``visits`` (optional dict) records (row, feature)
    -> the edges added, in order; ``heavy`` runs the heavy-first order."""
    x = np.asarray(x, np.float32)
    n, d = in_ptr.shape[0] - 1, x.shape[1]
    lanes = LANES
    kn = 4                          # fp32 values in a 16-byte vector
    rows_per_warp = 32 // lanes
    assert rows_per_warp == ROWS_PER_WARP["vector128B"]
    rows = BLOCK_WARPS * rows_per_warp
    row_blocks, n_slices = -(-n // rows), -(-d // (lanes * kn))
    order, n_heavy = heavy_first(in_ptr, rows) if heavy else (None, 0)
    senders, in_ptr = senders.numpy(), in_ptr.numpy()
    out = np.full((n, d), np.nan, np.float32)
    for b in range(n_slices * row_blocks):
        sl, rb = block_cell(b, row_blocks, n_slices, order, n_heavy)
        for warp, grp in np.ndindex(BLOCK_WARPS, rows_per_warp):
            row = (rb * BLOCK_WARPS + warp) * rows_per_warp + grp
            if row >= n:
                continue
            e0, e1 = int(in_ptr[row]), int(in_ptr[row + 1])
            for sub in range(lanes):
                f = sl * lanes * kn + sub * kn
                if f >= d:
                    continue
                acc = np.zeros(kn, np.float32)
                for c in range(e0, e1, lanes):
                    for i in range(lanes):
                        e = c + i
                        if e >= e1:
                            continue
                        m = x[senders[e], f:f + kn]
                        if weights is not None:
                            m = np.float32(weights[e]) * m
                        acc = acc + m
                        if visits is not None:
                            for k in range(kn):
                                visits.setdefault((row, f + k), []).append(e)
                assert np.isnan(out[row, f:f + kn]).all()  # one writer
                sc = np.float32(1.0) if scale is None else np.float32(scale[row])
                out[row, f:f + kn] = acc * sc
    return out


def test_index_int32_equals_the_csr_and_is_cached_per_tensor():
    g = _graph()
    for idx in (g.senders, g.col):
        got = index_int32(idx)
        assert got.dtype == torch.int32 and torch.equal(got.long(), idx)
        assert index_int32(idx) is got  # one copy per tensor
    other = g.senders.clone()
    assert index_int32(other) is not index_int32(g.senders)
    before = index_int32(other)
    other[0] = (other[0] + 1) % g.num_nodes  # an in-place write makes a new copy
    after = index_int32(other)
    assert after is not before and torch.equal(after.long(), other)


def test_route_names_the_kernel_path():
    x = torch.zeros(10, 256)
    assert _route(x, torch.zeros(10, 256)) == "vector128B"
    assert _route(x.bfloat16(), torch.zeros(10, 256)) == "vector128B"
    assert _route(torch.zeros(10, 1433), torch.zeros(10, 1433)) == "scalar"
    assert _route(torch.zeros(10, 12).bfloat16(), torch.zeros(10, 12)) == "scalar"
    shifted = torch.zeros(10 * 256 + 1)[1:].view(10, 256)  # 4 bytes off 16
    assert _route(shifted, torch.zeros(10, 256)) == "scalar"
    assert _route(x, shifted) == "scalar"
    assert set(ROWS_PER_WARP) == {"vector128B", "scalar"}


def test_heavy_first_orders_blocks_with_a_heavy_row_first():
    g = _graph(n=300, hub=HEAVY_EDGES + 1)  # row 5 is heavy
    for rows in (8, 32, 64, 128):
        order, n_heavy = heavy_first(g.in_ptr, rows)
        blocks = -(-g.num_nodes // rows)
        deg = (g.in_ptr[1:] - g.in_ptr[:-1]).numpy()
        heavy = [b for b in range(blocks) if (deg[b * rows:(b + 1) * rows] > HEAVY_EDGES).any()]
        assert n_heavy == len(heavy) == 1
        assert order.dtype == torch.int32
        light = [b for b in range(blocks) if b not in heavy]
        assert order.tolist() == heavy + light  # a permutation, each part ascending
        assert heavy_first(g.in_ptr, rows)[0] is order  # cached per CSR and block size
    assert heavy_first(_graph(hub=0).in_ptr, 32) == (None, 0)  # no heavy row
    ptr = g.in_ptr.clone()
    before = heavy_first(ptr, 32)
    ptr[1:] = ptr[-1]  # written in place: every edge in row 0
    order, n_heavy = heavy_first(ptr, 32)
    assert order is not before[0] and n_heavy == 1 and order[0] == 0


@pytest.mark.parametrize("n", [300, 33])
@pytest.mark.parametrize("d", [4, 36, 64, 100])
@pytest.mark.parametrize("heavy", [True, False])
def test_schedule_covers_every_row_feature_and_edge_once_in_order(n, d, heavy):
    # 300 rows: ten 32-row blocks, the last ragged; 33: one row past a block
    g = _graph(n=n, e=3 * n, hub=HEAVY_EDGES + 40, isolated=7, seed=n + d)
    x = np.random.default_rng(d).normal(size=(g.num_nodes, d)).astype(np.float32)
    visits = {}
    out = replay(x, g.senders, g.in_ptr, None, visits=visits, heavy=heavy)
    assert not np.isnan(out).any()  # every (row, feature) written
    in_ptr = g.in_ptr.numpy()
    for row in range(g.num_nodes):
        edges = list(range(in_ptr[row], in_ptr[row + 1]))
        for f in range(d):
            assert visits.get((row, f), []) == edges  # every edge once, in edge order


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("weighted", [False, True])
def test_replay_equals_the_plain_version_bit_for_bit(seed, weighted):
    g = _graph(seed=seed, hub=HEAVY_EDGES + 100)
    rng = np.random.default_rng(seed)
    w = rng.normal(size=g.num_edges).astype(np.float32) if weighted else None
    wt = None if w is None else torch.from_numpy(w)
    x = rng.normal(size=(g.num_nodes, 40)).astype(np.float32)
    for scale in (None, g.inv_in_degree):
        ref = segsum_plain(torch.from_numpy(x), g.senders, g.in_ptr, scale, weights=wt)
        got = replay(x, g.senders, g.in_ptr, None if scale is None else scale.numpy(),
                     weights=w)
        np.testing.assert_array_equal(got, ref.numpy())


def test_replay_bf16_store_equals_the_plain_version():
    g = _graph(seed=3)
    rng = np.random.default_rng(3)
    xb = torch.from_numpy(rng.normal(size=(g.num_nodes, 32)).astype(np.float32)).bfloat16()
    ref = segsum_plain(xb, g.senders, g.in_ptr, g.inv_in_degree)
    # the bf16 instance sums bf16 values in fp32 and rounds once at the store
    got = torch.from_numpy(replay(xb.float().numpy(), g.senders, g.in_ptr,
                                  g.inv_in_degree.numpy())).bfloat16()
    assert torch.equal(got, ref)
