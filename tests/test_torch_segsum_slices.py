"""The segment sum's feature-slice design, its host side (``llp_tpu_torch/ops/
segsum.py``): the int32 copy of an index array (``index_int32``), the
heavy-first block order (``heavy_first``), the locality row order
(``locality_order``, ``locality_share``), the rule that picks it
(``schedule``) and the one by which ``spmm`` derives its backward's order
ahead (``prepare``), the path the wrapper picks and counts (``_route``), and a
numpy replay of ``csrc/segsum.cu``'s vector path: which (feature slice,
block of rows) each block owns (``block_cell``), which row each group of
lanes owns, and the order in which a group adds its row's edges.  The
replay covers every (row, feature) once and every edge of a row once per
feature, in edge order, and its sums equal the plain version's bit for bit
(the plain version adds in edge order on the CPU), in slice-major order and
walking the locality order.  The kernel itself runs only on a card:
``chip_smoke.py`` holds it against the plain version there, and with the
locality order against the kernel without it."""

import numpy as np
import pytest
import torch

from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.ops.segsum import (
    BLOCK_WARPS,
    HEAVY_EDGES,
    LOCALITY_ROUNDS,
    LOCALITY_WINDOW,
    ROWS_PER_WARP,
    SLICE_BYTES,
    _propagate,
    _route,
    heavy_first,
    index_int32,
    locality_order,
    locality_share,
    schedule,
    segsum,
    segsum_plain,
)

LANES = 8  # csrc/segsum.cu: kL, the 16-byte vectors of a row in one slice


def _graph(n=300, e=2400, hub=400, isolated=30, seed=0):
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e + hub)
    recv = np.concatenate([rng.integers(0, n - isolated, e), np.full(hub, 5)])
    return build_graph(np.stack([send, recv]), n, device="cpu")


def _planted(n=20_000, communities=400, degree=20, mixing=0.2, seed=0):
    """A graph of ``communities`` random-id communities (about n /
    communities nodes each): each of n * degree / 2 pairs joins a uniform
    node to a uniform member of its community, or with probability
    ``mixing`` to a uniform node; both directions are edges."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, communities, n)
    by_comm = np.argsort(comm, kind="stable")
    start = np.searchsorted(comm[by_comm], np.arange(communities))
    size = np.bincount(comm, minlength=communities)
    src = rng.integers(0, n, n * degree // 2)
    c = comm[src]
    inner = by_comm[start[c] + (rng.random(src.shape[0]) * size[c]).astype(np.int64)]
    dst = np.where(rng.random(src.shape[0]) < mixing, rng.integers(0, n, src.shape[0]), inner)
    keep = src != dst
    pairs = np.stack([src[keep], dst[keep]])
    return build_graph(np.concatenate([pairs, pairs[::-1]], axis=1), n, device="cpu")


def block_cell(b, row_blocks, n_slices, order, n_heavy, rows=None):
    """csrc/segsum.cu::block_cell: block b's (feature slice, row block);
    under a row order, row-block-major."""
    if rows is not None:
        return b % n_slices, b // n_slices
    if order is None:
        return b // row_blocks, b % row_blocks
    first = n_heavy * n_slices
    if b < first:
        return b % n_slices, int(order[b // n_slices])
    n_light = row_blocks - n_heavy
    return (b - first) // n_light, int(order[n_heavy + (b - first) % n_light])


def replay(x, senders, in_ptr, scale, weights=None, visits=None, heavy=True,
           locality=False):
    """The vector path of ``segsum_vec_kernel`` in numpy, block by block, in
    dispatch order, for fp32 ``x`` (n_src, d), d a multiple of 4.  A warp
    sums 32 / 8 rows; each group of 8 lanes adds its row's edges 8 at a
    time, in edge order.  ``visits`` (optional dict) records (row, feature)
    -> the edges added, in order; ``heavy`` runs the heavy-first order,
    ``locality`` walks the rows in ``locality_order`` instead."""
    x = np.asarray(x, np.float32)
    n, d = in_ptr.shape[0] - 1, x.shape[1]
    lanes = LANES
    kn = 4                          # fp32 values in a 16-byte vector
    rows_per_warp = 32 // lanes
    assert rows_per_warp == ROWS_PER_WARP["vector128B"]
    rows = BLOCK_WARPS * rows_per_warp
    row_blocks, n_slices = -(-n // rows), -(-d // (lanes * kn))
    order, n_heavy = heavy_first(in_ptr, rows) if heavy and not locality else (None, 0)
    walk = locality_order(senders, in_ptr).numpy() if locality else None
    senders, in_ptr = senders.numpy(), in_ptr.numpy()
    out = np.full((n, d), np.nan, np.float32)
    for b in range(n_slices * row_blocks):
        sl, rb = block_cell(b, row_blocks, n_slices, order, n_heavy, walk)
        for warp, grp in np.ndindex(BLOCK_WARPS, rows_per_warp):
            row = (rb * BLOCK_WARPS + warp) * rows_per_warp + grp  # the row slot
            if row >= n:
                continue
            if walk is not None:
                row = int(walk[row])
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


def _hub_graph(n=300, seed=0):
    """A random graph whose rows 5, 77 and 250 are heavy."""
    rng = np.random.default_rng(seed)
    hubs = np.repeat([5, 77, 250], HEAVY_EDGES + 30)
    send = rng.integers(0, n, 4 * n + hubs.shape[0])
    recv = np.concatenate([rng.integers(0, n - 20, 4 * n), hubs])
    return build_graph(np.stack([send, recv]), n, device="cpu")


@pytest.mark.parametrize("n", [300, 33])
@pytest.mark.parametrize("d", [4, 36, 64, 100])
def test_locality_schedule_covers_every_row_feature_and_edge_once_in_order(n, d):
    g = _graph(n=n, e=3 * n, hub=HEAVY_EDGES + 40, isolated=7, seed=n + d)
    x = np.random.default_rng(d).normal(size=(g.num_nodes, d)).astype(np.float32)
    visits = {}
    out = replay(x, g.senders, g.in_ptr, None, visits=visits, locality=True)
    assert not np.isnan(out).any()  # every (row, feature) written, once (replay asserts)
    in_ptr = g.in_ptr.numpy()
    for row in range(g.num_nodes):
        edges = list(range(in_ptr[row], in_ptr[row + 1]))
        for f in range(d):
            assert visits.get((row, f), []) == edges  # every edge once, in edge order


@pytest.mark.parametrize("case", ["fp32", "bf16", "weighted"])
def test_locality_replay_equals_the_plain_version_bit_for_bit(case):
    g = _hub_graph(seed=4)
    assert (g.in_degree > HEAVY_EDGES).sum() == 3  # heavy rows present
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(g.num_nodes, 40)).astype(np.float32))
    w = rng.normal(size=g.num_edges).astype(np.float32) if case == "weighted" else None
    wt = None if w is None else torch.from_numpy(w)
    if case == "bf16":  # the sums in fp32, one rounding at the store
        xb = x.bfloat16()
        ref = segsum_plain(xb, g.senders, g.in_ptr, g.inv_in_degree)
        got = replay(xb.float().numpy(), g.senders, g.in_ptr, g.inv_in_degree.numpy(),
                     locality=True)
        assert torch.equal(torch.from_numpy(got).bfloat16(), ref)
        return
    for scale in (None, g.inv_in_degree):
        ref = segsum_plain(x, g.senders, g.in_ptr, scale, weights=wt)
        got = replay(x.numpy(), g.senders, g.in_ptr, None if scale is None else scale.numpy(),
                     weights=w, locality=True)
        np.testing.assert_array_equal(got, ref.numpy())


def test_locality_order_is_a_permutation_derived_the_same_twice_and_cached():
    g = _hub_graph()
    order = locality_order(g.senders, g.in_ptr)
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(g.num_nodes, dtype=torch.int32))
    again = _hub_graph()  # the same CSR in new tensors: derived anew, the same order
    assert torch.equal(locality_order(again.senders, again.in_ptr), order)
    assert locality_order(g.senders, g.in_ptr) is order  # cached per CSR
    for idx in (g.col, g.senders.clone()):  # another senders tensor: derived for it
        assert locality_order(idx, g.in_ptr) is not order
    ptr = g.in_ptr.clone()
    first = locality_order(g.senders, ptr)
    ptr[1:] = ptr[-1]  # written in place: every edge in row 0, derived anew
    assert locality_order(g.senders, ptr) is not first


def test_locality_order_runs_the_blocks_with_a_heavy_row_first():
    g = _hub_graph(seed=1)
    order = locality_order(g.senders, g.in_ptr).tolist()
    heavy = sorted(np.flatnonzero(g.in_degree.numpy() > HEAVY_EDGES).tolist())
    assert heavy == [5, 77, 250]
    assert sorted(order[:len(heavy)]) == heavy  # heavy rows fill the first row block


def test_locality_order_walks_a_clusters_rows_by_edges_most_first():
    g = _planted(n=2_000, communities=40, seed=3)
    order = locality_order(g.senders, g.in_ptr)
    label = _propagate(g.senders, g.in_ptr, LOCALITY_ROUNDS)[order.long()].numpy()
    deg = g.in_degree[order.long()].numpy()
    ids = order.numpy()
    runs = np.flatnonzero(np.diff(label)) + 1  # where the next cluster starts
    assert len(runs) + 1 == len(np.unique(label))  # each cluster's rows together
    for lab, d, i in zip(*(np.split(a, runs) for a in (label, deg, ids))):
        key = list(zip(-d, i))
        assert key == sorted(key)  # by edges, most first, then by id


def test_locality_share_on_a_planted_graph():
    g = _planted()
    segsum.locality_orders.clear()
    order = locality_order(g.senders, g.in_ptr)
    ident = torch.arange(g.num_nodes)
    assert locality_share(g.senders, g.in_ptr, ident, 64) < 0.05
    assert locality_share(g.senders, g.in_ptr, order, 64) >= 0.5
    (rec,) = segsum.locality_orders  # each derivation's record, at the card's window
    assert rec["rows"] == g.num_nodes and rec["edges"] == g.num_edges
    assert rec["locality_share"] == locality_share(g.senders, g.in_ptr, order, LOCALITY_WINDOW)
    assert rec["seconds"] > 0


def test_locality_clusters_do_not_merge_into_one_on_weak_communities():
    # 60 % of the pairs between communities: a tie broken toward the least
    # label spreads one label over half the rows here; hashed ties do not
    g = _planted(degree=10, mixing=0.6)
    label = _propagate(g.senders, g.in_ptr, LOCALITY_ROUNDS)
    sizes = torch.unique(label, return_counts=True)[1]
    assert int(sizes.max()) <= g.num_nodes // 100


def test_schedule_engages_past_l2_for_a_cached_square_csr_only():
    g = _hub_graph(seed=2)
    n = g.num_nodes
    fits, past = n * SLICE_BYTES, n * SLICE_BYTES - 1  # the card's L2 in bytes
    rows, order, n_heavy = schedule(g.senders, g.in_ptr, n, 32, order_heavy=True,
                                    l2_bytes=fits)
    assert rows is None and (order, n_heavy) == heavy_first(g.in_ptr, 32)
    rows, order, n_heavy = schedule(g.senders, g.in_ptr, n, 32, order_heavy=True,
                                    l2_bytes=past)
    assert rows is locality_order(g.senders, g.in_ptr) and (order, n_heavy) == (None, 0)
    # a CSR made per call (the gathers' backward) walks neither order
    assert schedule(g.senders, g.in_ptr, n, 32, order_heavy=False, l2_bytes=past) == \
        (None, None, 0)
    # a table of other rows than the output's: no locality order
    rows, order, _ = schedule(g.senders, g.in_ptr, 2 * n, 32, order_heavy=True, l2_bytes=0)
    assert rows is None and order is heavy_first(g.in_ptr, 32)[0]


def test_spmm_derives_the_backward_order_only_where_a_backward_can_follow(monkeypatch):
    from llp_tpu_torch.ops import spmm as spmm_mod

    g = _hub_graph(seed=3)
    calls = []
    monkeypatch.setattr(spmm_mod, "prepare", lambda x, senders, ptr: calls.append((senders, ptr)))
    x = torch.randn(g.num_nodes, 8).requires_grad_()
    w = torch.rand(g.num_edges).requires_grad_()
    spmm_mod.spmm(g, x, "mean")
    spmm_mod.spmm(g, x, "sum", edge_weight=w)
    assert len(calls) == 2 and all(s is g.col and p is g.row_ptr for s, p in calls)
    with torch.no_grad():  # an encode: no backward follows
        spmm_mod.spmm(g, x, "mean")
    spmm_mod.spmm(g, x.detach(), "mean")  # no gradient in x
    spmm_mod.spmm(g, x.detach(), "sum", edge_weight=w)  # only w's, from edge dots
    assert len(calls) == 2
