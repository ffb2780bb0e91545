"""The redesigned tile SpMM's host-side pieces (``llp_tpu_torch/ops/
spmm_tiles.py``): the walk over the valid slots that the CUDA kernel
(``csrc/spmm_tiles.cu``) reads, held against the tiles it is derived from;
the hybrid's residual CSR, held against ``build_tiles``' residual edges in
both directions; and the hybrid forward and gradient, whose residual now goes
through the segment sum (``segsum``; its plain version here), against the
archived JAX ``spmm_pallas`` (Pallas in interpret mode).

Tolerances: the walk and the CSR are integer arrays and must be equal; a
numpy replay of the kernel's walk sums each row's slots in the kernel's
order and so equals the plain version bit for bit on sums of multiples of
1/256; the hybrid against JAX within rtol 1e-5 and atol 1e-5, as
``tests/test_torch_tiles.py`` states.  The kernel itself runs only on a
card: ``chip_smoke.py`` holds it against the plain version there."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.tiles import TILE, TILE_E, build_tiles
from llp_tpu_torch.ops import spmm_tiles as spmm_tiles_mod
from llp_tpu_torch.ops.spmm_tiles import spmm_tiles, spmm_tiles_apply_plain, tile_walk

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]


def _edges(n, seed, many=0):
    """Receivers, senders and weights: random edges over the first n - 150
    nodes (the last row block receives nothing), ``many`` more into row
    block 0 from every tile column (chunks of 128 and a remainder), a row block
    (the second) whose edges all come from one tile column (one chunk), and
    dense clusters that pass the hybrid's threshold."""
    rng = np.random.default_rng(seed)
    e = 4 * n
    recv = np.concatenate([rng.integers(256, n - 150, e), rng.integers(0, 128, many),
                           np.full(5, 130), rng.integers(300, 360, 400)])
    send = np.concatenate([rng.integers(0, n, e), rng.integers(0, n, many),
                           rng.integers(256, 384, 5), rng.integers(300, 420, 400)])
    w = (rng.integers(-16, 17, recv.shape[0]) / 8).astype(np.float32)
    return recv, send, w


def _replay(tiles, walk, x):
    """The kernel's sums in numpy: each row block's walk, in order, each
    slot's weighted row of x added to its row."""
    coords = tiles.coords.reshape(-1).numpy()
    cols = tiles.tile_cols.numpy()
    bptr, vptr, vslot = (tiles.block_ptr.numpy(), walk.valid_ptr.numpy(),
                         walk.valid_slot.numpy())
    w = None if tiles.weights is None else tiles.weights.reshape(-1).numpy()
    out = np.zeros((tiles.n_rows_pad, x.shape[1]), np.float32)
    for b in range(len(bptr) - 1):
        for s in vslot[vptr[b]:vptr[b + 1]]:
            t = bptr[b] + (s >> 7)
            slot = t * TILE_E + (s & 127)
            c = coords[slot]
            msg = x[cols[t] * TILE + c % TILE]
            out[b * TILE + c // TILE] += msg if w is None else np.float32(w[slot]) * msg
    return out


@pytest.mark.parametrize("min_tile_edges", [0, 16])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_tile_walk_lists_every_valid_slot_in_order(min_tile_edges, weighted):
    n = 2000
    recv, send, w = _edges(n, seed=1, many=3000)
    tiles = build_tiles(recv, send, n, w if weighted else None,
                        min_tile_edges=min_tile_edges, device="cpu")[0]
    walk = tile_walk(tiles)
    assert tile_walk(tiles) is walk  # derived once per tile set
    assert walk.valid_ptr.dtype == torch.int64 and walk.valid_slot.dtype == torch.int32
    bptr, vptr = tiles.block_ptr.numpy(), walk.valid_ptr.numpy()
    vslot = walk.valid_slot.numpy()
    coords = tiles.coords.reshape(-1, TILE_E).numpy()
    assert vptr.shape == bptr.shape and vptr[0] == 0 and vptr[-1] == (coords >= 0).sum()
    for b in range(len(bptr) - 1):
        want = [(t - bptr[b]) * TILE_E + s for t in range(bptr[b], bptr[b + 1])
                for s in np.flatnonzero(coords[t] >= 0)]
        np.testing.assert_array_equal(vslot[vptr[b]:vptr[b + 1]], want)
    if min_tile_edges == 0:
        chunks = np.diff(bptr)
        assert chunks[0] >= 30 and chunks[1] == 1 and chunks[-1] == 0
    x = (np.random.default_rng(2).integers(-1024, 1025, (n, 12)) / 256).astype(np.float32)
    np.testing.assert_array_equal(
        _replay(tiles, walk, x)[:n],
        spmm_tiles_apply_plain(tiles, torch.from_numpy(x), n).numpy())


def test_tile_walk_of_the_empty_tile_set():
    tiles = build_tiles(np.zeros(0), np.zeros(0), 300, device="cpu")[0]
    walk = tile_walk(tiles)
    assert walk.valid_slot.numel() == 0
    np.testing.assert_array_equal(walk.valid_ptr.numpy(), np.zeros(4, np.int64))


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "backward"])
def test_hybrid_residual_csr_holds_build_tiles_residual_receiver_sorted(transpose):
    n = 2000
    recv, send, _ = _edges(n, seed=3)
    g = build_graph(np.stack([send, recv]), n, device="cpu")
    hyb = g.hybrid_tiles[1 if transpose else 0]
    s, r = g.senders.numpy(), g.receivers.numpy()
    if transpose:
        s, r = r, s
    _, res_recv, res_send, _ = build_tiles(
        r, s, n, min_tile_edges=spmm_tiles_mod.MIN_TILE_EDGES, device="cpu")
    assert res_recv.size and hyb.tiles.coords.numel()  # a real hybrid
    order = np.argsort(res_recv, kind="stable")
    np.testing.assert_array_equal(hyb.res_recv.numpy(), res_recv[order])
    np.testing.assert_array_equal(hyb.res_send.numpy(), res_send[order])
    ptr = hyb.res_ptr.numpy()
    assert ptr.shape == (n + 1,) and ptr[0] == 0 and ptr[-1] == res_recv.size
    np.testing.assert_array_equal(np.repeat(np.arange(n), np.diff(ptr)), hyb.res_recv.numpy())
    assert all(t.dtype == torch.int64 for t in (hyb.res_recv, hyb.res_send, hyb.res_ptr))


@pytest.fixture(scope="module")
def archived():
    spec = importlib.util.spec_from_file_location(
        "spmm_tile_kernel", ROOT / "docs" / "archived" / "spmm_tile_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_hybrid_residual_goes_through_segsum_and_equals_spmm_pallas(archived, reduce,
                                                                   monkeypatch):
    n = 700
    recv, send, _ = _edges(n, seed=5)
    ei = np.stack([send, recv])
    g, jg = build_graph(ei, n, device="cpu"), jax_build_graph(ei, n)
    calls, segsum = [], spmm_tiles_mod.segsum

    def counted(*args, **kwargs):
        calls.append(kwargs.get("out_dtype"))
        return segsum(*args, **kwargs)

    monkeypatch.setattr(spmm_tiles_mod, "segsum", counted)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    ct = rng.normal(size=(n, 16)).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: archived.spmm_pallas(jg, v, reduce), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm_tiles(g, xt, reduce)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    assert calls == [torch.float32, torch.float32]  # the forward's residual, the backward's
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), **TOL)
