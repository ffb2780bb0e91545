"""The tile SpMM (B5): the port's ``build_tiles`` (``llp_tpu_torch/data/
tiles.py``) and ``spmm_tiles_apply_plain``/``spmm_tiles``
(``llp_tpu_torch/ops/spmm_tiles.py``, the plain version of
``csrc/spmm_tiles.cu``) against the JAX package: ``llp_tpu/data/tiles.py``
and the archived Pallas kernel ``docs/archived/spmm_tile_kernel.py``, loaded
by file path and run with ``interpret=True`` (``spmm_tiles_apply``, and the
hybrid ``spmm_pallas`` with its custom VJP).

Tolerances: the tiles equal JAX's array for array; fp32 sums in another
order (JAX recovers A = RᵀS and multiplies; the port adds slot by slot)
within rtol 1e-5 and atol 1e-5; a bf16 output within one bf16 ulp of JAX's
(the fp32 sums may round to neighbouring bf16 values) plus 1e-5.  The CUDA
kernel itself runs only on a card: ``chip_smoke.py`` holds it against the
plain version there."""

import gc
import importlib.util
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.data.tiles import build_tiles as jax_build_tiles
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.tiles import TILE, TILE_E, build_tiles, tile_fill
from llp_tpu_torch.ops.spmm import spmm
from llp_tpu_torch.ops.spmm_tiles import spmm_tiles, spmm_tiles_apply, spmm_tiles_apply_plain

TOL = dict(rtol=1e-5, atol=1e-5)
N = 600
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def archived():
    """The archived JAX module, loaded by its path (it lies outside the package)."""
    spec = importlib.util.spec_from_file_location(
        "spmm_tile_kernel", ROOT / "docs" / "archived" / "spmm_tile_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _edges(n=300, e=3000, isolated=40, hub=0, seed=0):
    """Receivers, senders and weights (zeros and negatives among them): the
    last ``isolated`` nodes receive nothing, node 5 receives ``hub`` more
    edges, and two row blocks of 128 hold dense clusters so that some tiles
    pass the hybrid's 16-edge threshold."""
    rng = np.random.default_rng(seed)
    recv = np.concatenate([rng.integers(0, n - isolated, e), np.full(hub, 5),
                           rng.integers(0, 64, 400), rng.integers(130, 200, 300)])
    send = np.concatenate([rng.integers(0, n, e + hub), rng.integers(0, 64, 400),
                           rng.integers(140, 250, 300)])
    w = rng.normal(size=recv.shape[0]).astype(np.float32)
    w[::7] = 0.0
    return recv, send, w


def assert_same_tiles(got, want):
    (t, rr, rs, rw), (jt, jrr, jrs, jrw) = got, want
    for field in ("tile_rows", "tile_cols", "coords", "weights"):
        a, b = getattr(t, field), getattr(jt, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=field)
    assert (t.n_rows_pad, t.n_cols_pad) == (jt.n_rows_pad, jt.n_cols_pad)
    for a, b in ((rr, jrr), (rs, jrs), (rw, jrw)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # the kernel's format: a chunk's valid slots come first, padding after
    valid = (t.coords.reshape(-1, TILE_E) >= 0).numpy()
    assert (valid[:, 1:] <= valid[:, :-1]).all()
    # block_ptr: each row block's run of chunks
    rows = t.tile_rows.numpy()
    ptr = t.block_ptr.numpy()
    assert ptr.shape == (t.n_rows_pad // TILE + 1,) and ptr[0] == 0 and ptr[-1] == len(rows)
    for b in range(len(ptr) - 1):
        assert (rows[ptr[b]:ptr[b + 1]] == b).all()


@pytest.mark.parametrize("min_tile_edges", [0, 16])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_build_tiles_equals_jax(min_tile_edges, weighted):
    recv, send, w = _edges(hub=500)
    w = w if weighted else None
    got = build_tiles(recv, send, 300, w, min_tile_edges=min_tile_edges, device="cpu")
    assert_same_tiles(got, jax_build_tiles(recv, send, 300, w, min_tile_edges=min_tile_edges))
    if min_tile_edges:
        assert got[1].size and int((got[0].coords >= 0).sum()) + got[1].size == recv.size
    assert got[0].num_nodes == 300


@pytest.mark.parametrize("case", ["no edge", "all residual"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_build_tiles_empty_equals_jax(case, weighted):
    if case == "no edge":
        recv = send = np.zeros((0,), np.int64)
        w = np.zeros((0,), np.float32)
    else:  # every tile below the threshold
        recv = np.arange(0, 300, 10)  # at most 13 edges in a row block
        send = recv * 7 % 300
        w = np.ones((30,), np.float32)
    w = w if weighted else None
    got = build_tiles(recv, send, 300, w, min_tile_edges=16, device="cpu")
    assert_same_tiles(got, jax_build_tiles(recv, send, 300, w, min_tile_edges=16))
    assert got[0].coords.shape == (TILE_E, 1) and (got[0].coords == -1).all()
    assert tile_fill(got[0]) == {"chunks": 1, "edges": 0, "fill": 0.0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_apply_plain_equals_the_archived_kernel(archived, dtype, weighted):
    recv, send, w = _edges(e=2500, hub=300, seed=1)
    n, d = 300, 40
    x = np.random.default_rng(2).normal(size=(n, d)).astype(np.float32)
    jt = jax_build_tiles(recv, send, n, w if weighted else None)
    tiles = build_tiles(recv, send, n, w if weighted else None, device="cpu")[0]
    ref = np.asarray(archived.spmm_tiles_apply(jt[0], jnp.asarray(x, dtype), n,
                                               interpret=True))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    before = spmm_tiles_apply.launches
    got = spmm_tiles_apply(tiles, xt, n)
    assert spmm_tiles_apply.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(got.numpy(), spmm_tiles_apply_plain(tiles, xt, n).numpy())
    # the isolated receivers' rows stay zero
    assert not got[n - 40:].any()


def test_apply_plain_on_the_empty_tile_set_and_fewer_out_rows(archived):
    x = np.random.default_rng(3).normal(size=(300, 16)).astype(np.float32)
    empty = build_tiles(np.zeros(0), np.zeros(0), 300, device="cpu")[0]
    assert not spmm_tiles_apply(empty, torch.from_numpy(x), 300).any()
    recv, send, _ = _edges(e=900, isolated=0)
    tiles = build_tiles(recv, send, 300, device="cpu")[0]
    ref = np.asarray(archived.spmm_tiles_apply(jax_build_tiles(recv, send, 300)[0],
                                               jnp.asarray(x), 150, interpret=True))
    got = spmm_tiles_apply(tiles, torch.from_numpy(x), 150)
    assert got.shape == (150, 16)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _graphs(seed=4):
    """600 nodes: the random edges spread thin (tiles below the threshold,
    the residual) and the hub row and the clusters fill tiles."""
    recv, send, _ = _edges(n=N, e=300, isolated=30, hub=200, seed=seed)
    ei = np.stack([send, recv])
    return build_graph(ei, N, device="cpu"), jax_build_graph(ei, N)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_spmm_tiles_and_its_gradient_equal_spmm_pallas(archived, reduce):
    g, jg = _graphs()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, 24)).astype(np.float32)
    ct = rng.normal(size=(N, 24)).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: archived.spmm_pallas(jg, v, reduce), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm_tiles(g, xt, reduce)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), **TOL)
    # the same function as the segsum route
    np.testing.assert_allclose(out.detach().numpy(), spmm(g, xt, reduce).detach().numpy(),
                               **TOL)
    fwd, bwd = g.hybrid_tiles
    assert fwd.res_recv.numel() and tile_fill(fwd.tiles)["edges"]  # a real hybrid
    assert tile_fill(bwd.tiles)["edges"] + bwd.res_recv.numel() == g.num_edges


def test_hybrid_tiles_are_built_once_per_graph_and_freed_with_it():
    g, _ = _graphs()
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(N, 8)).astype(np.float32))
    spmm_tiles(g, x, "sum")
    tiles = g.hybrid_tiles
    spmm_tiles(g, x, "mean")
    assert g.hybrid_tiles is tiles
    other, _ = _graphs()  # an equal graph of its own builds its own
    assert other.hybrid_tiles is not tiles
    torch.testing.assert_close(other.hybrid_tiles[0].tiles.coords, tiles[0].tiles.coords,
                               rtol=0, atol=0)
    alive = weakref.ref(tiles[0].tiles.coords)
    del g, tiles
    gc.collect()
    assert alive() is None


def test_spmm_tiles_bf16_equals_spmm_pallas_within_an_ulp(archived):
    g, jg = _graphs(seed=6)
    x = np.random.default_rng(7).normal(size=(N, 24)).astype(np.float32)
    ref = np.asarray(archived.spmm_pallas(jg, jnp.asarray(x, jnp.bfloat16), "mean"),
                     np.float32)
    got = spmm_tiles(g, torch.from_numpy(x).bfloat16(), "mean")
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    assert (np.abs(got - ref) <= ulp + 1e-5).all()


def test_spmm_tiles_max_is_the_plain_spmm():
    g, _ = _graphs()
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(N, 8)).astype(np.float32))
    torch.testing.assert_close(spmm_tiles(g, x, "max"), spmm(g, x, "max"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown reduce"):
        spmm_tiles(g, x, "min")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    recv, send, _ = _edges()
    tiles = build_tiles(recv, send, 300, device="cpu")[0]
    x = torch.ones(300, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        spmm_tiles_apply(tiles, x.half(), 300)
    with pytest.raises(ValueError, match=r"expects x \(300, D\)"):
        spmm_tiles_apply(tiles, x[:299], 300)
    with pytest.raises(ValueError, match="num_out_rows"):
        spmm_tiles_apply(tiles, x, 400)
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm_tiles_apply(tiles._replace(**{k: getattr(tiles, k).to("meta") for k in
                                           ("tile_cols", "block_ptr", "coords")}),
                         x.to("meta"), 300)
