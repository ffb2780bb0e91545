"""Hits@K/AUC over sharded negatives and top-K retrieval over a node-sharded
table (``llp_tpu_torch/parallel/eval.py``: ``sharded_hits_auc``,
``sharded_topk_partners``) over gloo worlds of 2 and 4 CPU ranks.

* ``sharded_hits_auc`` against JAX's ``make_sharded_hits_auc`` on a 2- and
  a 4-device mesh (JAX's test's scores, ``tests/test_parallel.py:115-128``),
  and against the port's ``hits_at_k``/``roc_auc`` over all the negatives
  on uneven cuts, an empty rank, tied scores and fewer negatives than K:
  Hits exactly, AUC to 1e-6.
* ``sharded_topk_partners`` against JAX's ``make_sharded_topk_partners``
  on a 4-device mesh at JAX's test's shapes (n=203, H=16, k=6, block 16,
  ``tests/test_parallel.py:489-521``): 'mlp' through the kernel's route and
  the unfused expression, 'inner', bf16 compute, int8 and int4 tables
  under both heads (the queries' codes shipped, and requantized), without
  ``exclude_self``, k larger than a shard, and a 5-node table over 4 ranks
  (one rank empty).  Values within 1e-5 (bf16: 2e-2, JAX's own bf16 bound);
  ids equal wherever a score stands apart from its neighbours, and at ties
  the score of each returned id is held to its slot's, as JAX's tests do.
  The world of 2 is held to the port's single engine, and every rank
  returns the same.
* The halo encode of a SAGE teacher feeding the sharded top-K, against
  JAX's ``test_sharded_serve_pipeline_encode_to_topk`` set-up, at 2 and 4.

Both worlds are spawned once, at the start of the module, and run every
case while the JAX references compute (on threads); 60 s timeouts on the
collectives, 300 s on a world's whole run.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.data.synthetic import community_features as jax_community_features
from llp_tpu.data.synthetic import sbm_graph as jax_sbm_graph
from llp_tpu.parallel.eval import make_halo_encode, make_sharded_hits_auc
from llp_tpu.parallel.eval import make_sharded_topk_partners
from llp_tpu.parallel.halo import build_halo_partition, pad_nodes
from llp_tpu.serve.quant import quantize_table as jax_quantize_table
from llp_tpu.train.teacher import init_teacher_params
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.ops.metrics import hits_at_k, roc_auc
from llp_tpu_torch.serve.engine import score_pairs, top_k_partners
from llp_tpu_torch.serve.quant import quantize_table
from llp_tpu_torch.tools.dp_runs import Worlds
from llp_tpu_torch.utils.params import from_jax, to_jax

SIZES = (2, 4)
REF_THREADS = 4  # JAX references compiled at once
TIMEOUT = 60  # every collective and the rendezvous
RUN_TIMEOUT = 300  # a world's whole run of the module's cases, on a loaded host
N, H, K = 203, 16, 6
QUERIES = [0, 50, 202]
VAL_TOL = 1e-5
BF16_TOL = 2e-2


def _cuts(m, size, kind):
    if kind == "even":
        return [r * m // size for r in range(size + 1)]
    # uneven, rank 0 empty at 4
    return {2: [0, m // 7, m], 4: [0, 0, m // 3, m // 3 + 5, m]}[size]


def _hits_cases():
    rng = np.random.default_rng(7)
    jax_case = dict(pos=rng.normal(size=200).astype(np.float32),
                    neg=rng.normal(size=512).astype(np.float32), ks=(10, 20, 50), cut="even")
    tied = dict(pos=np.round(rng.normal(size=150), 1).astype(np.float32),
                neg=np.round(rng.normal(size=301), 1).astype(np.float32), ks=(1, 10, 100),
                cut="uneven")
    few = dict(pos=rng.normal(size=20).astype(np.float32),
               neg=rng.normal(size=7).astype(np.float32), ks=(5, 10), cut="uneven")
    return {"jax": jax_case, "tied": tied, "few": few}


def _predictors():
    mlp = LinkPredictor("mlp", H, H, generator=torch.Generator().manual_seed(3))
    return {"mlp": to_jax(mlp), "inner": to_jax(LinkPredictor("inner", H, H))}


def _table(n=N):
    return np.random.default_rng(11).normal(size=(n, H)).astype(np.float32)


# name: (mode, overrides of the case)
TOPK_CASES = {
    "mlp": ("mlp", {"mlp_fused": False}),
    "mlp_fused": ("mlp", {"mlp_fused": True}),
    "inner": ("inner", {}),
    "mlp_bf16": ("mlp", {"compute_dtype": "bfloat16", "mlp_fused": True}),
    "mlp_int8": ("mlp", {"quantize": "int8"}),
    "inner_int8": ("inner", {"quantize": "int8"}),
    "inner_int8_requantized": ("inner", {"quantize": "int8", "ship_codes": False}),
    "mlp_int4": ("mlp", {"quantize": "int4", "mlp_fused": True}),
    "inner_int4": ("inner", {"quantize": "int4"}),
    "keep_self": ("mlp", {"exclude_self": False}),
    "k_past_a_shard": ("mlp", {"k": 80}),
    "five_nodes": ("mlp", {"h": "five", "query_ids": [0, 2, 4], "k": 3}),
}


def _topk_spec(case):
    mode, over = TOPK_CASES[case]
    spec = dict(h=_table(), predictor=_predictors()[mode], query_ids=QUERIES, k=K, block=16)
    spec.update(over)
    if isinstance(spec["h"], str):
        spec["h"] = _table(5)
    return spec


def _pipeline_spec():
    ei, comm = jax_sbm_graph(N, 4, 6.0, seed=21)
    x = np.asarray(jax_community_features(comm, 24, kind="gauss", seed=21), np.float32)
    params = init_teacher_params(jax.random.PRNGKey(17), encoder="sage", in_channels=24,
                                 hidden_channels=16, num_layers=2, predictor_mode="mlp")
    return dict(edge_index=np.asarray(ei, np.int64), num_nodes=N, x=x,
                params=jax.tree_util.tree_map(np.asarray, params), query_ids=QUERIES, k=5,
                block=16)


def _jobs(size):
    jobs = {}
    for name, case in _hits_cases().items():
        spec = {k: v for k, v in case.items() if k != "cut"}
        jobs[f"hits_{name}"] = ("hits_auc", dict(spec, cuts=_cuts(len(case["neg"]), size,
                                                                    case["cut"])))
    jobs.update({f"topk_{c}": ("topk", _topk_spec(c)) for c in TOPK_CASES})
    jobs["pipeline"] = ("pipeline", _pipeline_spec())
    return jobs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return Worlds(_jobs, SIZES, rendezvous=tmp_path_factory.mktemp("rendezvous"),
                  timeout=TIMEOUT, join_timeout=RUN_TIMEOUT)


@pytest.fixture(scope="module", autouse=True)
def jax_refs(worlds):
    """JAX's sharded metrics, top-Ks and pipeline, computed on threads (XLA
    compiles outside the interpreter lock) while the worlds run."""
    calls = {("hits", size): (_jax_hits, size) for size in SIZES}
    calls.update({("topk", case): (_jax_topk, _topk_spec(case), 4) for case in TOPK_CASES})
    calls.update({("pipeline", size): (_jax_pipeline, size) for size in SIZES})
    with ThreadPoolExecutor(REF_THREADS) as pool:
        futures = {key: pool.submit(fn, *args) for key, (fn, *args) in calls.items()}
        return {key: f.result() for key, f in futures.items()}


def _ranks(worlds, size, name):
    ranks = worlds[size][name]
    for r in ranks[1:]:  # every rank returns the same
        for key in ("vals", "ids"):
            if key in ranks[0]:
                assert np.array_equal(r[key], ranks[0][key])
    if "vals" not in ranks[0]:
        assert all(r == ranks[0] for r in ranks[1:])
    return ranks[0]


def _jax_hits(size):
    case = _hits_cases()["jax"]
    mesh = Mesh(np.asarray(jax.devices()[:size]), ("data",))
    out = make_sharded_hits_auc(mesh, case["ks"])(jnp.asarray(case["pos"]),
                                                  jnp.asarray(case["neg"]))
    return {k: float(v) for k, v in out.items()}


@pytest.mark.parametrize("size", SIZES)
def test_sharded_hits_auc_matches_jax(worlds, jax_refs, size):
    want = jax_refs["hits", size]
    got = _ranks(worlds, size, "hits_jax")
    for key, value in want.items():
        assert abs(got[key] - value) < 1e-6, key


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", list(_hits_cases()))
def test_sharded_hits_auc_matches_the_single_metrics(worlds, size, name):
    case = _hits_cases()[name]
    pos, neg = torch.from_numpy(case["pos"]), torch.from_numpy(case["neg"])
    got = _ranks(worlds, size, f"hits_{name}")
    for k in case["ks"]:
        assert got[f"Hits@{k}"] == float(hits_at_k(pos, neg, k)), k
    assert abs(got["AUC"] - float(roc_auc(pos, neg))) < 1e-6
    if name == "few":
        assert got["Hits@10"] == 1.0


def _jax_topk(spec, size):
    """JAX's sharded top-K of ``spec`` on ``size`` devices: the table
    padded to its mesh (int4 to twice the mesh), quantized whole."""
    mode = "inner" if not spec["predictor"]["lins"] else "mlp"
    h = jnp.asarray(spec["h"])
    n = h.shape[0]
    quantize = spec.get("quantize", "none")
    pad = (-n) % (2 * size if quantize == "int4" else size)
    hp = jnp.concatenate([h, jnp.zeros((pad, H), h.dtype)])
    qi = jnp.asarray(np.asarray(spec["query_ids"], np.int32))
    q_h = jnp.take(h, qi, axis=0)
    if quantize != "none":
        hp = jax_quantize_table(hp, bits=int(quantize[3:]))
        from llp_tpu.serve.engine import _take_rows

        q_h = _take_rows(hp, qi)
    mesh = Mesh(np.asarray(jax.devices()[:size]), ("data",))
    fn = make_sharded_topk_partners(
        mesh, k=spec["k"], mode=mode, num_nodes=n, block=spec["block"],
        exclude_self=spec.get("exclude_self", True), mlp_fused=spec.get("mlp_fused"),
        compute_dtype=jnp.bfloat16 if spec.get("compute_dtype") == "bfloat16" else None)
    pred = jax.tree_util.tree_map(jnp.asarray, spec["predictor"])
    vals, ids = fn(pred, hp, q_h, qi)
    return np.asarray(vals, np.float32), np.asarray(ids)


def _scores_of(spec, ids):
    """The single engine's score of each (query, returned id)."""
    table = torch.from_numpy(spec["h"])
    if spec.get("quantize", "none") != "none":
        table = quantize_table(table, int(spec["quantize"][3:]))
    pred = from_jax(spec["predictor"])
    q = np.repeat(np.asarray(spec["query_ids"]), ids.shape[1])
    flat = ids.reshape(-1)
    return score_pairs(pred, table, q, flat, fused=False).numpy().reshape(ids.shape)


def _assert_topk(spec, got_vals, got_ids, want_vals, want_ids, tol):
    np.testing.assert_allclose(got_vals, want_vals, atol=tol, rtol=0)
    q = np.asarray(spec["query_ids"])
    for r in range(len(q)):
        if spec.get("exclude_self", True):
            assert q[r] not in got_ids[r]
        gaps = np.abs(np.diff(want_vals[r]))
        apart = (np.concatenate([[np.inf], gaps]) > tol) & (np.concatenate([gaps, [np.inf]]) > tol)
        assert np.array_equal(got_ids[r][apart], want_ids[r][apart])
    if spec.get("compute_dtype") is None:  # at ties, by score
        np.testing.assert_allclose(_scores_of(spec, got_ids), got_vals, atol=tol, rtol=0)


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_sharded_topk_matches_jax(worlds, jax_refs, case):
    spec = _topk_spec(case)
    got = _ranks(worlds, 4, f"topk_{case}")
    vals, ids = jax_refs["topk", case]
    tol = BF16_TOL if spec.get("compute_dtype") else VAL_TOL
    _assert_topk(spec, got["vals"], got["ids"], vals, ids, tol)
    n = spec["h"].shape[0]
    assert got["vals"].shape == (len(spec["query_ids"]), min(spec["k"], n - 1))


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_sharded_topk_matches_the_single_engine(worlds, case):
    spec = _topk_spec(case)
    got = _ranks(worlds, 2, f"topk_{case}")
    table = torch.from_numpy(spec["h"])
    if spec.get("quantize", "none") != "none":
        table = quantize_table(table, int(spec["quantize"][3:]))
    dtype = torch.bfloat16 if spec.get("compute_dtype") else None
    vals, ids = top_k_partners(from_jax(spec["predictor"]), table, spec["query_ids"],
                               k=spec["k"], block=64, exclude_self=spec.get("exclude_self", True),
                               compute_dtype=dtype, mlp_fused=spec.get("mlp_fused"))
    _assert_topk(spec, got["vals"], got["ids"], vals.numpy(), ids.numpy(), VAL_TOL)
    four = _ranks(worlds, 4, f"topk_{case}")
    np.testing.assert_allclose(four["vals"], got["vals"], atol=VAL_TOL, rtol=0)


def test_a_five_node_table_leaves_a_rank_empty(worlds):
    ranks = worlds[4]["topk_five_nodes"]
    assert [r["rows"] for r in ranks] == [2, 2, 1, 0]
    assert [r["rows"] for r in worlds[4]["topk_mlp_int4"]] == [52, 52, 52, 47]


def _jax_pipeline(size):
    spec = _pipeline_spec()
    mesh = Mesh(np.asarray(jax.devices()[:size]), ("data",))
    g = jax_build_graph(spec["edge_index"], N)
    part = build_halo_partition(g, size)
    params = jax.tree_util.tree_map(jnp.asarray, spec["params"])
    h_sh = jax.jit(make_halo_encode(mesh, part, "sage", "sage", "none", "data"))(
        params, pad_nodes(jnp.asarray(spec["x"]), part),
        pad_nodes(np.asarray(jax.device_get(g.in_degree)), part))
    qi = jnp.asarray(np.asarray(QUERIES, np.int32))
    fn = make_sharded_topk_partners(mesh, k=5, mode="mlp", num_nodes=N, block=16)
    vals, _ = fn(params["predictor"], h_sh, jnp.take(h_sh, qi, axis=0), qi)
    return np.asarray(vals)


@pytest.mark.parametrize("size", SIZES)
def test_the_halo_encode_feeds_the_sharded_topk_as_in_jax(worlds, jax_refs, size):
    got = _ranks(worlds, size, "pipeline")
    np.testing.assert_allclose(got["vals"], jax_refs["pipeline", size], atol=VAL_TOL, rtol=0)
    for r, q in enumerate(QUERIES):
        assert q not in got["ids"][r] and -1 not in got["ids"][r]
