"""The serving daemon (``llp_tpu_torch/serve/server.py``) on the CPU: its
state answers as the JAX package's ``ServingState`` does, for fp32, int8 and
int4 tables; its HTTP answers equal direct engine calls; bad requests get
their 400s, 404s and 413s, a full queue its 503; queued requests merge into
one device call with the results of sequential ones; and the CLI daemon
serves what the one-shot CLI prints.

Every wait has a deadline (sockets 30 s, joins and the daemon's start-up
60 s), so a hung daemon fails its test instead of stalling the run."""

import concurrent.futures
import json
import os
import queue
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.models.mlp import init_mlp
from llp_tpu.models.predictor import init_link_predictor
from llp_tpu.serve.server import ServingState as JaxServingState
from llp_tpu.utils.checkpoint import save_checkpoint
from llp_tpu_torch.cli import serve as torch_serve
from llp_tpu_torch.serve import server
from llp_tpu_torch.serve.engine import score_pairs, top_k_partners
from llp_tpu_torch.serve.server import BackgroundServer, BatchingEngine, ServingState
from llp_tpu_torch.utils.params import from_jax

ROOT = Path(__file__).resolve().parents[1]
N, D = 100, 16
TIMEOUT = 30


def _tree(mode="mlp", seed=2):
    return jax.tree_util.tree_map(
        np.asarray, init_link_predictor(jax.random.PRNGKey(seed), mode, D, D, 1, 2))


def _h(seed=1):
    return np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)


@pytest.fixture(scope="module")
def served():
    tree, h = _tree(), _h()
    state = ServingState(from_jax(tree), torch.from_numpy(h), block=64)
    with BackgroundServer(state) as srv:
        yield state, srv, tree, h


def _post(port, path, payload, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _status(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    return 200, None


@pytest.mark.parametrize("quantize", ["none", "int8", "int4"])
@pytest.mark.parametrize("mode", ["mlp", "inner"])
def test_serving_state_answers_like_jax(quantize, mode):
    tree, h = _tree(mode), 0.3 * _h()
    ref = JaxServingState(tree, jnp.asarray(h), mode=mode, quantize=quantize)
    got = ServingState(from_jax(tree), torch.from_numpy(h), quantize=quantize)
    assert (got.num_nodes, got.dim, got.mode) == (ref.num_nodes, ref.dim, ref.mode)
    assert got.table_dtype == (ref.h.fmt if quantize != "none" else "float32")
    queries = [0, 7, 99, 42, 7]
    rv, ri = ref.topk(queries, 6)
    tv, ti = got.topk(queries, 6)
    np.testing.assert_array_equal(ti, ri)  # a Gaussian table: no ties
    np.testing.assert_allclose(tv, rv, atol=3e-6, rtol=0)
    pairs = [[0, 5], [3, 77], [99, 1], [42, 42]]
    np.testing.assert_allclose(got.score(pairs), ref.score(pairs), atol=1e-6, rtol=0)


def test_serving_state_rejects_an_unknown_format():
    with pytest.raises(ValueError, match="unknown quantize mode"):
        ServingState(from_jax(_tree()), torch.from_numpy(_h()), quantize="int2")


def test_healthz(served):
    state, srv, _, _ = served
    out = _get(srv.port, "/healthz")
    assert out["status"] == "ok"
    assert (out["nodes"], out["dim"], out["mode"]) == (N, D, "mlp")
    assert out["table_dtype"] == "float32"
    for key in ("requests", "device_calls", "batched_requests"):
        assert isinstance(out[key], int)


def test_topk_and_score_endpoints_equal_the_engine(served):
    state, srv, _, h = served
    queries, k = [3, 17, 42], 5
    out = _post(srv.port, "/v1/topk", {"queries": queries, "k": k})
    vals, ids = top_k_partners(state.predictor, torch.from_numpy(h), queries, k=k, block=64)
    for r, res in enumerate(out["results"]):
        assert res["query"] == queries[r]
        assert res["partners"] == ids[r].tolist()
        np.testing.assert_allclose(res["scores"], vals[r].numpy(), atol=1e-6)
    pairs = [[0, 5], [3, 77], [99, 1]]
    out = _post(srv.port, "/v1/score", {"pairs": pairs})
    want = score_pairs(state.predictor, torch.from_numpy(h), [0, 3, 99], [5, 77, 1])
    np.testing.assert_allclose(out["scores"], want.numpy(), atol=1e-6)
    before = _get(srv.port, "/healthz")["requests"]
    _post(srv.port, "/v1/score", {"pairs": [[1, 2]]})
    assert _get(srv.port, "/healthz")["requests"] == before + 1


@pytest.mark.parametrize("path,payload,match", [
    ("/v1/topk", {"queries": [], "k": 3}, "empty id list"),
    ("/v1/topk", {"queries": [0, 100], "k": 3}, "out of range"),
    ("/v1/topk", {"queries": [-1], "k": 3}, "out of range"),
    ("/v1/topk", {"queries": [[0, 1]], "k": 3}, "flat list"),
    ("/v1/topk", {"queries": [0], "k": 0}, "k must be"),
    ("/v1/topk", {"queries": [0], "k": N}, "k must be"),
    ("/v1/topk", {"queries": [0], "k": "x"}, "invalid literal"),
    ("/v1/score", {"pairs": [[0, 1, 2]]}, "src, dst"),
    ("/v1/score", {"pairs": [[0, 100]]}, "out of range"),
    ("/v1/score", {"pairs": []}, "src, dst"),
])
def test_validation_errors_are_400(served, path, payload, match):
    _, srv, _, _ = served
    code, body = _status(lambda: _post(srv.port, path, payload))
    assert code == 400 and match in body["error"]


@pytest.mark.parametrize("raw,code", [(b"{not json", 400), (b"[1, 2]", 400)])
def test_bad_bodies_are_400(served, raw, code):
    _, srv, _, _ = served
    got, body = _status(lambda: _post(srv.port, "/v1/topk", None, raw=raw))
    assert got == code and "error" in body


def test_unknown_paths_are_404_and_big_bodies_413(served, monkeypatch):
    _, srv, _, _ = served
    assert _status(lambda: _get(srv.port, "/nope"))[0] == 404
    assert _status(lambda: _post(srv.port, "/v1/nope", {}))[0] == 404
    monkeypatch.setattr(server, "MAX_BODY_BYTES", 10)
    assert _status(lambda: _post(srv.port, "/v1/score", {"pairs": [[0, 1]] * 5}))[0] == 413


def test_request_size_caps():
    state = ServingState(from_jax(_tree()), torch.from_numpy(_h()), max_queries=4, max_pairs=3)
    with pytest.raises(ValueError, match="too many queries"):
        state.topk([0, 1, 2, 3, 4], 2)
    with pytest.raises(ValueError, match="too many pairs"):
        state.score([[0, 1]] * 4)
    assert state.topk([0, 1, 2, 3], 2)[0].shape == (4, 2)
    with BackgroundServer(state) as srv:
        code, body = _status(lambda: _post(srv.port, "/v1/topk", {"queries": list(range(5)),
                                                                  "k": 2}))
        assert code == 400 and "too many queries" in body["error"]


def test_backpressure_503_past_the_queue_bound():
    class SlowState:
        num_nodes, dim, mode, requests, table_dtype = N, D, "mlp", 0, "float32"
        max_queries, max_pairs = 4096, 4096

        def __init__(self):
            self.release = threading.Event()

        def validate_topk(self, queries, k):
            return np.asarray(queries, np.int64)

        def topk(self, queries, k):
            self.release.wait(timeout=TIMEOUT)
            q = np.asarray(queries)
            return np.zeros((q.size, k), np.float32), np.zeros((q.size, k), np.int64)

    state = SlowState()
    with BackgroundServer(state, max_queue=1) as srv:
        def one(i):
            return _status(lambda: _post(srv.port, "/v1/topk", {"queries": [i], "k": 2}))[0]

        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            futs = [ex.submit(one, i) for i in range(3)]
            time.sleep(1.0)  # all three arrive while the first blocks
            state.release.set()
            codes = sorted(f.result(timeout=TIMEOUT) for f in futs)
    assert codes.count(503) >= 1 and codes.count(200) >= 1, codes


def test_cross_request_batching_merges_queued_requests(served):
    _, _, tree, h = served
    ref = ServingState(from_jax(tree), torch.from_numpy(h), block=64)

    class GatedState(ServingState):
        def __init__(self):
            super().__init__(from_jax(tree), torch.from_numpy(h), block=64)
            self.calls = []
            self.gate = threading.Event()

        def topk(self, queries, k):
            first = not self.calls
            self.calls.append(np.asarray(queries).size)
            if first:
                self.gate.wait(timeout=TIMEOUT)
            return super().topk(queries, k)

    gated = GatedState()
    with BackgroundServer(gated) as srv:
        def one(i):
            return _post(srv.port, "/v1/topk", {"queries": [3 * i, 3 * i + 1], "k": 4})

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(one, 0)]
            time.sleep(0.7)  # request 0 reaches the blocked device call
            futs += [ex.submit(one, i) for i in (1, 2, 3)]
            time.sleep(0.7)  # requests 1-3 queue behind it
            gated.gate.set()
            outs = [f.result(timeout=TIMEOUT) for f in futs]
    assert gated.calls == [2, 6], gated.calls  # one solo call, one merged call
    for i, out in enumerate(outs):
        for row, q in zip(out["results"], (3 * i, 3 * i + 1)):
            rv, ri = ref.topk([q], 4)
            assert row["query"] == q and row["partners"] == ri[0].tolist()
            np.testing.assert_allclose(row["scores"], rv[0], atol=1e-6)


def test_batched_requests_chunk_at_the_caps():
    state = ServingState(from_jax(_tree()), torch.from_numpy(_h()), block=16, max_queries=5,
                         max_pairs=4)
    engine = BatchingEngine(state)
    try:
        items = [engine.submit("topk", (np.arange(i, i + 3), 4)) for i in range(0, 12, 3)]
        items += [engine.submit("score", np.array([[i, i + 1], [i + 2, i]])) for i in range(3)]
        for it in items:
            assert it["done"].wait(TIMEOUT) and it["error"] is None
        assert engine.batched_calls >= 2 + 2  # 12 queries past a cap of 5, 6 pairs past 4
        for i, it in enumerate(items[:4]):
            rv, ri = state.topk(np.arange(3 * i, 3 * i + 3), 4)
            np.testing.assert_array_equal(it["result"][1], ri)
            np.testing.assert_allclose(it["result"][0], rv, atol=1e-6)
        for i, it in enumerate(items[4:]):
            np.testing.assert_allclose(it["result"], state.score([[i, i + 1], [i + 2, i]]),
                                       atol=1e-6)
    finally:
        engine.close()
    assert not engine._thread.is_alive()


def test_engine_errors_reach_every_waiter_and_warmup_runs():
    state = ServingState(from_jax(_tree()), torch.from_numpy(_h()))
    state.warmup(3)
    engine = BatchingEngine(state)
    try:
        bad = engine.submit("topk", (np.array([0]), 0))  # k=0 skipped validation
        assert bad["done"].wait(TIMEOUT) and bad["error"] is not None
        with pytest.raises(ValueError):
            engine.call("topk", (np.array([0]), 0), timeout=TIMEOUT)
        assert engine.call("topk", (np.array([1]), 2), timeout=TIMEOUT)[1].shape == (1, 2)
    finally:
        engine.close()


def test_concurrent_clients_are_all_served(served):
    _, srv, _, _ = served

    def one(i):
        return _post(srv.port, "/v1/topk", {"queries": [i, i + 1], "k": 3})

    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        outs = list(ex.map(one, range(6), timeout=TIMEOUT))
    assert [[r["query"] for r in o["results"]] for o in outs] == [[i, i + 1] for i in range(6)]


# -------------------------------------------------------------- CLI daemon

DATASET = "synthetic:sbm:300:4:6.0:1:48:gauss"


def _student_checkpoint(tmp_path):
    key = jax.random.PRNGKey(3)
    enc = init_mlp(jax.random.fold_in(key, 0), 2, 48, 32, 32)
    pred = init_link_predictor(jax.random.fold_in(key, 1), "mlp", 32, 32, 1, 2)
    ck = str(tmp_path / "student")
    save_checkpoint(ck, {"params": {"encoder": enc, "predictor": pred}},
                    meta={"encoder": "mlp", "predictor": "mlp", "norm_type": "none"})
    return ck


def _lines(proc, out: queue.Queue):
    for line in proc.stdout:
        out.put(line)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_cli_daemon_serves_what_the_one_shot_cli_prints(quantize, tmp_path, capsys):
    ck = _student_checkpoint(tmp_path)
    common = [f"--checkpoint={ck}", f"--datasets={DATASET}", f"--dataset_dir={tmp_path}",
              "--device=cpu", f"--quantize={quantize}"]
    torch_serve.main(common + ["--topk=4", "--queries=0,7", "--pairs=0:5,3:77"])
    oneshot = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "llp_tpu_torch.cli.serve", *common, "--port=0", "--warmup=4",
         "--max_queue=4"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=_lines, args=(proc, lines), daemon=True)
    reader.start()
    try:
        port, deadline = None, time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            try:
                msg = json.loads(lines.get(timeout=max(0.1, deadline - time.monotonic())))
            except queue.Empty:
                break
            if "serving" in msg:
                port = int(msg["serving"].rsplit(":", 1)[1])
        assert port is not None, "the daemon printed no ready line within 60 s"
        health = _get(port, "/healthz")
        assert (health["nodes"], health["table_dtype"]) == (300, quantize)
        out = _post(port, "/v1/topk", {"queries": [0, 7], "k": 4})
        for res, want in zip(out["results"], oneshot[:2]):
            assert res["query"] == want["query"] and res["partners"] == want["partners"]
            np.testing.assert_allclose(res["scores"], want["scores"], atol=1e-6)
        out = _post(port, "/v1/score", {"pairs": [[0, 5], [3, 77]]})
        np.testing.assert_allclose(out["scores"], oneshot[2]["scores"], atol=1e-6)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=20)
        proc.stderr.close()
        reader.join(timeout=20)
