"""The node-sharded serving daemon of the port (``ShardedServingState``,
``llp_tpu_torch/serve/server.py``, and ``cli.serve --shard``) over gloo
worlds of CPU ranks, after JAX's ``tests/test_server.py:208-238,245-301,
323-345,422-441``.

* Worlds of 2 and 4 serve tables one after another over HTTP: the 'mlp'
  head over fp32 rows (the whole table given, and each rank's rows alone),
  bf16 compute, int8 and int4 tables, request caps, and cross-request
  batching (a held first top-K; the three requests queued behind it merge
  into one device call).  Top-K and pair scores equal the single
  ``ServingState``'s as the daemon rounds them (to 6 decimals, from the
  same floats), ids equal; bf16 within 3e-2 of fp32 (JAX's bound); an id
  at or past N gets a 400, and so does a request past a cap.  Each rank
  holds its own rows only.  Worlds of 1, 2 and 4 run requests through
  the state directly (int8, int4 and fp32 rows), bit for bit with the
  single state: a world of one takes the sharded path over one rank.
* A world whose collectives time out after 5 s stays idle for 8 s, then
  answers; then its follower is killed, and rank 0 answers the next
  request with an error status and exits non-zero.
* ``python -m llp_tpu_torch.cli.serve --shard --device cpu:2 --port 0``
  beside JAX's CLI with the same flags, on a student checkpoint: both
  print ``"shards": 2``, their answers agree within 1e-5, and a SIGTERM
  ends the port's CLI and its rank processes.

Everything is started at the start of the module (the worlds, the idle
world's script and both CLIs), so that they overlap; 60 s timeouts on the
collectives (5 s in the idle world; the rendezvous waits at least
``TIMEOUT_S``), 300 s on a world's whole run.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.parallel.launch import free_tcp_address, launch
from llp_tpu_torch.serve.server import ServingState
from llp_tpu_torch.tools.dp_runs import run_jobs
from llp_tpu_torch.utils.params import from_jax, to_jax

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 60  # every collective and the rendezvous
IDLE_TIMEOUT, IDLE_S = 5, 8  # the idle world's collectives, and its pause
RUN_TIMEOUT = 300  # a world's whole run, on a loaded host
WAIT_S = 180  # a port file, a ready line
N, H = 203, 16
DATASET = "synthetic:sbm:60:3:4.0:1"


def _table(n, h=H, seed=1):
    return np.random.default_rng(seed).normal(size=(n, h)).astype(np.float32)


def _head(h=H, seed=2):
    return to_jax(LinkPredictor("mlp", h, h, generator=torch.Generator().manual_seed(seed)))


# name: a table of ``serve_run``, and the requests of its script
CONFIGS = {
    "fp32": dict(h=_table(N), predictor=_head(), block=32),
    "rows": dict(h=_table(N), predictor=_head(), block=32, rows=True),
    "bf16": dict(h=_table(120), predictor=_head(seed=6), block=32, compute_dtype="bfloat16"),
    "int8": dict(h=_table(N), predictor=_head(), quantize="int8"),
    "int4": dict(h=_table(N), predictor=_head(), quantize="int4"),
    "caps": dict(h=_table(40, 8), predictor=_head(8), block=16, max_queries=4, max_pairs=3),
    "batching": dict(h=_table(N), predictor=_head(), slow_first=1.5),
}
WORLDS = {1: [], 2: ["fp32", "bf16", "int8", "caps", "batching"], 4: ["fp32", "rows", "int4"]}


def _request(port, path, payload=None, timeout=60):
    """``(status, body)`` of a GET (no payload) or a JSON POST."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_file(path: Path, proc_alive=lambda: True) -> str:
    deadline = time.monotonic() + WAIT_S
    while not path.exists():
        if time.monotonic() > deadline or not proc_alive():
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.05)
    return path.read_text()


def _script(name, port):
    """The requests sent to table ``name``'s daemon, and their answers."""
    n = CONFIGS[name]["h"].shape[0]
    out = {}
    if name == "caps":
        out["queries_cap"] = _request(port, "/v1/topk", {"queries": [0, 1, 2, 3, 4], "k": 2})
        out["pairs_cap"] = _request(port, "/v1/score", {"pairs": [[0, 1]] * 4})
        out["within"] = _request(port, "/v1/topk", {"queries": [0, 1], "k": 2})
        return out
    if name == "batching":
        with ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(_request, port, "/v1/topk", {"queries": [0, 1], "k": 4})]
            time.sleep(0.5)  # request 0 reaches the held device call
            futs += [ex.submit(_request, port, "/v1/topk", {"queries": [3 * i, 3 * i + 1],
                                                            "k": 4}) for i in (1, 2, 3)]
            out["topk"] = [f.result() for f in futs]
        out["health"] = _request(port, "/healthz")
        return out
    queries = [0, 7, n - 1] if name == "bf16" else [0, 50, n - 1]
    out["health"] = _request(port, "/healthz")
    out["topk"] = _request(port, "/v1/topk", {"queries": queries, "k": 6})
    out["score"] = _request(port, "/v1/score", {"pairs": [[0, 5], [3, 77], [n - 1, 1]]})
    out["bad_query"] = _request(port, "/v1/topk", {"queries": [n], "k": 3})
    out["bad_pair"] = _request(port, "/v1/score", {"pairs": [[0, n]]})
    return out


# the direct calls of ``state_run`` (rank 0 calling the state, no HTTP)
STATE_REQUESTS = [("topk", [0, 50, N - 1], 6), ("topk", [3, 4], 50), ("score", [[0, 5], [3, 77]])]
STATE_QUANTIZE = {1: "int8", 2: "int4", 4: "none"}


def _state_spec(size, d: Path):
    np.save(d / "table.npy", CONFIGS["fp32"]["h"])
    return {"h": str(d / "table.npy"), "predictor": CONFIGS["fp32"]["predictor"],
            "quantize": STATE_QUANTIZE[size], "requests": STATE_REQUESTS}


def _world(size, d: Path):
    """A world of ``size`` ranks serving :data:`WORLDS`' tables, each
    driven by its script, then :data:`STATE_REQUESTS` through
    ``state_run``; returns the answers and the ranks' results."""
    names = WORLDS[size]
    d.mkdir()
    spec = {"dir": str(d), "configs": [CONFIGS[name] for name in names]}
    jobs = [("serve", spec), ("state", _state_spec(size, d))]
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(launch, run_jobs, ["cpu"] * size, jobs,
                        init_method=free_tcp_address(), timeout=TIMEOUT,
                        join_timeout=RUN_TIMEOUT)
        answers = {}
        try:
            for i, name in enumerate(names):
                port = int(_wait_file(d / f"port{i}", lambda: not fut.done()))
                answers[name] = _script(name, port)
                (d / f"stop{i}").touch()
        finally:
            for i in range(len(names)):
                (d / f"stop{i}").touch()
        res = fut.result()
    return answers, [r[0] for r in res], [r[1] for r in res]


def _idle_world(d: Path):
    """5 s timeouts, an 8 s pause between two top-Ks, then the follower
    killed and a third top-K."""
    d.mkdir()
    spec = {"dir": str(d), "configs": [CONFIGS["fp32"]]}
    out = {}
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(launch, run_jobs, ["cpu"] * 2, [("serve", spec)],
                        init_method=free_tcp_address(), timeout=IDLE_TIMEOUT,
                        join_timeout=RUN_TIMEOUT, failure_grace=60)
        try:
            port = int(_wait_file(d / "port0", lambda: not fut.done()))
            payload = {"queries": [0, 50], "k": 6}
            out["before"] = _request(port, "/v1/topk", payload)
            time.sleep(IDLE_S)
            out["after_idle"] = _request(port, "/v1/topk", payload)
            os.kill(int(_wait_file(d / "pid1")), signal.SIGKILL)
            out["after_kill"] = _request(port, "/v1/topk", payload)
        finally:
            (d / "stop0").touch()
        try:
            fut.result()
            out["launch"] = "returned"
        except RuntimeError as e:
            out["launch"] = str(e)
    out["failed"] = (d / "failed0").read_text() if (d / "failed0").exists() else None
    out["rank0_pid"] = int((d / "pid0").read_text())
    return out


def _checkpoint(tmp: Path) -> str:
    from llp_tpu.data.registry import get_dataset
    from llp_tpu.models.mlp import init_mlp
    from llp_tpu.models.predictor import init_link_predictor
    from llp_tpu.utils.checkpoint import save_checkpoint
    import jax

    ds = get_dataset(str(tmp), DATASET)
    key = jax.random.PRNGKey(4)
    enc = init_mlp(jax.random.fold_in(key, 0), 2, int(ds.x.shape[1]), 24, 24)
    pred = init_link_predictor(jax.random.fold_in(key, 1), "mlp", 24, 24, 1, 2)
    ck = str(tmp / "student-ck")
    save_checkpoint(ck, {"params": {"encoder": enc, "predictor": pred}},
                    meta={"encoder": "mlp", "predictor": "mlp", "norm_type": "none"})
    return ck


def _clis(tmp: Path):
    """Both packages' ``--shard --device cpu:2 --port 0 --warmup 4``
    daemons, started together."""
    ck = _checkpoint(tmp)
    flags = ["--checkpoint", ck, "--datasets", DATASET, "--dataset_dir", str(tmp),
             "--device", "cpu:2", "--port", "0", "--shard", "--warmup", "4"]
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    jax_env = dict(env, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
                   JAX_COMPILATION_CACHE_DIR="")
    return {name: subprocess.Popen([sys.executable, "-m", module, *flags], cwd=ROOT,
                                   env=jax_env if name == "jax" else env,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name, module in (("torch", "llp_tpu_torch.cli.serve"),
                                 ("jax", "llp_tpu.cli.serve"))}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_server")
    pool = ThreadPoolExecutor(3)
    futures = {size: pool.submit(_world, size, root / f"world{size}") for size in WORLDS}
    futures["idle"] = pool.submit(_idle_world, root / "idle")
    clis = _clis(root)
    try:
        yield futures, clis
    finally:
        for proc in clis.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        pool.shutdown(wait=True)


def _single(name):
    cfg = CONFIGS[name]
    dtype = torch.bfloat16 if cfg.get("compute_dtype") else None
    return ServingState(from_jax(cfg["predictor"]), torch.from_numpy(cfg["h"]), block=64,
                        quantize=cfg.get("quantize", "none"), compute_dtype=dtype)


def _rounded(values):
    return [[round(float(v), 6) for v in row] for row in np.atleast_2d(values)]


@pytest.mark.parametrize("size,name", [(s, n) for s in WORLDS for n in WORLDS[s]
                                       if n not in ("caps", "batching")])
def test_the_sharded_daemon_answers_as_the_single_state(started, size, name):
    answers, ranks, _ = started[0][size].result()
    got = answers[name]
    n = CONFIGS[name]["h"].shape[0]
    assert got["health"][1]["nodes"] == n
    status, body = got["topk"]
    assert status == 200
    queries = [r["query"] for r in body["results"]]
    ref = _single(name)
    vals, ids = ref.topk(queries, 6)
    if name == "bf16":  # against fp32 scores, JAX's bound
        fp32 = ServingState(from_jax(CONFIGS[name]["predictor"]),
                            torch.from_numpy(CONFIGS[name]["h"]), block=64)
        np.testing.assert_allclose([r["scores"] for r in body["results"]],
                                   fp32.topk(queries, 6)[0], atol=0.03)
    assert [r["scores"] for r in body["results"]] == _rounded(vals)
    assert [r["partners"] for r in body["results"]] == ids.tolist()
    for r in body["results"]:
        assert r["query"] not in r["partners"]
    status, body = got["score"]
    assert status == 200
    assert body["scores"] == _rounded(ref.score([[0, 5], [3, 77], [n - 1, 1]]))[0]
    for key in ("bad_query", "bad_pair"):
        status, body = got[key]
        assert status == 400 and "out of range" in body["error"] and f"{n} nodes" in body["error"]
    # each rank keeps its own rows, about 1/P of the table
    i = WORLDS[size].index(name)
    held = [r[i]["bytes"] for r in ranks]
    assert max(held) <= -(-ref.h.nbytes // size) + 4 * H + 8
    assert [r[i]["requests"] for r in ranks[1:]] == [2] * (size - 1)  # the top-K, the score


def test_request_caps_are_the_states(started):
    answers, _, _ = started[0][2].result()
    got = answers["caps"]
    assert got["queries_cap"][0] == 400 and "too many queries" in got["queries_cap"][1]["error"]
    assert got["pairs_cap"][0] == 400 and "too many pairs" in got["pairs_cap"][1]["error"]
    assert got["within"][0] == 200 and len(got["within"][1]["results"]) == 2


def test_queued_requests_merge_into_one_device_call(started):
    answers, ranks, _ = started[0][2].result()
    got = answers["batching"]
    ref = _single("batching")
    for i, (status, body) in enumerate(got["topk"]):
        assert status == 200
        qs = [0, 1] if i == 0 else [3 * i, 3 * i + 1]
        vals, ids = ref.topk(qs, 4)
        assert [r["scores"] for r in body["results"]] == _rounded(vals)
        assert [r["partners"] for r in body["results"]] == ids.tolist()
    health = got["health"][1]
    assert (health["device_calls"], health["batched_requests"]) == (2, 4)
    i = WORLDS[2].index("batching")
    assert ranks[1][i]["requests"] == 2  # the follower ran the two calls


def test_an_idle_daemon_outlives_its_collective_timeout(started):
    out = started[0]["idle"].result()
    assert out["before"][0] == 200 and out["after_idle"] == out["before"]


def test_a_killed_follower_gets_an_error_status_and_rank0_exits(started):
    out = started[0]["idle"].result()
    status, body = out["after_kill"]
    assert status == 500 and "did not take request" in body["error"]
    assert out["failed"] is not None and "stopped after a failure" in out["failed"]
    assert "llp-rank1 exited with code -9" in out["launch"]
    with pytest.raises(ProcessLookupError):  # rank 0 has exited
        os.kill(out["rank0_pid"], 0)


def _read(stream, lines: queue.Queue):
    for line in stream:
        lines.put(line)
    lines.put(None)


def _ready(proc) -> tuple:
    """``(summary, port)`` from a daemon's stdout, read on a thread, so that
    a silent daemon cannot hold the test past ``WAIT_S``."""
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=_read, args=(proc.stdout, lines), daemon=True).start()
    summary = None
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            proc.wait(timeout=30)
            raise AssertionError(f"the daemon exited: {proc.stderr.read()[-3000:]}")
        msg = json.loads(line)
        if "serving" in msg:
            return summary, int(msg["serving"].rsplit(":", 1)[1])
        summary = msg
    raise TimeoutError("no ready line")


def _children(pid: int) -> list:
    out = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(stat.parent.name))
    return out


def test_the_shard_cli_answers_as_jaxs(started):
    clis = started[1]
    (ours, port), (theirs, jax_port) = _ready(clis["torch"]), _ready(clis["jax"])
    assert ours["shards"] == theirs["shards"] == 2 and ours["nodes"] == theirs["nodes"] == 60
    topk = {"queries": [3, 17, 59], "k": 4}
    pairs = {"pairs": [[0, 5], [3, 7], [59, 1]]}
    a, b = _request(port, "/v1/topk", topk), _request(jax_port, "/v1/topk", topk)
    assert a[0] == b[0] == 200
    for x, y in zip(a[1]["results"], b[1]["results"]):
        np.testing.assert_allclose(x["scores"], y["scores"], atol=1e-5)
        assert len(x["partners"]) == 4 and x["query"] not in x["partners"]
    a, b = _request(port, "/v1/score", pairs), _request(jax_port, "/v1/score", pairs)
    np.testing.assert_allclose(a[1]["scores"], b[1]["scores"], atol=1e-5)
    assert _request(port, "/v1/topk", {"queries": [60], "k": 3})[0] == 400
    proc = clis["torch"]
    ranks = _children(proc.pid)
    assert len(ranks) >= 2  # the two ranks (and the resource tracker)
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0
    deadline = time.monotonic() + 30
    while any(Path(f"/proc/{pid}").exists() for pid in ranks) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not [pid for pid in ranks if Path(f"/proc/{pid}").exists()]


@pytest.mark.parametrize("size", sorted(WORLDS))
def test_every_table_was_served_in_its_world(started, size):
    answers, ranks, _ = started[0][size].result()
    assert list(answers) == WORLDS[size] and len(ranks) == size


@pytest.mark.parametrize("size", sorted(WORLDS))
def test_the_state_over_each_ranks_rows_is_the_single_state_bit_for_bit(started, size):
    # rank 0 calls the state directly; int4 rows given per rank start on even rows
    ranks = started[0][size].result()[2]
    ref = ServingState(from_jax(CONFIGS["fp32"]["predictor"]),
                       torch.from_numpy(CONFIGS["fp32"]["h"]), quantize=STATE_QUANTIZE[size])
    for (op, *args), got in zip(STATE_REQUESTS, ranks[0]["answers"]):
        want = ref.topk(*args) if op == "topk" else ref.score(*args)
        for a, b in zip(got if op == "topk" else [got], want if op == "topk" else [want]):
            assert np.array_equal(a, b), op
    bounds = {1: [203], 2: [102, 101], 4: [51, 51, 51, 50]}[size]
    assert [r["rows"] for r in ranks] == bounds
    assert all(r["bytes_in_use"] is None for r in ranks)  # no card here
