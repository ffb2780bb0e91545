"""Persistent link-prediction serving daemon, HTTP and JSON over the warm
engine (counterpart of ``llp_tpu/serve/server.py``).

The one-shot CLI answers one batch and exits, paying start-up, checkpoint
load and encode every time.  The daemon loads and encodes once and answers
queries until it is shut down.

* **One device worker, bounded backpressure.**  One thread
  (:class:`BatchingEngine`) runs all device work; connections are accepted
  concurrently (``ThreadingHTTPServer``) into a bounded wait queue, and a
  request past ``max_queue`` gets an orderly ``503``.
* **Cross-request batching.**  Requests that queue while a device call runs
  are merged into the next one: same-``k`` top-K queries concatenate into
  one retrieval call, score requests into one pair batch, chunked at the
  per-request caps.  Every output row depends only on its own query or
  pair, so merged results equal sequential ones.  Validation runs per
  request before merging, so one bad request gets its ``400`` alone.
* **No request bucketing.**  The JAX daemon pads each batch to a power of
  two so that XLA reuses a few compiled programs; PyTorch runs eagerly and
  compiles nothing per shape, so batches go to the engine at their own size.

Endpoints (all JSON):

* ``GET  /healthz``                             -> table metadata + counters
* ``POST /v1/topk``  {"queries": [int...], "k": int} -> partners + scores
* ``POST /v1/score`` {"pairs": [[src, dst]...]}     -> pair probabilities

The stdlib only: ``http.server`` and ``json``.  The node-sharded serving
state (``--shard``) is ROADMAP A14.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np
import torch

from llp_tpu_torch.serve.engine import score_pairs, top_k_partners
from llp_tpu_torch.serve.quant import QuantTable, quantize_table

MAX_BODY_BYTES = 16 << 20  # reject absurd request bodies before parsing
MAX_QUEUE = 8  # in-flight + waiting POSTs beyond this get an orderly 503


class ServingState:
    """Owns the embedding table and the predictor, and answers queries.

    ``quantize`` ("int8", "int4") stores the table per-row quantized
    (:mod:`llp_tpu_torch.serve.quant`).  ``fused=None`` takes the kernels
    (the SDDMM pair scorer and the fused retrieval kernel) for a supported
    'mlp' head when the table lies on the card; ``False`` never does."""

    def __init__(self, predictor, h: torch.Tensor, *, block: Optional[int] = None,
                 approx: bool = False, compute_dtype=None, fused: Optional[bool] = None,
                 max_queries: int = 4096, max_pairs: int = 1 << 20,
                 quantize: str = "none"):
        if quantize in ("int8", "int4"):
            h = quantize_table(h, bits=int(quantize[3:]))
        elif quantize != "none":
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.predictor = predictor
        self.h = h
        self.quantize = quantize
        self.mode = predictor.mode
        self.block = block
        self.approx = approx
        self.compute_dtype = compute_dtype
        self.fused = fused
        self.num_nodes = int(h.shape[0])
        self.dim = int(h.shape[1])
        self.requests = 0
        # Bound one request's device footprint: retrieval holds (Q, block)
        # score tiles and scoring gathers 2·P rows.
        self.max_queries = max_queries
        self.max_pairs = max_pairs

    @property
    def table_dtype(self) -> str:
        if isinstance(self.h, QuantTable):
            return self.h.fmt
        return str(self.h.dtype).removeprefix("torch.")

    def _check_ids(self, ids: np.ndarray, what: str):
        if ids.size == 0:
            raise ValueError(f"{what}: empty id list")
        if ids.min() < 0 or ids.max() >= self.num_nodes:
            raise ValueError(
                f"{what} out of range: table has {self.num_nodes} nodes "
                f"(got min {ids.min()}, max {ids.max()})"
            )

    def topk(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        qi = self.validate_topk(queries, k)
        vals, ids = top_k_partners(
            self.predictor, self.h, qi, k=k, block=self.block, approx=self.approx,
            compute_dtype=self.compute_dtype, mlp_fused=self.fused,
        )
        return vals.cpu().numpy(), ids.cpu().numpy()

    def score(self, pairs) -> np.ndarray:
        arr = self.validate_score(pairs)
        return score_pairs(self.predictor, self.h, arr[:, 0], arr[:, 1],
                           fused=self.fused).cpu().numpy()

    def validate_topk(self, queries, k: int) -> np.ndarray:
        """Per-request validation (no device work): the flat id array, or
        ``ValueError``.  Runs before cross-request batching, so a bad
        request can never poison a merged batch."""
        qi = np.asarray(queries, np.int64)
        if qi.ndim != 1:
            raise ValueError(
                f"queries must be a flat list of node ids, got a "
                f"{qi.ndim}-D array of shape {qi.shape}"
            )
        self._check_ids(qi, "queries")
        if qi.size > self.max_queries:
            raise ValueError(
                f"too many queries ({qi.size} > {self.max_queries}); split the request"
            )
        if not 1 <= k <= self.num_nodes - 1:
            raise ValueError(f"k must be in [1, {self.num_nodes - 1}], got {k}")
        return qi

    def validate_score(self, pairs) -> np.ndarray:
        arr = np.asarray(pairs, np.int64)
        if arr.ndim != 2 or arr.shape[1] != 2:
            raise ValueError("pairs must be a list of [src, dst] id pairs")
        if arr.shape[0] > self.max_pairs:
            raise ValueError(
                f"too many pairs ({arr.shape[0]} > {self.max_pairs}); split the request"
            )
        self._check_ids(arr.reshape(-1), "pairs")
        return arr

    def warmup(self, k: int = 10) -> None:
        """One top-K and one score before traffic, so the kernel libraries
        are built and loaded before the first request waits on them."""
        self.topk([0], k)
        self.score([[0, 0]])


class BatchingEngine:
    """Single-worker device executor with cross-request batching.

    One thread owns all device work.  Each drain cycle takes everything
    queued: same-``k`` top-K requests concatenate into one retrieval call and
    score requests into one pair batch (chunked at the state's per-request
    caps), then per-request slices resolve each waiter.  Payloads arrive
    validated (``validate_topk``/``validate_score``).  :meth:`close` stops
    the worker."""

    _STOP = object()

    def __init__(self, state: ServingState):
        self.state = state
        self.queue: _queue.Queue = _queue.Queue()
        self.batched_calls = 0     # device calls issued
        self.batched_requests = 0  # requests served through them
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, kind: str, payload) -> dict:
        item = {"kind": kind, "payload": payload,
                "done": threading.Event(), "result": None, "error": None}
        self.queue.put(item)
        return item

    def call(self, kind: str, payload, timeout: float = 600.0):
        item = self.submit(kind, payload)
        if not item["done"].wait(timeout):
            raise TimeoutError("device worker did not answer in time")
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker once it has served what is queued."""
        self.queue.put(self._STOP)
        self._thread.join(timeout)

    def _run(self):
        while True:
            items = [self.queue.get()]
            try:
                while True:
                    items.append(self.queue.get_nowait())
            except _queue.Empty:
                pass
            stop = any(it is self._STOP for it in items)
            self._execute([it for it in items if it is not self._STOP])
            if stop:
                return

    def _execute(self, items):
        topk_groups: dict = {}
        scores = []
        for it in items:
            if it["kind"] == "topk":
                topk_groups.setdefault(it["payload"][1], []).append(it)
            else:
                scores.append(it)
        for k, group in topk_groups.items():
            self._run_chunked(
                group, cap=self.state.max_queries,
                sizes=[it["payload"][0].size for it in group],
                concat=lambda its: np.concatenate([it["payload"][0] for it in its]),
                run=lambda merged, k=k: self.state.topk(merged, k),
                split=lambda res, off, n: (res[0][off:off + n], res[1][off:off + n]),
            )
        if scores:
            self._run_chunked(
                scores, cap=self.state.max_pairs,
                sizes=[it["payload"].shape[0] for it in scores],
                concat=lambda its: np.concatenate([it["payload"] for it in its], axis=0),
                run=self.state.score,
                split=lambda res, off, n: res[off:off + n],
            )

    def _run_chunked(self, items, *, cap, sizes, concat, run, split):
        # Greedy chunks that respect the per-call cap (each request is
        # already validated to fit it).
        i = 0
        while i < len(items):
            j, total = i, 0
            while j < len(items) and total + sizes[j] <= cap:
                total += sizes[j]
                j += 1
            chunk = items[i:j]
            try:
                res = run(concat(chunk))
                self.batched_calls += 1
                self.batched_requests += len(chunk)
                off = 0
                for it, n in zip(chunk, sizes[i:j]):
                    it["result"] = split(res, off, n)
                    off += n
            except Exception as e:  # noqa: BLE001 — the worker must resolve every waiter
                for it in chunk:
                    it["error"] = e
            finally:
                for it in chunk:
                    it["done"].set()
            i = j


def _make_handler(state: ServingState, engine: BatchingEngine, max_queue: int = MAX_QUEUE):
    # One device call at a time (the engine's worker); up to max_queue POSTs
    # may be in flight or waiting, the rest get 503.
    slots = threading.Semaphore(max_queue)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102 — no per-request stderr lines
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok", "nodes": state.num_nodes, "dim": state.dim,
                    "mode": state.mode, "table_dtype": state.table_dtype,
                    "requests": state.requests,
                    "device_calls": engine.batched_calls,
                    "batched_requests": engine.batched_requests,
                })
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_BODY_BYTES:
                self._reply(413, {"error": "request body too large"})
                return
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                self._reply(400, {"error": f"bad JSON: {e}"})
                return
            if not slots.acquire(blocking=False):
                self._reply(503, {
                    "error": f"server busy: more than {max_queue} requests queued; retry later"
                })
                return
            try:
                self._dispatch(req)
            finally:
                slots.release()

        def _dispatch(self, req):
            try:
                if self.path == "/v1/topk":
                    k = int(req.get("k", 10))
                    qi = state.validate_topk(req.get("queries", []), k)
                    vals, ids = engine.call("topk", (qi, k))
                    state.requests += 1
                    self._reply(200, {"results": [
                        {"query": int(q), "partners": row_i.tolist(),
                         "scores": [round(float(v), 6) for v in row_v]}
                        for q, row_v, row_i in zip(qi, vals, ids)
                    ]})
                elif self.path == "/v1/score":
                    pairs = state.validate_score(req.get("pairs", []))
                    scores = engine.call("score", pairs)
                    state.requests += 1
                    self._reply(200, {"scores": [round(float(v), 6) for v in scores]})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except (ValueError, TypeError, KeyError, AttributeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — answer an engine error, keep serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(state: ServingState, host: str = "127.0.0.1", port: int = 0, *,
                max_queue: int = MAX_QUEUE) -> ThreadingHTTPServer:
    """Bind (but do not start) the daemon; ``server.server_port`` is the
    port when ``port=0``, and ``server.engine`` the device worker, which
    ``server.engine.close()`` stops."""
    engine = BatchingEngine(state)
    srv = ThreadingHTTPServer((host, port), _make_handler(state, engine, max_queue))
    srv.daemon_threads = True
    srv.engine = engine
    return srv


def serve_forever(state: ServingState, host: str = "127.0.0.1", port: int = 8080, *,
                  max_queue: int = MAX_QUEUE, ready_line: bool = True) -> None:
    """Run the daemon until interrupted (the CLI's ``--port``)."""
    srv = make_server(state, host, port, max_queue=max_queue)
    if ready_line:
        print(json.dumps({
            "serving": f"http://{host}:{srv.server_port}",
            "nodes": state.num_nodes, "dim": state.dim, "mode": state.mode,
        }), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        srv.engine.close()


class BackgroundServer:
    """The daemon on a thread, for tests and for embedding in a process."""

    def __init__(self, state: ServingState, host: str = "127.0.0.1", port: int = 0, *,
                 max_queue: int = MAX_QUEUE):
        self.server = make_server(state, host, port, max_queue=max_queue)
        self.port = self.server.server_port
        self._thread: Optional[threading.Thread] = None

    def __enter__(self):
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.server.engine.close()
        if self._thread is not None:
            self._thread.join(timeout=10)
