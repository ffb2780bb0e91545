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

The stdlib only: ``http.server`` and ``json``.

:class:`ShardedServingState` serves a table whose rows the ranks of a world
own in contiguous blocks (the CLI's ``--shard``).  Rank 0 owns the HTTP
server and the batching engine; every other rank runs
:meth:`ShardedServingState.follow`, which executes the same calls.  A
follower never waits inside a collective for the next request: rank 0 posts
each request's header (operation, sizes, sequence number) to the process
group's store, and the ranks post the request's collectives only once every
follower has taken the header.  A stop header ends the followers; a
follower that does not take a header in time, or a collective that fails,
gets the request an error status and stops the daemon with a non-zero exit.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np
import torch

from llp_tpu_torch.parallel.mesh import World
from llp_tpu_torch.serve.engine import score_pairs, top_k_partners
from llp_tpu_torch.serve.quant import QuantTable, codes_rows, dequantize_rows, quantize_table

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


def shard_bounds(num_nodes: int, size: int, bits: Optional[int] = None) -> List[int]:
    """The first row each of ``size`` ranks owns of a ``num_nodes``-row
    table, and ``num_nodes`` last: ``ceil(N/P)`` rows a rank
    (:func:`llp_tpu_torch.parallel.halo.owned_rows`), or for an int4 table,
    which packs two rows a storage row, an even count, so that every shard
    starts on a storage row (the JAX state pads to a multiple of ``2P``)."""
    per = -(-num_nodes // size)
    if bits == 4:
        per += per % 2
    return [min(r * per, num_nodes) for r in range(size)] + [num_nodes]


def _store():
    """The default process group's key-value store."""
    import torch.distributed as dist

    return dist.distributed_c10d._get_default_store()


# Seconds rank 0 waits for every follower to take a request's header, at
# most (and no longer than the world's collectives wait); the longest pause
# between two polls of the store.
ACK_TIMEOUT_S = 60.0
POLL_S = 0.01


def _poll(store, key: str, deadline: Optional[float] = None) -> bool:
    """Wait until ``key`` is in the store (True) or ``deadline`` passes
    (False).  Polls with ``check``, which returns at once: a blocking
    ``wait`` that times out logs a warning, and the followers wait for the
    next request without end."""
    pause = 2e-4
    while not store.check([key]):
        if deadline is not None and time.monotonic() > deadline:
            return False
        time.sleep(pause)
        pause = min(2 * pause, POLL_S)
    return True


class ShardedServingState(ServingState):
    """A :class:`ServingState` over a table whose rows the ranks of
    ``world`` own in contiguous blocks (:func:`shard_bounds`): the
    counterpart of ``llp_tpu/serve/server.py``'s ``ShardedServingState``.

    ``h`` is the whole (N, H) table, of which the rank keeps a copy of its
    rows, or with ``num_nodes`` given the rank's rows alone, those of
    :func:`shard_bounds` (for int4, its even blocks).  The rows are
    quantized in place (``quantize``); ids are checked against ``N``.

    Rank 0 validates and answers (:meth:`topk`, :meth:`score`, behind the
    HTTP server); every other rank runs :meth:`follow`.  A top-K
    broadcasts the query ids, sums the queries' rows from their owners
    into every rank and retrieves through
    :func:`llp_tpu_torch.parallel.eval.sharded_topk_partners`.  A score
    broadcasts the pairs' distinct ids, brings each id's row from its owner
    to rank 0 once (``all_to_all``) and scores there through
    :func:`llp_tpu_torch.serve.engine.score_pairs` (B3 on the card).
    Quantized rows travel as their codes and scales, so rank 0 scores the
    values the single state does.  A world of one runs the same path (its
    collectives over one rank) and posts no header: it has no followers."""

    def __init__(self, predictor, h, *, world: World, num_nodes: Optional[int] = None,
                 **kwargs):
        quantize = kwargs.get("quantize", "none")
        n = int(h.shape[0]) if num_nodes is None else int(num_nodes)
        self.bounds = shard_bounds(n, world.size, 4 if quantize == "int4" else None)
        lo, hi = self.bounds[world.rank], self.bounds[world.rank + 1]
        if num_nodes is None:
            h = h[lo:hi].clone() if hi - lo < n else h
        elif h.shape[0] != hi - lo:
            raise ValueError(f"rank {world.rank} owns rows [{lo}, {hi}), got {h.shape[0]}")
        super().__init__(predictor, h, **kwargs)
        self.num_nodes = n  # ids are checked against the real rows
        self.row0 = lo
        self.world = world
        self.seq = 0
        self.failed: Optional[BaseException] = None
        self.store = _store() if world.size > 1 else None
        # the ranks build their states in the same order: one key space each
        ShardedServingState.built += 1
        self.prefix = f"llp_serve/{ShardedServingState.built}/"

    built = 0  # states built in this process

    # -- rank 0 -----------------------------------------------------------
    def topk(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        qi = self.validate_topk(queries, k)
        return self._run("topk", self._topk, torch.from_numpy(qi), k=k, n=int(qi.size))

    def score(self, pairs) -> np.ndarray:
        arr = torch.from_numpy(self.validate_score(pairs))
        ids, inv = torch.unique(arr, return_inverse=True)  # sorted: owners in rank order
        return self._run("score", self._score, ids, inv, n=int(arr.shape[0]),
                         u=int(ids.shape[0]))

    def stop(self) -> None:
        """Rank 0: end every follower's :meth:`follow` (waits for them to
        take the stop header, as for any request)."""
        if self.world.size > 1 and self.failed is None:
            self._post({"op": "stop"})

    def _run(self, op: str, fn, *args, **header):
        if self.failed is not None:
            raise RuntimeError(f"the sharded state stopped after a failure: {self.failed}")
        try:
            self._post({"op": op, **header})
            return fn(*args, **header)
        except Exception as e:
            self.failed = e
            raise

    def _post(self, header: dict) -> None:
        """Rank 0: the next header, and the wait for every follower to take
        it; raises ``RuntimeError`` past the wait."""
        self.seq += 1
        if self.world.size == 1:
            return
        key = f"{self.prefix}{self.seq}"
        self.store.set(key, json.dumps(header))
        wait = min(ACK_TIMEOUT_S, self.world.timeout)
        if not _poll(self.store, f"{key}/taken", time.monotonic() + wait):
            raise RuntimeError(f"a follower rank did not take request {self.seq} within "
                               f"{wait} s; it may have exited")
        if self.seq > 1:  # every follower has read the previous request's keys
            for name in ("", "/n", "/taken"):
                self.store.delete_key(f"{self.prefix}{self.seq - 1}{name}")

    # -- the followers ----------------------------------------------------
    def follow(self) -> int:
        """Every rank but 0: take rank 0's request headers in order and run
        each request's part of the work, until the stop header; returns the
        requests run.  Raises if the store goes away (rank 0 has exited)."""
        if self.world.rank == 0:
            raise RuntimeError("rank 0 answers requests; the other ranks follow")
        runs = 0
        while True:
            self.seq += 1
            key = f"{self.prefix}{self.seq}"
            _poll(self.store, key)
            header = json.loads(self.store.get(key))
            if self.store.add(f"{key}/n", 1) == self.world.size - 1:
                self.store.set(f"{key}/taken", "1")
            if header["op"] == "stop":
                return runs
            if header["op"] == "topk":
                self._topk(None, **header)
            elif header["op"] == "score":
                self._score(None, None, **header)
            else:
                raise ValueError(f"unknown request {header['op']!r}")
            runs += 1

    # -- every rank -------------------------------------------------------
    def _ids(self, ids: Optional[torch.Tensor], count: int) -> torch.Tensor:
        """Rank 0's ``ids`` (int64) on every rank's device."""
        dev = self.world.device
        if ids is None:
            ids = torch.empty(count, dtype=torch.int64, device=dev)
        return self.world.broadcast(ids.to(dev))

    def _owned(self, ids: torch.Tensor) -> torch.Tensor:
        return (ids >= self.row0) & (ids < self.row0 + self.h.shape[0])

    def _rows(self, local: torch.Tensor) -> torch.Tensor:
        """This rank's rows ``local`` as fp32: the values (dequantized), or
        for a quantized table their codes and, last, their scales."""
        if isinstance(self.h, QuantTable):
            return torch.cat([codes_rows(self.h, local).float(),
                              self.h.scale.index_select(0, local)[:, None]], dim=1)
        return self.h.index_select(0, local).float()

    def _table(self, payload: torch.Tensor):
        """Rows from :meth:`_rows` as a table of the state's kind."""
        if isinstance(self.h, QuantTable):
            return QuantTable(q=payload[:, :-1].to(torch.int8).contiguous(),
                              scale=payload[:, -1].contiguous(), bits=8)
        return payload.to(self.h.dtype)

    def _topk(self, qi, k: int, n: int, **_) -> Tuple[np.ndarray, np.ndarray]:
        # (imported here: parallel.eval imports the engine, and so this package)
        from llp_tpu_torch.parallel.eval import sharded_topk_partners

        qi = self._ids(qi, n)
        mine = self._owned(qi)
        width = self.h.shape[1] + isinstance(self.h, QuantTable)
        payload = torch.zeros((n, width), dtype=torch.float32, device=qi.device)
        payload[mine] = self._rows(qi[mine] - self.row0)
        q = self._table(self.world.all_reduce(payload))  # one owner per row
        kw = {}
        if isinstance(q, QuantTable):
            kw = dict(q_codes=q.q, q_scale=q.scale)
            q = dequantize_rows(q, torch.arange(n, device=qi.device))
        vals, ids = sharded_topk_partners(
            self.predictor, self.h, self.row0, self.num_nodes, qi, q, k=k, world=self.world,
            block=self.block, compute_dtype=self.compute_dtype, mlp_fused=self.fused, **kw)
        return vals.cpu().numpy(), ids.cpu().numpy()

    def _score(self, ids, inv, n: int, u: int = 0, **_) -> Optional[np.ndarray]:
        ids = self._ids(ids, u)
        starts = torch.tensor(self.bounds[1:-1], dtype=torch.int64, device=ids.device)
        per_rank = torch.searchsorted(ids, starts).diff(
            prepend=ids.new_zeros(1), append=ids.new_full((1,), u)).tolist()
        mine = self._owned(ids)
        rows = self._rows(ids[mine] - self.row0)
        send = [0] * self.world.size
        send[0] = rows.shape[0]
        recv = per_rank if self.world.rank == 0 else [0] * self.world.size
        got = self.world.all_to_all(rows, send, recv)
        if self.world.rank != 0:
            return None
        table = self._table(got)
        inv = inv.to(ids.device)
        return score_pairs(self.predictor, table, inv[:, 0], inv[:, 1],
                           fused=self.fused).cpu().numpy()


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


def _watch(srv: ThreadingHTTPServer, state: ServingState, stop) -> None:
    """Shut ``srv`` down once ``stop`` (an event, or None) is set, or a
    second after a sharded state failed: the failed request's answer goes
    out first."""
    while stop is None or not stop.is_set():
        if getattr(state, "failed", None) is not None:
            time.sleep(1.0)
            break
        time.sleep(0.1)
    srv.shutdown()


def _stop_followers(state: ServingState) -> None:
    if isinstance(state, ShardedServingState) and state.world.rank == 0:
        try:
            state.stop()
        except Exception as e:  # noqa: BLE001 — a follower gone before the stop
            state.failed = state.failed or e


def serve_forever(state: ServingState, host: str = "127.0.0.1", port: int = 8080, *,
                  max_queue: int = MAX_QUEUE, ready_line: bool = True, stop=None) -> None:
    """Run the daemon until interrupted or until ``stop`` (an event) is set
    (the CLI's ``--port``); see :func:`run_server`."""
    srv = make_server(state, host, port, max_queue=max_queue)
    if ready_line:
        print(json.dumps({
            "serving": f"http://{host}:{srv.server_port}",
            "nodes": state.num_nodes, "dim": state.dim, "mode": state.mode,
        }), flush=True)
    run_server(srv, state, stop=stop)


def run_server(srv: ThreadingHTTPServer, state: ServingState, *, stop=None) -> None:
    """Serve ``srv`` (:func:`make_server`'s, over ``state``) until
    interrupted or until ``stop`` (an object with ``is_set()``) is set.
    Over a :class:`ShardedServingState` (rank 0's) it then stops the
    followers, and after a failure it stops serving a second after the
    failed request's answer and raises ``SystemExit`` with the failure."""
    sharded = isinstance(state, ShardedServingState)
    if stop is not None or sharded:
        threading.Thread(target=_watch, args=(srv, state, stop), daemon=True).start()
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        srv.engine.close()
        _stop_followers(state)
    if sharded and state.failed is not None:
        raise SystemExit(f"the sharded daemon stopped after a failure: {state.failed}")


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
        _stop_followers(self.server.engine.state)
        if self._thread is not None:
            self._thread.join(timeout=10)
