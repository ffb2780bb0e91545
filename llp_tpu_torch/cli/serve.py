"""Serving entry point: load a trained checkpoint and answer link queries
(counterpart of ``llp_tpu/cli/serve.py``, with the same flags and the same
JSON lines).

    # re-encode a GNN teacher (SAGE or GCN) over the dataset's edges, then retrieve
    python -m llp_tpu_torch.cli.serve --checkpoint saved/cora-teacher \\
        --datasets cora --reencode --topk 10 --queries 0,42,1337

    # score explicit candidate pairs with an MLP student
    python -m llp_tpu_torch.cli.serve --checkpoint saved/cora-student \\
        --datasets cora --pairs 0:5,3:77

    # the same from an int8 table, or as a daemon on port 8080
    python -m llp_tpu_torch.cli.serve --checkpoint saved/cora-teacher \
        --datasets cora --reencode --quantize int8 --topk 10 --queries 0,42
    python -m llp_tpu_torch.cli.serve --checkpoint saved/cora-teacher \
        --datasets cora --reencode --quantize int8 --port 8080 --warmup 10

Runs on the GPU unless ``--device cpu`` is given; with no card visible and
no ``--device cpu`` it exits.  Prints one JSON line per query and per pair
batch, then a summary line; with ``--port`` it prints the summary and a
ready line, then serves ``GET /healthz``, ``POST /v1/topk`` and
``POST /v1/score`` until interrupted.  The sharded table (``--shard``) is
not ported yet.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _not_ported(flag: str, item: str) -> SystemExit:
    return SystemExit(f"{flag} is not yet ported to llp_tpu_torch (ROADMAP {item})")


def main(argv=None):
    p = argparse.ArgumentParser(description="LLP link-prediction serving (GPU)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="checkpoint path prefix (no .npz/.json extension)")
    p.add_argument("--datasets", type=str, default="cora")
    p.add_argument("--dataset_dir", type=str, default="./data")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda, cuda:N or cpu; cpu is the only way onto the CPU")
    p.add_argument("--topk", type=int, default=0)
    p.add_argument("--queries", type=str, default="",
                   help="comma-separated query node ids for --topk")
    p.add_argument("--pairs", type=str, default="",
                   help="comma-separated src:dst pairs to score")
    p.add_argument("--block", type=int, default=None,
                   help="retrieval block height (default: sized from the "
                        "request so one block's intermediate stays bounded)")
    p.add_argument("--approx", action="store_true",
                   help="accepted for the JAX CLI's sake; retrieval is exact")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="retrieval scoring dtype (merges stay fp32)")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8", "int4"],
                   help="store the table per-row quantized: int8 (4x less "
                        "memory than fp32) or int4 (packed nibbles, 8x)")
    p.add_argument("--reencode", action="store_true",
                   help="GNN checkpoints: re-encode over the dataset's full "
                        "edge set instead of serving the saved features")
    p.add_argument("--port", type=int, default=None,
                   help="run as a persistent HTTP/JSON daemon on this port "
                        "(0 = any free port) instead of answering one batch: "
                        "GET /healthz, POST /v1/topk {queries,k}, "
                        "POST /v1/score {pairs}")
    p.add_argument("--host", type=str, default=None,
                   help="daemon mode: the address to bind (default 127.0.0.1)")
    p.add_argument("--shard", action="store_true")
    p.add_argument("--warmup", type=int, default=None,
                   help="daemon mode: one top-K at this k and one score "
                        "before accepting traffic, so the kernels are built "
                        "and loaded")
    p.add_argument("--max_queue", type=int, default=None,
                   help="daemon mode: in-flight + waiting requests past this "
                        "bound get an orderly 503 (default 8)")
    p.add_argument("--max_queries", type=int, default=None,
                   help="daemon mode: per-request top-K query cap (default 4096)")
    p.add_argument("--max_pairs", type=int, default=None,
                   help="daemon mode: per-request pair cap (default 2^20)")
    args = p.parse_args(argv)

    if args.shard:
        raise _not_ported("--shard", "A14")
    daemon_flags = [f"--{name}" for name in ("host", "warmup", "max_queue", "max_queries",
                                             "max_pairs") if getattr(args, name) is not None]
    if daemon_flags and args.port is None:
        p.error(f"{', '.join(daemon_flags)} configure the daemon and need --port")

    from llp_tpu_torch.utils.device import setup_device, synchronize

    device = setup_device(args.device)

    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.serve import (
        encode_graph_nodes,
        encode_nodes,
        load_serving_artifacts,
        score_pairs,
        top_k_partners,
    )

    modules, feats, meta = load_serving_artifacts(args.checkpoint, device=device)
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else None

    t0 = time.perf_counter()
    is_gnn = meta.get("encoder", "mlp") != "mlp"
    if is_gnn and args.reencode:
        # Inductive serving: embed over the dataset's current edge set,
        # unweighted, as the JAX CLI does (a --use_edge_weight teacher too).
        from llp_tpu_torch.core.graph import build_graph

        ds = get_dataset(args.dataset_dir, args.datasets)
        graph = build_graph(ds.edge_index, ds.num_nodes, device=device)
        h = encode_graph_nodes(modules["encoder"], graph,
                               torch.from_numpy(ds.x).to(device))
    elif feats is not None and is_gnn:
        h = feats
    else:
        if is_gnn:
            raise SystemExit(
                "GNN checkpoint has no saved features — pass --reencode to "
                "embed over the dataset's edge set"
            )
        ds = get_dataset(args.dataset_dir, args.datasets)
        h = encode_nodes(modules["encoder"], torch.from_numpy(ds.x).to(device))
    synchronize(device)
    t_encode = time.perf_counter() - t0

    out = {"checkpoint": args.checkpoint, "nodes": int(h.shape[0]),
           "dim": int(h.shape[1]), "encode_s": round(t_encode, 4)}

    if args.port is not None:
        # Daemon mode: encode once (above), answer queries until interrupted.
        from llp_tpu_torch.serve.server import MAX_QUEUE, ServingState, serve_forever

        state = ServingState(
            modules["predictor"], h, block=args.block, approx=args.approx,
            compute_dtype=compute_dtype, quantize=args.quantize,
            max_queries=4096 if args.max_queries is None else args.max_queries,
            max_pairs=(1 << 20) if args.max_pairs is None else args.max_pairs,
        )
        # The state owns the (possibly quantized) table now: drop the fp32
        # encode output so the daemon does not keep both copies alive.
        del h, feats
        if args.warmup:
            state.warmup(args.warmup)
        print(json.dumps(out), flush=True)
        serve_forever(state, args.host or "127.0.0.1", args.port,
                      max_queue=MAX_QUEUE if args.max_queue is None else args.max_queue)
        return out

    # One-shot paths: quantize here (the daemon's state quantizes its own).
    table = h
    if args.quantize != "none":
        from llp_tpu_torch.serve.quant import quantize_table

        table = quantize_table(h, bits=int(args.quantize[3:]))

    if args.topk and args.queries:
        qi = np.array([int(s) for s in args.queries.split(",")], np.int64)
        if qi.size and (qi.min() < 0 or qi.max() >= h.shape[0]):
            raise SystemExit(
                f"--queries out of range: table has {h.shape[0]} nodes "
                f"(got min {qi.min()}, max {qi.max()})"
            )
        t0 = time.perf_counter()
        vals, ids = top_k_partners(
            modules["predictor"], table, qi, k=args.topk, block=args.block,
            approx=args.approx, compute_dtype=compute_dtype,
        )
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        dt = time.perf_counter() - t0
        out["topk_s"] = round(dt, 4)
        out["pairs_scored_per_s"] = round(len(qi) * h.shape[0] / max(dt, 1e-9))
        for r, q in enumerate(qi):
            print(json.dumps({
                "query": int(q),
                "partners": ids[r].tolist(),
                "scores": [round(float(v), 6) for v in vals[r]],
            }))

    if args.pairs:
        se = [s.split(":") for s in args.pairs.split(",")]
        src = np.array([int(a) for a, _ in se], np.int64)
        dst = np.array([int(b) for _, b in se], np.int64)
        both = np.concatenate([src, dst])
        if both.size and (both.min() < 0 or both.max() >= h.shape[0]):
            raise SystemExit(
                f"--pairs out of range: table has {h.shape[0]} nodes "
                f"(got min {both.min()}, max {both.max()})"
            )
        t0 = time.perf_counter()
        scores = score_pairs(modules["predictor"], table, src, dst).cpu().numpy()
        out["score_s"] = round(time.perf_counter() - t0, 4)
        print(json.dumps({
            "pairs": [f"{a}:{b}" for a, b in zip(src.tolist(), dst.tolist())],
            "scores": [round(float(v), 6) for v in scores],
        }))

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
