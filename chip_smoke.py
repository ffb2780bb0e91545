#!/usr/bin/env python3
"""Smoke run of ``llp_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It uses the first visible card and imports
nothing of JAX or ``llp_tpu``. The phases below either pass or raise. Any
failure exits non-zero.

1. device       -- the card's name and power limit (nvidia-smi), torch and
                   CUDA versions.
2. build        -- compiles every kernel of ``llp_tpu_torch/csrc`` (one
                   ``nvcc`` per source, all started together).
3. kernel_check -- each kernel against its plain PyTorch version on the card,
                   at stated tolerances. With more than one card visible
                   (other_card), both kernels run again on the last card
                   while card 0 stays current.
4. serve        -- the serving CLI (``llp_tpu_torch.cli.serve.main``) at full
                   width: a 2-layer GraphSAGE teacher, hidden 256, with a
                   2-layer mlp head. It runs with random weights from a seed
                   on the ``cora`` and ``collab`` stand-ins, and then an MLP
                   student runs on ``collab``. Launch counters show that the
                   kernels served. The same requests run again on the CPU
                   with the plain versions, and the results must agree.
5. kernels      -- one JSON line: each kernel's launches on the serving path,
                   its time at the collab serving shapes, the plain
                   version's time, a library call's time where one exists,
                   and the least time the card could take.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout, the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"  # checkpoints written by the serve phase
# A dataset directory that holds no files: the registry serves its seeded
# stand-ins (cora 2,708 x 1,433; collab 235,868 x 128 with 2.51M edges).
STANDINS = str(WORK / "standins")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 outside the
# tensor cores. The kernels here are fp32 and run no tensor-core instruction.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

SEGSUM_TOL = dict(rtol=1e-5, atol=1e-5)   # fp32, another summation order
SDDMM_TOL = dict(rtol=1e-5, atol=1e-6)    # as tests/test_sddmm.py
H_TOL = dict(rtol=1e-4, atol=1e-4)        # encode: two layers of cuBLAS vs CPU GEMMs
SCORE_ATOL = 1e-5


def log(phase: str, payload) -> None:
    print(f"{phase}: {json.dumps(payload) if not isinstance(payload, str) else payload}",
          flush=True)


def compare(got, ref, *, rtol: float, atol: float, what: str) -> dict:
    """Max abs error of ``got`` against ``ref``, and the largest share of its
    tolerance ``atol + rtol * |ref|`` that any element uses; raises past 1."""
    import torch

    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    got, ref = got.detach().double(), ref.detach().double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    if not got.numel():
        return {"max_abs": 0.0, "tol_used": 0.0}
    err = (got - ref).abs()
    used = float((err / (atol + rtol * ref.abs())).max())
    if used > 1.0:
        raise AssertionError(f"{what}: past rtol={rtol} atol={atol} "
                             f"(max abs {float(err.max()):.3g}, {used:.3g}x the tolerance)")
    return {"max_abs": float(err.max()), "tol_used": used}


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    info = {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    log("device", info)
    return info


def phase_build() -> None:
    from llp_tpu_torch.ops.build import build_all

    t0 = time.perf_counter()
    report = build_all()
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{name}]", line.strip())
    log("build", {"seconds": time.perf_counter() - t0,
                  "kernels": {n: {"seconds": r["seconds"], "cached": r["cached"]}
                              for n, r in report.items()}})


def _check_graph(n: int, e: int, hub_deg: int, isolated: int, seed: int):
    """A random graph whose last ``isolated`` nodes receive nothing and whose
    node 7 receives ``hub_deg`` edges."""
    import numpy as np

    from llp_tpu_torch.core.graph import build_graph

    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e + hub_deg)
    recv = np.concatenate([rng.integers(0, n - isolated, e), np.full(hub_deg, 7)])
    return build_graph(np.stack([send, recv]), n, device="cuda")


def phase_kernel_check(gen) -> dict:
    """Each kernel against its plain version on the card; returns the
    largest abs error per kernel."""
    import numpy as np
    import torch

    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops.sddmm import head_weights, sddmm_mlp_score, sddmm_mlp_score_plain
    from llp_tpu_torch.ops.segsum import segsum, segsum_plain

    worst = {"segsum": 0.0, "sddmm": 0.0}

    def segsum_case(label, graph, x):
        for reduce in ("sum", "mean"):
            scale = (1.0 / graph.in_degree.clamp(min=1).float()) if reduce == "mean" else None
            before = segsum.launches
            got = segsum(x, graph.senders, graph.in_ptr, scale)
            torch.cuda.synchronize()
            if graph.num_edges and segsum.launches != before + 1:
                raise AssertionError(f"segsum {label}: the kernel did not launch")
            err = compare(got, segsum_plain(x, graph.senders, graph.in_ptr, scale),
                          **SEGSUM_TOL, what=f"segsum {label} {reduce}")
            worst["segsum"] = max(worst["segsum"], err["max_abs"])
            log("kernel_check", {"kernel": "segsum", "case": label, "reduce": reduce,
                                 "n": graph.num_nodes, "e": graph.num_edges,
                                 "d": x.shape[1], **err, **SEGSUM_TOL})

    # Hub row of degree 12,000 and isolated receivers. The features are
    # multiples of 1/256 in [-4, 4], so every partial sum is exact in fp32
    # and the hub row's 12,000-term sum agrees in any order.
    g = _check_graph(50_000, 200_000, 12_000, 5_000, seed=0)
    for d in (8, 100, 128, 256, 1433):
        x = torch.randint(-1024, 1025, (g.num_nodes, d), generator=gen,
                          device="cuda").float() / 256
        segsum_case("hub+isolated", g, x)
    empty = build_graph(np.zeros((2, 0), np.int64), 100, device="cuda")
    segsum_case("E=0", empty, torch.randn(100, 64, generator=gen, device="cuda"))
    # The serving graphs with Gaussian features at the widths the encode runs.
    for name, widths in (("cora", (1433, 256)), ("collab", (128, 256))):
        ds = get_dataset(STANDINS, name)
        gs = build_graph(ds.edge_index, ds.num_nodes, device="cuda")
        for d in widths:
            segsum_case(name, gs, torch.randn(gs.num_nodes, d, generator=gen, device="cuda"))

    def sddmm_case(n, d, hid, b):
        head = LinkPredictor("mlp", d, hid, generator=torch.Generator().manual_seed(d + hid))
        w = [t.cuda() for t in head_weights(head.lins)]
        table = torch.randn(n, d, generator=gen, device="cuda")
        src = torch.randint(0, n, (b,), generator=gen, device="cuda")
        dst = torch.randint(0, n, (b,), generator=gen, device="cuda")
        before = sddmm_mlp_score.launches
        got = sddmm_mlp_score(table, table, src, dst, *w)
        torch.cuda.synchronize()
        if sddmm_mlp_score.launches != before + 1:
            raise AssertionError("sddmm: the kernel did not launch")
        err = compare(got, sddmm_mlp_score_plain(table, table, src, dst, *w),
                      **SDDMM_TOL, what=f"sddmm d={d} h={hid} b={b}")
        worst["sddmm"] = max(worst["sddmm"], err["max_abs"])
        log("kernel_check", {"kernel": "sddmm", "n": n, "d": d, "h": hid, "b": b,
                             **err, **SDDMM_TOL})

    for b in (1, 700, 2048, 1 << 20):
        sddmm_case(235_868, 256, 256, b)
    sddmm_case(5_000, 100, 100, 700)     # D, H not multiples of 128
    sddmm_case(5_000, 37, 70, 2048)      # ragged feature tail, fewer units than threads
    sddmm_case(5_000, 512, 128, 700)     # shared memory above 48 KB
    sddmm_case(5_000, 2048, 300, 700)    # z staged in two chunks, two groups of units
    sddmm_case(5_000, 1813, 70, 2048)    # chunked, with a ragged last chunk
    return worst


def phase_other_card() -> None:
    """With more than one card visible, both kernels on the last one while
    card 0 stays current: each launch must make its tensors' device current."""
    import numpy as np
    import torch

    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops.sddmm import head_weights, sddmm_mlp_score, sddmm_mlp_score_plain
    from llp_tpu_torch.ops.segsum import segsum, segsum_plain

    count = torch.cuda.device_count()
    if count < 2:
        log("other_card", "skipped: one card visible")
        return
    dev = torch.device("cuda", count - 1)
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    g = build_graph(rng.integers(0, 10_000, (2, 80_000)), 10_000, device=dev)
    x = torch.randn(g.num_nodes, 256, generator=gen, device=dev)
    scale = 1.0 / g.in_degree.clamp(min=1).float()
    got = segsum(x, g.senders, g.in_ptr, scale)
    seg = compare(got, segsum_plain(x, g.senders, g.in_ptr, scale), **SEGSUM_TOL,
                  what=f"segsum on {dev}")
    w = [t.to(dev) for t in head_weights(
        LinkPredictor("mlp", 256, 256, generator=torch.Generator().manual_seed(5)).lins)]
    src = torch.randint(0, g.num_nodes, (5000,), generator=gen, device=dev)
    dst = torch.randint(0, g.num_nodes, (5000,), generator=gen, device=dev)
    sd = compare(sddmm_mlp_score(x, x, src, dst, *w),
                 sddmm_mlp_score_plain(x, x, src, dst, *w), **SDDMM_TOL,
                 what=f"sddmm on {dev}")
    torch.cuda.synchronize(dev)
    if torch.cuda.current_device() != 0:
        raise AssertionError("a kernel launch left another card current")
    log("other_card", {"device": str(dev), "segsum": seg, "sddmm": sd})


def _save_model(path: Path, encoder, predictor, meta: dict) -> None:
    from llp_tpu_torch.utils.checkpoint import save_checkpoint
    from llp_tpu_torch.utils.params import to_jax

    save_checkpoint(str(path), {"params": {"encoder": to_jax(encoder),
                                           "predictor": to_jax(predictor)}}, meta)


def _teacher(path: Path, in_dim: int, dataset: str, seed: int) -> None:
    import torch

    from llp_tpu_torch.models.encoder import init_encoder
    from llp_tpu_torch.models.predictor import LinkPredictor

    g = torch.Generator().manual_seed(seed)
    enc = init_encoder("sage", in_dim, 256, 256, 2, conv="sage", generator=g)
    pred = LinkPredictor("mlp", 256, 256, 1, 2, generator=g)
    # The meta keys the JAX trainer writes with a teacher artifact, plus norm_type.
    _save_model(path, enc, pred, dict(
        encoder="sage", conv="sage", predictor="mlp", hidden_channels=256,
        num_layers=2, predictor_layers=2, dataset=dataset, setting="transductive",
        val=0.0, norm_type="none"))


def _student(path: Path, in_dim: int, dataset: str, seed: int) -> None:
    import torch

    from llp_tpu_torch.models.encoder import init_encoder
    from llp_tpu_torch.models.predictor import LinkPredictor

    g = torch.Generator().manual_seed(seed)
    enc = init_encoder("mlp", in_dim, 256, 256, 2, generator=g)
    pred = LinkPredictor("mlp", 256, 256, 1, 2, generator=g)
    _save_model(path, enc, pred, dict(
        encoder="mlp", predictor="mlp", hidden_channels=256, num_layers=2,
        predictor_layers=2, dataset=dataset, setting="transductive", val=0.0,
        norm_type="none"))


def _serve(argv) -> tuple[dict, list]:
    """Run the serving CLI; returns its summary and its JSON result lines."""
    from llp_tpu_torch.cli.serve import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = main(argv)
    lines = [json.loads(s) for s in buf.getvalue().splitlines() if s.strip()]
    summary = dict(summary, wall_s=time.perf_counter() - t0)
    return summary, lines[:-1]


def _requests(n: int, seed: int) -> tuple[str, str]:
    import numpy as np

    rng = np.random.default_rng(seed)
    queries = ",".join(str(q) for q in rng.choice(n, 16, replace=False))
    pairs = ",".join(f"{a}:{b}" for a, b in rng.integers(0, n, (1024, 2)))
    return queries, pairs


def _check_pairs(gpu_lines, cpu_lines, what) -> float:
    import numpy as np

    g = next(x for x in gpu_lines if "pairs" in x)
    c = next(x for x in cpu_lines if "pairs" in x)
    if g["pairs"] != c["pairs"]:
        raise AssertionError(f"{what}: the pair lists differ")
    err = float(np.abs(np.array(g["scores"]) - np.array(c["scores"])).max())
    if err > SCORE_ATOL or not np.isfinite(g["scores"]).all():
        raise AssertionError(f"{what}: pair scores differ by {err} > {SCORE_ATOL}")
    return err


def _check_topk(gpu_lines, cpu_lines, k, what) -> dict:
    """Scores agree within SCORE_ATOL; ids agree wherever a score is apart
    from both neighbours by more than that (the last slot's lower
    neighbour is unseen, so it is held to its score only)."""
    import numpy as np

    gq = [x for x in gpu_lines if "query" in x]
    cq = [x for x in cpu_lines if "query" in x]
    if [x["query"] for x in gq] != [x["query"] for x in cq] or not gq:
        raise AssertionError(f"{what}: the query lists differ")
    worst, compared = 0.0, 0
    for a, b in zip(gq, cq):
        sa, sb = np.array(a["scores"]), np.array(b["scores"])
        if len(sa) != k or len(sb) != k:
            raise AssertionError(f"{what}: expected {k} partners")
        worst = max(worst, float(np.abs(sa - sb).max()))
        gaps = np.abs(np.diff(sb))
        left = np.concatenate([[np.inf], gaps]) > SCORE_ATOL
        right = np.concatenate([gaps, [0.0]]) > SCORE_ATOL
        for i in np.flatnonzero(left & right):
            compared += 1
            if a["partners"][i] != b["partners"][i]:
                raise AssertionError(f"{what}: query {a['query']} slot {i}: partner "
                                     f"{a['partners'][i]} != {b['partners'][i]}")
    if worst > SCORE_ATOL:
        raise AssertionError(f"{what}: top-k scores differ by {worst} > {SCORE_ATOL}")
    return {"max_abs": worst, "ids_compared": compared}


def phase_serve() -> dict:
    """Drive the serving CLI on the card, hold it against the CPU; returns
    the kernels' launches on the serving path."""
    import torch

    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.segsum import segsum
    from llp_tpu_torch.serve import encode_graph_nodes, load_serving_artifacts

    WORK.mkdir(parents=True, exist_ok=True)
    data = STANDINS
    datasets = {"cora": (2708, 1433), "collab": (235_868, 128)}
    for i, (name, (_, d)) in enumerate(datasets.items()):
        _teacher(WORK / f"{name}-teacher", d, name, seed=10 + i)
    _student(WORK / "collab-student", 128, "collab", seed=20)

    runs = {}
    segsum.launches = sddmm_mlp_score.launches = 0  # the serving path starts here
    for name, (n, _) in datasets.items():
        queries, pairs = _requests(n, seed=n)
        argv = [f"--checkpoint={WORK / f'{name}-teacher'}", f"--datasets={name}",
                f"--dataset_dir={data}", "--reencode", "--topk=10",
                f"--queries={queries}", f"--pairs={pairs}"]
        s0, d0 = segsum.launches, sddmm_mlp_score.launches
        summary, lines = _serve(argv)
        if summary["nodes"] != n or summary["dim"] != 256:
            raise AssertionError(f"{name}: served a table of {summary['nodes']} x {summary['dim']}")
        if segsum.launches - s0 != 2:
            raise AssertionError(f"{name}: {segsum.launches - s0} segsum launches, expected "
                                 f"2 (one per SAGE layer)")
        if sddmm_mlp_score.launches == d0:
            raise AssertionError(f"{name}: the pairs were not scored by the sddmm kernel")
        runs[name] = (argv, lines)
        log("serve", {"dataset": name, "checkpoint": "teacher", **summary,
                      "segsum_launches": segsum.launches - s0,
                      "sddmm_launches": sddmm_mlp_score.launches - d0})
    queries, pairs = _requests(235_868, seed=1)
    student_argv = [f"--checkpoint={WORK / 'collab-student'}", "--datasets=collab",
                    f"--dataset_dir={data}", f"--pairs={pairs}"]
    d0 = sddmm_mlp_score.launches
    summary, student_lines = _serve(student_argv)
    if sddmm_mlp_score.launches == d0:
        raise AssertionError("student: the pairs were not scored by the sddmm kernel")
    log("serve", {"dataset": "collab", "checkpoint": "student", **summary,
                  "sddmm_launches": sddmm_mlp_score.launches - d0})
    launches = {"segsum": segsum.launches, "sddmm": sddmm_mlp_score.launches}

    # The same requests on the CPU, through the plain versions.
    argv, lines = runs["cora"]
    _, cpu = _serve(argv + ["--device=cpu"])
    log("serve_vs_cpu", {"dataset": "cora", "pairs_max_abs": _check_pairs(lines, cpu, "cora"),
                         "topk": _check_topk(lines, cpu, 10, "cora")})
    # collab: top-k on the CPU would score 16 x 235,868 pairs through the
    # 256-wide head (about 0.5 TFLOP), so only the encode and the pairs.
    argv, lines = runs["collab"]
    _, cpu = _serve([a for a in argv if not a.startswith(("--topk", "--queries"))]
                    + ["--device=cpu"])
    pairs_err = _check_pairs(lines, cpu, "collab")
    modules, _, _ = load_serving_artifacts(str(WORK / "collab-teacher"), device="cpu")
    ds = get_dataset(data, "collab")
    x = torch.from_numpy(ds.x)
    h_cpu = encode_graph_nodes(modules["encoder"],
                               build_graph(ds.edge_index, ds.num_nodes, device="cpu"), x)
    enc = modules["encoder"].cuda()
    h_gpu = encode_graph_nodes(enc, build_graph(ds.edge_index, ds.num_nodes, device="cuda"),
                               x.cuda())
    log("serve_vs_cpu", {"dataset": "collab", "pairs_max_abs": pairs_err,
                         "h": compare(h_gpu.cpu(), h_cpu, **H_TOL, what="collab h"), **H_TOL})
    _, cpu = _serve(student_argv + ["--device=cpu"])
    log("serve_vs_cpu", {"dataset": "collab", "checkpoint": "student",
                         "pairs_max_abs": _check_pairs(student_lines, cpu, "student")})
    return launches


def phase_kernels(gen, launches: dict, worst: dict) -> list:
    """Times at the collab serving shapes; returns the kernels line's entries."""
    import torch

    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops.sddmm import head_weights, sddmm_mlp_score, sddmm_mlp_score_plain
    from llp_tpu_torch.ops.segsum import segsum, segsum_plain
    from llp_tpu_torch.serve import score_pairs

    ds = get_dataset(STANDINS, "collab")
    g = build_graph(ds.edge_index, ds.num_nodes, device="cuda")
    n, e = g.num_nodes, g.num_edges
    scale = 1.0 / g.in_degree.clamp(min=1).float()
    # The library's counterpart: a CSR adjacency whose values carry the mean's
    # 1/deg, times the features, as one torch.sparse.mm.
    adj = torch.sparse_csr_tensor(g.in_ptr, g.senders, scale[g.receivers], (n, n))

    # One collab encode aggregates twice: the 128-wide input, then the
    # 256-wide hidden layer. The segsum entry sums those two launches.
    seg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
    for d in (128, 256):
        x = torch.randn(n, d, generator=gen, device="cuda")
        t = {"ms": time_ms(lambda: segsum(x, g.senders, g.in_ptr, scale)),
             "plain_ms": time_ms(lambda: segsum_plain(x, g.senders, g.in_ptr, scale)),
             "library_ms": time_ms(lambda: torch.sparse.mm(adj, x))}
        # x, senders, in_ptr and scale read once; out written once.
        t["bytes"] = 2 * n * d * 4 + e * 8 + (n + 1) * 8 + n * 4
        log("timing", {"kernel": "segsum", "n": n, "e": e, "d": d, **t})
        for key in seg:
            seg[key] += t[key]

    head = LinkPredictor("mlp", 256, 256, generator=torch.Generator().manual_seed(3))
    w1, b1, w2, b2 = (t.cuda() for t in head_weights(head.lins))
    table = torch.randn(n, 256, generator=gen, device="cuda")
    b, d, hid = 1 << 20, 256, 256
    src = torch.randint(0, n, (b,), generator=gen, device="cuda")
    dst = torch.randint(0, n, (b,), generator=gen, device="cuda")
    rows = int(torch.unique(torch.cat([src, dst])).numel())  # table rows the pairs touch
    sd_bytes = rows * d * 4 + 2 * b * 8 + (d * hid + 2 * hid + 1) * 4 + b * 4
    # Hadamard (D), first layer (2DH), bias and relu (2H), second layer (2H),
    # bias and sigmoid (about 4) per pair.
    sd_flops = b * (d + 2 * d * hid + 4 * hid + 4)
    sd = {"ms": time_ms(lambda: sddmm_mlp_score(table, table, src, dst, w1, b1, w2, b2)),
          "plain_ms": time_ms(lambda: sddmm_mlp_score_plain(table, table, src, dst,
                                                            w1, b1, w2, b2))}
    log("timing", {"kernel": "sddmm", "n": n, "b": b, "d": d, "h": hid,
                   "bytes": sd_bytes, "flops": sd_flops, "rows_touched": rows, **sd})
    # score_pairs through the kernel and through the unfused expression: the
    # data for the fused=None default.
    head = head.cuda()
    log("score_pairs", {"pairs": b, "table": [n, d],
                        "fused_ms": time_ms(lambda: score_pairs(head, table, src, dst,
                                                                fused=True), reps=5),
                        "unfused_ms": time_ms(lambda: score_pairs(head, table, src, dst,
                                                                  fused=False), reps=5)})

    seg_bound_ms = seg["bytes"] / HBM_BYTES_PER_S * 1e3
    sd_bytes_ms = sd_bytes / HBM_BYTES_PER_S * 1e3
    sd_flops_ms = sd_flops / FP32_FLOP_PER_S * 1e3
    return [
        {"name": "segsum", "route": "cuda", "source": "llp_tpu_torch/csrc/segsum.cu",
         "replaces": "llp_tpu/ops/pallas/segsum_kernel.py:148",
         "launches": launches["segsum"], "max_abs_err": worst["segsum"],
         "ms": seg["ms"], "plain_ms": seg["plain_ms"], "bound_ms": seg_bound_ms,
         "bound_by": "bytes", "library_ms": seg["library_ms"],
         "shapes": f"collab encode: n={n} e={e}, d=128 + d=256, mean"},
        {"name": "sddmm", "route": "cuda", "source": "llp_tpu_torch/csrc/sddmm.cu",
         "replaces": "llp_tpu/ops/pallas/sddmm_kernel.py:41",
         "launches": launches["sddmm"], "max_abs_err": worst["sddmm"],
         "ms": sd["ms"], "plain_ms": sd["plain_ms"],
         "bound_ms": max(sd_bytes_ms, sd_flops_ms),
         "bound_by": "operations" if sd_flops_ms >= sd_bytes_ms else "bytes",
         "library_ms": None,
         "library_note": "no single PyTorch call gathers, multiplies and runs the MLP head",
         "shapes": f"{b} pairs over a {n} x {d} table, H={hid}"},
    ]


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke run needs one GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "llp_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(no llp_tpu_torch/csrc)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    info = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = phase_kernel_check(gen)
    phase_other_card()
    launches = phase_serve()
    kernels = phase_kernels(gen, launches, worst)
    log("total", {"seconds": time.perf_counter() - t0})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
