"""Card probes behind readings in PERF.md that ``chip_smoke.py`` does not take.

    python llp_tpu_torch/tools/probes.py prepare
        Writes the weighted collab export ``chip_smoke.py`` trains on (under
        this checkout's ``build/chip_smoke/weighted``) for ``host``.

    python llp_tpu_torch/tools/probes.py host --root DIR [--label NAME]
        Times the checkout at DIR (default: this one) on the card: the host
        time of one wrapper call of ``segsum`` and ``sddmm_mlp_score`` at
        launch-bound shapes (the Python loop's time per call before the
        card is waited for, and the per-call time with it), where that time
        goes (cProfile, the top entries), and the collab teacher's bf16
        epochs, SAGE and weighted GCN (median of 5 after a warm-up).  To
        compare two checkouts on one host, run it for each alternately, one
        after another on the same card (a, b, b, a).

    python llp_tpu_torch/tools/probes.py w1
        The pair scorer (B3) at 2^20, 2,048, 700 and 129 pairs, D = H = 256,
        the shipped kernel (clusters of 2 blocks; held against the plain
        version) beside builds of ``csrc/sddmm.cu`` with
        ``LLP_SDDMM_CLUSTER`` = 1 and 4 (W1 shared by 1 or 4 blocks; their
        scores must equal the shipped ones bit for bit) and with
        ``LLP_SDDMM_PROBE_W1_ONCE``, which copies each stage's W1 blocks once
        and reuses them stale (wrong scores by design), at clusters of 1 and
        2: what W1's L2 reads cost; and the wrapper's time beside the
        kernel's.

    python llp_tpu_torch/tools/probes.py determinism --root DIR [--label NAME]
            [--out FILE]
        Profiles the checkout at DIR on the card: one collab SAGE teacher
        epoch at fp32 and at bf16 and one collab student epoch (full batch,
        fp32, a random teacher table and head), each after a warm-up, with
        the median of 3 timed epochs beside it.  Prints, per run, the
        kernels whose names say they add with atomics or scatter
        (``ATOMIC_NAMES``) with their device ms a step, and writes every
        kernel's device ms and launches a step to FILE (JSON).  Run it for
        the parent and the change alternately to list what a change took
        off a step.

    python llp_tpu_torch/tools/probes.py peak10m
        The 10M-node teacher of ``chip_smoke.py``'s ``scale10m`` phase, one
        bf16 step with ``gather_last`` off and on
        under PyTorch's allocator history: the bytes live at the step's
        peak above what was live before it, grouped by the line of this
        package that allocated them.  (Not under ``remat``: the history's
        Python stacks fail inside checkpoint's recompute, a SystemError
        from the interpreter.)

    python llp_tpu_torch/tools/probes.py pair_blocks [--pairs N]
        The unfused pair scorer (``ops/edge_score.py::score_edges``) at
        ogbl-citation2's shapes: a 2,927,963 × 256 fp32 table, N random
        pairs (default 8,659,600, a tenth of one negative set) and a
        3-layer 'mlp' head of width 256, without TF32, for each block
        length of ``BLOCKS`` set into ``PAIR_BLOCK``: device ms of the call
        (mean of 3 after a warm-up), ns a pair, and the peak bytes the call
        allocated above what was live before it.

    python llp_tpu_torch/tools/probes.py quant_pairs --root DIR [--label NAME]
            [--pairs N]
        ``serve/engine.py::score_pairs`` of the checkout at DIR on int8 and
        int4 tables of a 2,927,963 × 256 fp32 table (ogbl-citation2's nodes),
        N random pairs (default 2^22) and a 2-layer 'mlp' head of width 256,
        without TF32, fused and unfused: device ms of the call (mean of 3
        after a warm-up), the peak bytes it allocated above what was live
        before it, and the largest gap from the dequantized table's rows
        scored whole by the head.  Run it for the parent and the change
        alternately (a, b, b, a).

    python llp_tpu_torch/tools/probes.py walks [--nodes N ...]
        B1's two walks of a cached square CSR, by the height of the table:
        the heavy-first block order, slice-major (what ``ops/segsum.py``
        runs while a 128-byte slice fits the card's L2), and the locality
        order, row-block-major (what it runs past L2), each forced on the
        benchmark generator's graphs (``chip_smoke.py::_standin_graph``):
        the collab configuration's, and the citation2 configuration's at N
        nodes (default 500,000, 1,000,000 and 1,800,000; communities and
        pairs scaled with the nodes); and at collab's height two graphs
        with no communities, ``ba_graph(235_868, 5)`` (hubs) and 2,358,104
        uniform edges.  fp32, D = 256, forward over the
        receiver CSR (the mean) and backward over the sender CSR: device ms
        of each walk (mean of 20 after a warm-up, in turns a, b, b, a),
        the two outputs bit for bit, and the order's derivation seconds and
        ``locality_share``.

Each prints one JSON line per reading.  Nothing runs at import.
"""

from __future__ import annotations

import argparse
import cProfile
import ctypes
import io
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout this file is in


def _log(kind: str, payload: dict) -> None:
    print(f"{kind}: {json.dumps(payload)}", flush=True)


def _events_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
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


def _host_per_call(fn, calls: int) -> dict:
    """``fn``'s host time per call (the loop before the card is waited for),
    its time per call with the wait, and cProfile's top entries by own time."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(12)
    top = [ln.strip() for ln in buf.getvalue().splitlines()
           if ln.strip() and ln.strip()[0].isdigit()][:12]
    return {"calls": calls, "host_us": host / calls * 1e6, "wall_us": wall / calls * 1e6,
            "profile_top_tottime": top}


def _epochs(data: dict, encoder: str, dtype: str, epochs: int) -> dict:
    import torch

    from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher

    model = init_teacher(encoder=encoder, in_channels=data["x"].shape[1], hidden_channels=256,
                         num_layers=2, predictor_mode="mlp", dropout=0.5,
                         generator=torch.Generator().manual_seed(0)).cuda()
    trainer = TeacherTrainer(model, data["graph"], data["x"], data["pos_edges"],
                             encoder=encoder, batch_size=65536, neg_mode="uniform",
                             compute_dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer.epoch(gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        trainer.epoch(gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"encoder": encoder, "dtype": dtype, "steps": trainer.steps,
            "epoch_s": statistics.median(times), "epoch_s_all": times}


# Kernel names of PyTorch's ops that add into a tensor with atomics (also
# read by chip_smoke.py's profiles):
# index_add_ (indexFuncSmallIndex/LargeIndex), index_put_ with accumulate
# (indexing_backward_kernel), scatter_add_ and scatter_reduce_ (the
# scatter-gather kernel with a Reduce* op; with TensorAssign it is a plain
# gather or scatter), embedding's backward, and anything named atomic.
ATOMIC_NAMES = ("indexFunc", "index_put", "indexing_backward", "ReduceAdd", "ReduceMultiply",
                "ReduceMean", "ReduceMaximum", "ReduceMinimum", "atomic", "embedding_backward")


def _profile_epoch_kernels(trainer, epochs: int) -> dict:
    """A warm-up epoch, ``epochs`` timed ones (median), then one under
    ``torch.profiler``: each kernel's device ms and launches a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer.epoch(gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        trainer.epoch(gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.epoch(gen)
        torch.cuda.synchronize()
    steps = trainer.steps
    kernels = {ev.key: {"ms_per_step": ev.self_device_time_total / 1e3 / steps,
                        "launches_per_step": ev.count / steps}
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
               and not getattr(ev, "is_user_annotation", False)}
    atomic = {k: v for k, v in kernels.items() if any(a in k for a in ATOMIC_NAMES)}
    return {"steps": steps, "epoch_s": statistics.median(times), "epoch_s_all": times,
            "device_ms_per_step": sum(v["ms_per_step"] for v in kernels.values()),
            "atomic_kernels": atomic, "kernels": kernels}


def cmd_determinism(args) -> None:
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import llp_tpu_torch
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.train.loop import prepare_transductive
    from llp_tpu_torch.train.student import StudentTrainer, init_student
    from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
    from llp_tpu_torch.utils.config import StudentConfig, TeacherConfig

    if Path(llp_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {llp_tpu_torch.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    label = args.label or str(root)
    report = {}
    data = prepare_transductive(TeacherConfig(datasets="collab", dataset_dir=args.standins),
                                torch.device("cuda"))
    for dtype in ("float32", "bfloat16"):
        model = init_teacher(encoder="sage", in_channels=data["x"].shape[1],
                             hidden_channels=256, num_layers=2, predictor_mode="mlp",
                             dropout=0.5, generator=torch.Generator().manual_seed(0)).cuda()
        trainer = TeacherTrainer(model, data["graph"], data["x"], data["pos_edges"],
                                 batch_size=65536, neg_mode="uniform", compute_dtype=dtype)
        report[f"teacher {dtype}"] = _profile_epoch_kernels(trainer, args.epochs)
    del data, trainer
    cfg = StudentConfig(datasets="collab", dataset_dir=args.standins)
    data = prepare_transductive(cfg, torch.device("cuda"))
    n, d = data["x"].shape
    gen = torch.Generator().manual_seed(1)
    t_h = torch.randn(n, 256, generator=gen).cuda()
    head = LinkPredictor("mlp", 256, 256, 1, 2, generator=gen)
    model = init_student(in_channels=d, hidden_channels=256, num_layers=2,
                         predictor_mode="mlp", dropout=0.5, generator=gen).cuda()
    trainer = StudentTrainer(model, data["graph"], data["x"], t_h, head, data["pos_edges"],
                             link_batch_size=65536,
                             node_batch_size=cfg.coupled_node_batch_size(n, data["num_pos"]),
                             neg_mode=cfg.neg_mode, neg_keys=data["neg_keys"])
    report["student float32"] = _profile_epoch_kernels(trainer, args.epochs)
    for run, r in report.items():
        _log("probe_determinism", {"label": label, "run": run, "steps": r["steps"],
                                   "epoch_s": r["epoch_s"], "epoch_s_all": r["epoch_s_all"],
                                   "device_ms_per_step": r["device_ms_per_step"],
                                   "atomic_kernels": r["atomic_kernels"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"label": label, "runs": report}, indent=1))


def _peak_blocks(trace: list, top: int = 8) -> dict:
    """Replay an allocator trace: the most bytes live at once (above the
    blocks that were live before it began), and those bytes grouped by the
    innermost frame in ``llp_tpu_torch`` that allocated them."""
    live, cur, peak, at = {}, 0, 0, 0
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > peak:
                peak, at = cur, i
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
    live = {}
    for ev in trace[:at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    groups = {}
    for ev in live.values():
        frame = next((f"{f['filename'].split('llp_tpu_torch/')[-1]}:{f['line']} {f['name']}"
                      for f in ev.get("frames", []) if "llp_tpu_torch" in f["filename"]),
                     "outside the package")
        groups[frame] = groups.get(frame, 0) + ev["size"]
    ranked = sorted(groups.items(), key=lambda kv: -kv[1])[:top]
    return {"peak_bytes_over_start": peak, "by_line": dict(ranked)}


def cmd_peak10m(_args) -> None:
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke
    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher

    c = chip_smoke.SCALE10M
    data = chip_smoke._scale10m_data()
    g = build_graph(data["messages"], c["nodes"], device="cuda")
    x = torch.from_numpy(data["x"]).cuda()
    pos = torch.from_numpy(data["train"].T.copy()).cuda()
    for gather_last in (False, True):
        model = init_teacher(encoder="sage", in_channels=c["features"],
                             hidden_channels=c["hidden"], num_layers=2, predictor_mode="mlp",
                             generator=torch.Generator().manual_seed(0)).cuda()
        trainer = TeacherTrainer(model, g, x, pos, batch_size=c["batch"], lr=c["lr"],
                                 neg_mode="uniform", compute_dtype="bfloat16",
                                 gather_last=gather_last)
        gen = torch.Generator(device="cuda").manual_seed(1)
        edges = pos[:trainer.batch]
        mask = torch.ones(trainer.batch, dtype=torch.bool, device="cuda")
        trainer.step(edges, mask, trainer.negatives(gen), gen)  # Adam's state exists after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(max_entries=1_000_000, stacks="python")
        trainer.step(edges, mask, trainer.negatives(gen), gen)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        _log("probe_peak10m", {"gather_last": gather_last,
                               "bytes_at_start": start,
                               "max_memory_allocated": torch.cuda.max_memory_allocated(),
                               **_peak_blocks(snap["device_traces"][0])})
        del trainer, model


def cmd_prepare(_args) -> None:
    sys.path.insert(0, str(HERE))
    import chip_smoke

    chip_smoke.phase_weighted_data()


def cmd_host(args) -> None:
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import llp_tpu_torch
    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops.sddmm import head_weights, sddmm_mlp_score
    from llp_tpu_torch.ops.segsum import segsum
    from llp_tpu_torch.train.loop import prepare_transductive
    from llp_tpu_torch.utils.config import TeacherConfig

    if Path(llp_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {llp_tpu_torch.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    label = args.label or str(root)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # launch-bound shapes: a 2,000-node graph of 16,000 edges, D = 256, and
    # the evals' small pair batch
    n, e = 2000, 16_000
    edges = torch.randint(0, n, (2, e), generator=torch.Generator().manual_seed(0))
    g = build_graph(edges.numpy(), n, device="cuda")
    xb = torch.randn(n, 256, generator=gen, device="cuda").bfloat16()
    x = torch.randn(n, 256, generator=gen, device="cuda")
    head = LinkPredictor("mlp", 256, 256, generator=torch.Generator().manual_seed(1))
    w = [t.cuda() for t in head_weights(head.lins)]
    src = torch.randint(0, n, (700,), generator=gen, device="cuda")
    dst = torch.randint(0, n, (700,), generator=gen, device="cuda")
    for name, fn in (
            ("segsum bf16->bf16 mean", lambda: segsum(xb, g.senders, g.in_ptr, g.inv_in_degree)),
            ("segsum fp32 backward", lambda: segsum(x, g.col, g.row_ptr)),
            ("sddmm_mlp_score b=700", lambda: sddmm_mlp_score(x, x, src, dst, *w))):
        _log("probe_host", {"label": label, "call": name, **_host_per_call(fn, args.calls)})
    data = prepare_transductive(TeacherConfig(datasets="collab", dataset_dir=args.standins),
                                torch.device("cuda"))
    _log("probe_epochs", {"label": label, **_epochs(data, "sage", "bfloat16", args.epochs)})
    del data
    data = prepare_transductive(TeacherConfig(datasets="collab", dataset_dir=args.weighted,
                                              use_edge_weight=True), torch.device("cuda"))
    _log("probe_epochs", {"label": label, "weighted": True,
                          **_epochs(data, "gcn", "bfloat16", args.epochs)})


# Builds of csrc/sddmm.cu beside the shipped one (clusters of 2 blocks):
# clusters of 1 and 4, and W1 copied once a stage (wrong scores) with
# clusters of 1 and 2.
W1_VARIANTS = {"cluster1": ["-DLLP_SDDMM_CLUSTER=1"],
               "cluster4": ["-DLLP_SDDMM_CLUSTER=4"],
               "w1_once_cluster1": ["-DLLP_SDDMM_CLUSTER=1", "-DLLP_SDDMM_PROBE_W1_ONCE"],
               "w1_once": ["-DLLP_SDDMM_PROBE_W1_ONCE"]}


def cmd_w1(_args) -> None:
    sys.path.insert(0, str(HERE))
    import torch

    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.ops import build
    from llp_tpu_torch.ops.sddmm import (
        head_weights,
        sddmm_mlp_score,
        sddmm_mlp_score_plain,
        split_w1,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {name: (build.BUILD_DIR / f"sddmm-probe-{name}.so",) for name in W1_VARIANTS}
    procs = {name: (path, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, *W1_VARIANTS[name], "-o", str(path),
         str(build.CSRC / "sddmm.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for name, (path,) in procs.items()}
    fn_name, argtypes = build.SIGNATURES["sddmm"]
    kernels = {"shipped": build.load_library("sddmm")}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        kernels[name] = getattr(ctypes.CDLL(str(path)), fn_name)
        kernels[name].argtypes, kernels[name].restype = argtypes, ctypes.c_int
    _log("probe_w1_build", {"seconds": time.perf_counter() - t0})
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d, hid = 235_868, 256, 256
    table = torch.randn(n, d, generator=gen, device="cuda")
    head = LinkPredictor("mlp", d, hid, generator=torch.Generator().manual_seed(3))
    w1, b1, w2, b2 = (t.cuda() for t in head_weights(head.lins))
    ws = split_w1(w1)
    stream = torch.cuda.current_stream().cuda_stream
    for b in (1 << 20, 2048, 700, 129):
        src = torch.randint(0, n, (b,), generator=gen, device="cuda")
        dst = torch.randint(0, n, (b,), generator=gen, device="cuda")
        outs = {}

        def run(name):
            res = outs.setdefault(name, torch.empty(b, device="cuda"))
            rc = kernels[name](table.data_ptr(), table.data_ptr(), src.data_ptr(),
                               dst.data_ptr(), w1.data_ptr(), ws.data_ptr(), b1.data_ptr(),
                               w2.data_ptr(), b2.data_ptr(), res.data_ptr(), b, d, hid, 1,
                               stream)
            if rc != 0:
                raise SystemExit(f"sddmm {name} launch failed: {rc}")

        ms = {name: _events_ms(lambda name=name: run(name)) for name in kernels}
        torch.cuda.synchronize()
        ref = sddmm_mlp_score_plain(table, table, src, dst, w1, b1, w2, b2)
        err = (outs["shipped"] - ref).abs()
        tol = 1e-6 + 1e-5 * ref.abs()  # SDDMM_TOL
        _log("probe_w1", {
            "pairs": b, **{f"{k}_ms": v for k, v in ms.items()},
            "shipped_max_abs_err": float(err.max()),
            "shipped_within_tol": bool((err <= tol).all()),
            "equal_bits": {k: bool(torch.equal(outs[k], outs["shipped"]))
                           for k in ("cluster1", "cluster4")},
            "w1_l2_bytes_per_pair": {"cluster1": 2 * d * hid * 4 / 128,
                                     "shipped": 2 * d * hid * 4 / 256,
                                     "cluster4": 2 * d * hid * 4 / 512},
            "row_bytes_per_pair": 2 * d * 4,
            "wrapper_ms": _events_ms(lambda: sddmm_mlp_score(table, table, src, dst,
                                                              w1, b1, w2, b2)),
            "split_w1_ms": _events_ms(lambda: split_w1(w1))})


BLOCKS = tuple(1 << k for k in range(15, 22))


def cmd_pair_blocks(args) -> None:
    sys.path.insert(0, str(HERE))
    import torch
    from torch import nn

    from llp_tpu_torch.ops import edge_score

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, width = 2_927_963, 256
    h = torch.randn(n, width, device="cuda", generator=gen)
    src = torch.randint(0, n, (args.pairs,), device="cuda", generator=gen)
    dst = torch.randint(0, n, (args.pairs,), device="cuda", generator=gen)
    torch.manual_seed(0)
    lins = nn.ModuleList([nn.Linear(width, width), nn.Linear(width, width),
                          nn.Linear(width, 1)]).cuda()
    shipped = edge_score.PAIR_BLOCK
    with torch.no_grad():
        want = edge_score.score_edges(h, src, dst, mode="mlp", lins=lins)
        for block in BLOCKS:
            edge_score.PAIR_BLOCK = block
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = edge_score.score_edges(h, src, dst, mode="mlp", lins=lins)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = _events_ms(lambda: edge_score.score_edges(h, src, dst, mode="mlp", lins=lins),
                            reps=3, warmup=1)
            _log("pair_blocks", {"block": block, "pairs": args.pairs, "ms": ms,
                                 "ns_per_pair": ms * 1e6 / args.pairs,
                                 "peak_above_live_bytes": peak,
                                 "max_abs_diff_vs_shipped": float((got - want).abs().max()),
                                 "shipped": block == shipped})
            del got
    edge_score.PAIR_BLOCK = shipped


def cmd_quant_pairs(args) -> None:
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import llp_tpu_torch
    from llp_tpu_torch.models.predictor import LinkPredictor
    from llp_tpu_torch.serve.engine import score_pairs
    from llp_tpu_torch.serve.quant import dequantize_rows, quantize_table

    if Path(llp_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {llp_tpu_torch.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, width = 2_927_963, 256
    h = torch.randn(n, width, device="cuda", generator=gen)
    src = torch.randint(0, n, (args.pairs,), device="cuda", generator=gen)
    dst = torch.randint(0, n, (args.pairs,), device="cuda", generator=gen)
    pred = LinkPredictor("mlp", width, width, num_layers=2,
                         generator=torch.Generator().manual_seed(0)).cuda().eval()
    with torch.no_grad():
        for bits in (8, 4):
            table = quantize_table(h, bits)
            whole = dequantize_rows(table, torch.arange(n, device="cuda"))
            want = pred(whole.index_select(0, src), whole.index_select(0, dst))
            del whole
            for fused in (True, False):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                got = score_pairs(pred, table, src, dst, fused=fused)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                ms = _events_ms(lambda: score_pairs(pred, table, src, dst, fused=fused),
                                reps=3, warmup=1)
                _log("quant_pairs", {"label": args.label, "bits": bits, "fused": fused,
                                     "pairs": args.pairs, "ms": ms,
                                     "ns_per_pair": ms * 1e6 / args.pairs,
                                     "peak_above_live_bytes": peak,
                                     "max_abs_diff_vs_whole": float((got - want).abs().max()),
                                     "device": torch.cuda.get_device_name()})
                del got
            del table, want


WALK_NODES = (500_000, 1_000_000, 1_800_000)


def cmd_walks(args) -> None:
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke
    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.data.synthetic import ba_graph
    from llp_tpu_torch.ops import segsum as segsum_mod

    segsum = segsum_mod.segsum

    def walking(fn):
        """``fn`` with an L2 taken to hold nothing: every cached square CSR
        walks its locality order."""
        def run():
            kept = segsum_mod._l2_bytes
            segsum_mod._l2_bytes = lambda index: 0
            try:
                return fn()
            finally:
                segsum_mod._l2_bytes = kept
        return run

    configs = HERE / "benchmark" / "configs"
    collab = json.loads((configs / "sage-teacher-collab.json").read_text())["graph"]
    cit = json.loads((configs / "sage-teacher-citation2.json").read_text())["graph"]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def standin(spec):
        return lambda: chip_smoke._standin_graph(spec, chip_smoke.CITATION2_SEED)

    def uniform():
        n = collab["nodes"]
        send, recv = torch.randint(0, n, (2, 2_358_104), generator=gen, device="cuda")
        return chip_smoke._device_graph(send, recv, n), 0.0

    graphs = [("collab", standin(collab)),
              ("ba", lambda: (build_graph(ba_graph(235_868, 5), 235_868, device="cuda"), 0.0)),
              ("uniform", uniform)]
    for n in args.nodes:
        k = n / cit["nodes"]
        graphs.append((f"citation2@{n}", standin(dict(
            cit, nodes=n, communities=max(1, round(cit["communities"] * k)),
            **{key: max(1, round(cit[key] * k))
               for key in ("train_pairs", "valid_pairs", "test_pairs")}))))
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    for name, make in graphs:
        g, host_s = make()
        n = g.num_nodes
        x = torch.randn(n, 256, generator=gen, device="cuda")
        cases = (("forward", lambda: segsum(x, g.senders, g.in_ptr, g.inv_in_degree)),
                 ("backward", lambda: segsum(x, g.col, g.row_ptr)))
        for what, call in cases:
            before = len(segsum.locality_orders)
            walked = segsum.locality_launches
            equal = torch.equal(walking(call)(), chip_smoke._without_locality(call)())
            (rec,) = segsum.locality_orders[before:]
            if segsum.locality_launches - walked != 1:
                raise AssertionError(f"walks {name} {what}: the locality order was not walked")
            times = {"slice_major": [], "locality": []}
            for key in ("slice_major", "locality", "locality", "slice_major"):
                fn = walking(call) if key == "locality" else chip_smoke._without_locality(call)
                times[key].append(_events_ms(fn))
            slice_major, locality = (statistics.mean(times[k]) for k in times)
            _log("walks", {"graph": name, "n": n, "e": g.num_edges, "case": what, "d": 256,
                           "slice_bytes": n * segsum_mod.SLICE_BYTES, "l2_bytes": l2,
                           "ms_slice_major": slice_major, "ms_locality": locality,
                           "locality_over_slice_major": locality / slice_major,
                           "runs": times, "bit_equal": equal, "order": rec,
                           "host_generator_s": host_s,
                           "device": torch.cuda.get_device_name()})
            if not equal:
                raise AssertionError(f"walks {name} {what}: the two walks' sums differ")
        del g, x


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("prepare")
    h = sub.add_parser("host")
    h.add_argument("--root", default=str(HERE))
    h.add_argument("--label", default="")
    h.add_argument("--calls", type=int, default=2000)
    h.add_argument("--epochs", type=int, default=5)
    h.add_argument("--standins", default=str(HERE / "build" / "chip_smoke" / "standins"))
    h.add_argument("--weighted", default=str(HERE / "build" / "chip_smoke" / "weighted"))
    sub.add_parser("w1")
    det = sub.add_parser("determinism")
    det.add_argument("--root", default=str(HERE))
    det.add_argument("--label", default="")
    det.add_argument("--epochs", type=int, default=3)
    det.add_argument("--out", default="")
    det.add_argument("--standins", default=str(HERE / "build" / "chip_smoke" / "standins"))
    sub.add_parser("peak10m")
    pb = sub.add_parser("pair_blocks")
    pb.add_argument("--pairs", type=int, default=8_659_600)
    wk = sub.add_parser("walks")
    wk.add_argument("--nodes", type=int, nargs="*", default=list(WALK_NODES))
    qp = sub.add_parser("quant_pairs")
    qp.add_argument("--root", default=str(HERE))
    qp.add_argument("--label", default="")
    qp.add_argument("--pairs", type=int, default=1 << 22)
    args = ap.parse_args(argv)
    {"prepare": cmd_prepare, "host": cmd_host, "w1": cmd_w1,
     "determinism": cmd_determinism, "peak10m": cmd_peak10m,
     "pair_blocks": cmd_pair_blocks, "walks": cmd_walks,
     "quant_pairs": cmd_quant_pairs}[args.cmd](args)


if __name__ == "__main__":
    main()
